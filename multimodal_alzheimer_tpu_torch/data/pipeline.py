"""Host input pipeline: threaded decode and prefetch feeding device batches.

Port of ``multimodal_alzheimer_tpu/data/pipeline.py``. A thread pool reads
samples, a producer thread collates them into batches and copies each batch
to the device once, and a bounded queue keeps ``prefetch`` batches ready.
On a CUDA device the batches are collated into pinned host buffers, which
are recycled, and copied with ``non_blocking`` on a side stream, so the
copy overlaps the training step; the consumer's stream waits for each copy
before using it. Batch order is the JAX loader's: the same shuffle from the
same seed.

With ``sharding=parallel.batch_sharding(mesh)`` every rank of the mesh
walks the same global batches (the same shuffle from the same seed) and
decodes only its own contiguous block of each: it yields
``parallel.BatchShard`` dicts on the mesh's device. A batch whose rows do
not split evenly over the ranks is decoded whole on every rank and yielded
as a plain dict, the layout the train step runs without collectives;
``pad_last``
zero-pads the tail to the full batch instead and adds ``sample_mask`` (1.0
for a real row), as the JAX loader does.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from multimodal_alzheimer_tpu_torch.parallel.mesh import BatchShard
from multimodal_alzheimer_tpu_torch.utils.device import resolve_device
from multimodal_alzheimer_tpu_torch.utils.profiling import span


def collate_into(samples: Sequence[dict], out: dict | None,
                 alloc: Callable = np.empty) -> dict:
    """Stack sample dicts into one numpy batch, writing into ``out``'s
    buffers where shapes match.

    ``out`` adopts full-size buffers, made by ``alloc(shape, dtype)``, on
    first use; a trailing ragged batch gets fresh arrays without evicting
    the adopted ones.
    """
    batch = {}
    for k in samples[0].keys():
        vals = [np.asarray(s[k]) for s in samples]
        shape = (len(vals),) + vals[0].shape
        dtype = vals[0].dtype
        if out is not None and k in out and out[k].shape == shape \
                and out[k].dtype == dtype:
            buf = out[k]
        else:
            buf = alloc(shape, dtype)
            if out is not None and k not in out:
                out[k] = buf
        for i, v in enumerate(vals):
            buf[i, ...] = v
        batch[k] = buf
    return batch


def _pinned(shape, dtype) -> np.ndarray:
    """A numpy view of page-locked host memory (it keeps the tensor)."""
    torch_dtype = torch.from_numpy(np.empty(0, dtype)).dtype
    return torch.empty(shape, dtype=torch_dtype, pin_memory=True).numpy()


class DataLoader:
    """Epoch iterator: shuffle, batch, threaded decode, prefetch, copy.

    Args:
      dataset: indexable with __len__.
      batch_size: per-step batch size.
      shuffle: reshuffle indices each epoch (numpy RNG, seeded).
      drop_last: drop the trailing partial batch.
      num_workers: decode threads; None (default) = min(8, cpu_count).
      prefetch: max ready batches in flight.
      seed: seed of the shuffle.
      device: where the batches go, as tensors; the card by default.
      sharding: a ``parallel.Sharding``: batch-sharded, each rank decodes
        its rows (on the mesh's device, which replaces ``device``);
        replicated, every rank decodes every row.
      pad_last: when not dropping, zero-pad the trailing batch to
        ``batch_size`` and add a float32 'sample_mask' key to every batch.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int | None = None,
                 prefetch: int = 2, seed: int = 0, device="cuda",
                 sharding=None, pad_last: bool = False):
        self.dataset = dataset
        if batch_size < 1:
            raise ValueError(
                f"batch_size must be >= 1, got {batch_size} (an empty "
                f"dataset split? len(dataset)={len(dataset)})")
        if drop_last and len(dataset) < batch_size:
            raise ValueError(
                f"drop_last=True with len(dataset)={len(dataset)} < "
                f"batch_size={batch_size} yields zero batches per epoch")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_workers is None:
            num_workers = min(8, os.cpu_count() or 1)
        self.num_workers = max(1, num_workers)
        if prefetch < 1:
            raise ValueError("prefetch must be >= 1")
        self.prefetch = prefetch
        self.sharding = sharding
        self.pad_last = pad_last
        self.device = (sharding.mesh.device if sharding is not None
                       else resolve_device(device))
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches_of_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        end = (len(idx) // self.batch_size * self.batch_size
               if self.drop_last else len(idx))
        for start in range(0, end, self.batch_size):
            yield idx[start:start + self.batch_size]

    def _plan(self, indices):
        """(the dataset rows this rank decodes, zero rows appended, the
        shard's (global rows, offset) or None for a whole batch)."""
        n = len(indices)
        rows = self.batch_size if self.pad_last else n
        pad = rows - n
        if self.sharding is None or self.sharding.is_fully_replicated or \
                rows % self.sharding.mesh.size:
            return indices, pad, None
        block = self.sharding.mesh.rows(rows)
        mine = indices[block.start:min(block.stop, n)]
        return mine, block.stop - block.start - len(mine), (rows,
                                                            block.start)

    def _mask(self, n_real: int, n_pad: int) -> np.ndarray:
        return np.concatenate([np.ones(n_real, np.float32),
                               np.zeros(n_pad, np.float32)])

    def __iter__(self) -> Iterator[dict]:
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda else None
        free_q: queue.Queue = queue.Queue()
        for _ in range(self.prefetch + 1):
            free_q.put({})
        error: list = []  # producer exception, re-raised in the consumer

        def load(indices, bufs=None, alloc=np.empty) -> tuple:
            mine, pad, shard = self._plan(indices)
            # a block of padding alone takes its shapes from the batch's
            # first sample
            with span("mmalz.loader.decode"):
                samples = list(pool.map(self.dataset.__getitem__,
                                        mine if len(mine) else indices[:1]))
            with span("mmalz.loader.collate"):
                if pad:
                    zeros = {k: np.zeros_like(np.asarray(v))
                             for k, v in samples[0].items()}
                    samples = samples[:len(mine)] + [zeros] * pad
                batch = collate_into(samples, bufs, alloc)
                if self.pad_last:
                    batch["sample_mask"] = self._mask(len(mine), pad)
            return batch, shard

        def place(batch: dict, shard) -> dict:
            return batch if shard is None else BatchShard(batch, *shard)

        def producer():
            pending: deque = deque()  # (host buffers, copy event) in flight
            try:
                for indices in self._batches_of_indices():
                    if stop.is_set():
                        break
                    if not cuda:
                        # fresh arrays: the tensors share their memory
                        batch, shard = load(indices)
                        out_q.put((place({k: torch.from_numpy(v) for k, v
                                          in batch.items()}, shard), None))
                        continue
                    with span("mmalz.loader.recycle"):
                        while pending and len(pending) >= self.prefetch:
                            old_bufs, old_event = pending.popleft()
                            old_event.synchronize()  # copy done: reuse
                            free_q.put(old_bufs)
                        bufs = free_q.get()
                    batch, shard = load(indices, bufs, _pinned)
                    with span("mmalz.loader.copy"), \
                            torch.cuda.stream(copy_stream):
                        dev = place({k: torch.from_numpy(v).to(
                            self.device, non_blocking=True)
                            for k, v in batch.items()}, shard)
                        event = torch.cuda.Event()
                        event.record(copy_stream)
                    pending.append((bufs, event))
                    out_q.put((dev, event))
            except BaseException as exc:
                # A decode failure surfaces in the training process rather
                # than cutting the epoch short; only the shutdown race of
                # an abandoned iterator is swallowed.
                if not stop.is_set():
                    error.append(exc)
            finally:
                out_q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                waiting = contextlib.nullcontext()
                try:
                    item = out_q.get_nowait()
                except queue.Empty:  # no batch ready: the step waits
                    item, waiting = None, span("mmalz.loader.wait")
                with waiting:
                    if item is None:
                        item = out_q.get()
                    if item is not sentinel and item[1] is not None:
                        batch, event = item
                        compute = torch.cuda.current_stream(self.device)
                        compute.wait_event(event)
                        for t in batch.values():
                            t.record_stream(compute)
                if item is sentinel:
                    if error:
                        raise error[0]
                    break
                yield item[0]
        finally:
            stop.set()
            # drain so a blocked producer put() can observe the stop flag
            try:
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass
            pool.shutdown(wait=False)
