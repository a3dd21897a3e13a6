"""Host input pipeline: threaded decode and prefetch feeding device batches.

Port of ``multimodal_alzheimer_tpu/data/pipeline.py``. A thread pool reads
samples, a producer thread collates them into batches and copies each batch
to the device once, and a bounded queue keeps ``prefetch`` batches ready.
On a CUDA device the batches are collated into pinned host buffers, which
are recycled, and copied with ``non_blocking`` on a side stream, so the
copy overlaps the training step; the consumer's stream waits for each copy
before using it. Batch order is the JAX loader's: the same shuffle from the
same seed.
"""

from __future__ import annotations

import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from multimodal_alzheimer_tpu_torch.utils.device import resolve_device


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
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int | None = None,
                 prefetch: int = 2, seed: int = 0, device="cuda"):
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
        self.device = resolve_device(device)
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

        def load(indices, bufs=None, alloc=np.empty) -> dict:
            samples = list(pool.map(self.dataset.__getitem__, indices))
            return collate_into(samples, bufs, alloc)

        def producer():
            pending: deque = deque()  # (host buffers, copy event) in flight
            try:
                for indices in self._batches_of_indices():
                    if stop.is_set():
                        break
                    if not cuda:
                        # fresh arrays: the tensors share their memory
                        out_q.put(({k: torch.from_numpy(v) for k, v
                                    in load(indices).items()}, None))
                        continue
                    while pending and len(pending) >= self.prefetch:
                        old_bufs, old_event = pending.popleft()
                        old_event.synchronize()  # copy done: reuse buffers
                        free_q.put(old_bufs)
                    bufs = free_q.get()
                    batch = load(indices, bufs, _pinned)
                    with torch.cuda.stream(copy_stream):
                        dev = {k: torch.from_numpy(v).to(self.device,
                                                         non_blocking=True)
                               for k, v in batch.items()}
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
                item = out_q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    break
                batch, event = item
                if event is not None:
                    compute = torch.cuda.current_stream(self.device)
                    compute.wait_event(event)
                    for t in batch.values():
                        t.record_stream(compute)
                yield batch
        finally:
            stop.set()
            # drain so a blocked producer put() can observe the stop flag
            try:
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass
            pool.shutdown(wait=False)
