"""Dynamic-batching serving front end.

Port of ``multimodal_alzheimer_tpu/inference/server.py``. Concurrent clients
submit single samples and a collator thread assembles them into batches for
the ``Predictor``, so the card runs a few fixed batch shapes while clients
keep a one-sample-in, one-result-out future API.

Semantics:

* FIFO: requests are batched in arrival order.
* A batch launches when ``predictor.batch_size`` requests are waiting or
  the oldest waiting request has aged ``max_wait_s``.
* Latency tiering: with a Predictor ``ladder`` (e.g. ``(8,)`` under
  ``batch_size=32``) a deadline batch of k requests runs the smallest rung
  >= k. Call ``predictor.warmup(example, parts=True)`` before serving so no
  live request pays a first-call cost. ``batch_histogram`` records the
  dispatched batch sizes.
* Results are exactly the single-sample computation: the Predictor pads
  ragged batches and strips the padding rows before returning.
* A device or model failure is delivered to every future of the affected
  batch; the server keeps serving later batches.
* Submissions are validated against the shape and dtype of the first
  accepted sample, so one malformed request fails at ``submit`` instead of
  failing a whole batch.

The server talks to its predictor only through ``batch_size``,
``stage_sample`` (called at submit time, so the host-to-device copy
overlaps the batching window) and ``predict_parts``; every staged sample is
``release()``-d once its request is served, failed, cancelled or rejected.
A predictor over a mesh (``Predictor(mesh=...)``) is served from rank 0:
its ``predict_parts`` broadcasts each stacked batch to the other ranks,
which wait in ``predictor.follow()``, and the server's worker calls
``predictor.release_followers()`` when it stops.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np


class BatchingServer:
    def __init__(self, predictor, max_wait_s: float = 0.005,
                 name: str = "serve"):
        self.predictor = predictor
        self.max_wait_s = float(max_wait_s)
        self._q: queue.Queue = queue.Queue()
        self._spec: Optional[dict] = None  # key -> (shape, dtype)
        self._spec_lock = threading.Lock()
        # Serialises the closed check + enqueue against close()'s
        # closed flag + sentinel, so no request lands behind the sentinel.
        self._submit_lock = threading.Lock()
        self._closed = False
        self.batches_served = 0
        self.samples_served = 0
        self.batch_histogram: dict = {}  # dispatched batch size -> count
        self._worker = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._worker.start()

    # -- client side ---------------------------------------------------
    def submit(self, sample: dict) -> Future:
        """Enqueue one sample (dict of arrays WITHOUT a batch axis).

        Returns a Future resolving to ``{'logits': (C,), 'probs': (C,),
        'embeddings': {tap: (...)}}`` for this sample alone.
        """
        if self._closed:  # fail fast, before paying the staging copy
            raise RuntimeError("server is closed")
        sample = {k: np.asarray(v) for k, v in sample.items()}
        self._validate(sample)
        staged = self.predictor.stage_sample(sample)
        future: Future = Future()
        with self._submit_lock:
            if self._closed:
                staged.release()
                raise RuntimeError("server is closed")
            self._q.put((staged, future))
        return future

    def _validate(self, sample: dict) -> None:
        spec = {k: (v.shape, v.dtype) for k, v in sample.items()}
        with self._spec_lock:
            if self._spec is None:
                self._spec = spec
                return
            if set(spec) != set(self._spec):
                raise ValueError(
                    f"sample keys {sorted(spec)} != served keys "
                    f"{sorted(self._spec)}")
            for k, (shape, dtype) in spec.items():
                want_shape, want_dtype = self._spec[k]
                if shape != want_shape or dtype != want_dtype:
                    raise ValueError(
                        f"sample['{k}'] is {shape}/{dtype}, server is "
                        f"committed to {want_shape}/{want_dtype}")

    def close(self, drain: bool = True) -> None:
        """Stop accepting work; by default serve what is already queued."""
        with self._submit_lock:
            already = self._closed
            self._closed = True
            if not already:
                if not drain:
                    try:
                        while True:
                            staged, future = self._q.get_nowait()
                            staged.release()
                            if future.set_running_or_notify_cancel():
                                future.set_exception(
                                    RuntimeError("server closed"))
                    except queue.Empty:
                        pass
                self._q.put(None)  # sentinel wakes the worker
        self._worker.join()
        # A closed server holds no queue: drop the shape/dtype commitment.
        with self._spec_lock:
            self._spec = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- server side ---------------------------------------------------
    def _loop(self) -> None:
        try:
            self._collate()
        finally:
            # a mesh predictor's other ranks wait for batches until this
            release = getattr(self.predictor, "release_followers", None)
            if release is not None:
                release()

    def _collate(self) -> None:
        batch_size = self.predictor.batch_size
        while True:
            item = self._q.get()
            if item is None:
                return
            pending = [item]
            deadline = time.monotonic() + self.max_wait_s
            while len(pending) < batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._serve(pending)
                    return
                pending.append(nxt)
            self._serve(pending)

    def _serve(self, pending: list) -> None:
        # Claim each future before computing: set_result on a future the
        # client cancelled would raise and kill the worker loop. A claimed
        # future can no longer be cancelled.
        claimed = []
        for staged, future in pending:
            if future.set_running_or_notify_cancel():
                claimed.append((staged, future))
            else:
                staged.release()
        if not claimed:
            return
        samples = [s for s, _ in claimed]
        futures = [f for _, f in claimed]
        try:
            self._serve_inner(samples, futures)
        finally:
            for staged in samples:
                staged.release()

    def _serve_inner(self, samples: list, futures: list) -> None:
        try:
            out = self.predictor.predict_parts(samples)
            # Built inside the try: an output of the wrong structure fails
            # this batch instead of killing the worker. 'embeddings' is
            # optional: exported and int8 cores may return only 'logits'
            # and 'probs'.
            results = [{
                "logits": out["logits"][i],
                "probs": out["probs"][i],
                "embeddings": {k: v[i] for k, v in
                               out.get("embeddings", {}).items()},
            } for i in range(len(futures))]
        except Exception as e:  # model/device failure: fail this batch only
            for future in futures:
                future.set_exception(e)
            return
        self.batches_served += 1
        self.samples_served += len(futures)
        k = len(futures)
        self.batch_histogram[k] = self.batch_histogram.get(k, 0) + 1
        for future, result in zip(futures, results):
            future.set_result(result)
