"""Runtime tracing/profiling (SURVEY §5: the reference installs
torch-tb-profiler but never wires it; TensorBoard scalars are its only
introspection).

Port of ``multimodal_alzheimer_tpu/utils/profiling.py``: a
``torch.profiler`` context that drops a Chrome/TensorBoard trace
(``<worker>.<ns>.pt.trace.json``, which torch-tb-profiler and Perfetto
read) under the log directory, with the card's kernels where CUDA is
present, plus a simple step timer.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host (and, where CUDA is present, device) trace of the
    block into ``log_dir``; yields the ``torch.profiler.profile``."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


class StepTimer:
    """Rolling step-time / throughput tracker (volumes/sec)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._last = None

    def tick(self, batch_size: int) -> dict:
        now = time.perf_counter()
        out = {}
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
            if len(self.times) > self.window:
                self.times.pop(0)
            mean_dt = sum(self.times) / len(self.times)
            out = {"step_time_s": dt,
                   "volumes_per_s": batch_size / mean_dt}
        self._last = now
        return out
