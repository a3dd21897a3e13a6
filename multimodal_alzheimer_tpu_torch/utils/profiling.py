"""Runtime tracing/profiling (SURVEY §5: the reference installs
torch-tb-profiler but never wires it; TensorBoard scalars are its only
introspection).

Port of ``multimodal_alzheimer_tpu/utils/profiling.py``: a
``torch.profiler`` context that drops a Chrome/TensorBoard trace
(``<worker>.<ns>.pt.trace.json``, which torch-tb-profiler and Perfetto
read) under the log directory, with the card's kernels where CUDA is
present, and ``span``, the named host ranges the program marks its phases
with (the train step's and the loader's, ``mmalz.*``), which land in that
trace on the profiler's own clock beside the device's events.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _autograd_profiler


def span(name: str):
    """A context that records ``name`` as a ``user_annotation`` range in a
    running ``torch.profiler`` trace, on whichever thread enters it.

    It reads the process-wide flag that every ``torch.profiler`` profile
    sets while it records, and is a null context when none does (a
    ``record_function`` costs about 13 us a call even then). The
    thread-local ``torch._C._autograd._profiler_enabled()`` would not do:
    under ``profile_all_threads`` it reads False on every thread while each
    thread's ranges are recorded."""
    if not _autograd_profiler._is_profiler_enabled:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host (and, where CUDA is present, device) trace of the
    block into ``log_dir``; yields the ``torch.profiler.profile``. Every
    thread's ranges are recorded (``profile_all_threads``), so the trace
    holds the loader's producer thread's spans beside the caller's; a torch
    that cannot record every thread raises here rather than write a trace
    without them."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
            experimental_config=config) as prof:
        yield prof
