"""The device trace of a traced run, and its reduction to numbers.

``Profiled`` runs ``torch.profiler`` (CPU and CUDA activity) over a short
steady stretch of the window, inside a span named ``TRACED``.
The readers below take the trace's events: device busy time as the union
of the device intervals, kernel time summed by name patterns, and the
breakdown of device operations and idle gaps that the result line carries.
"""

from __future__ import annotations

import json
import math
import os
import tempfile

TRACED = "portbench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class Profiled:
    """A traced stretch: ``start()`` and ``stop()`` inside the window, then
    ``collect()`` after it returns the Chrome trace's events (written to a
    file under ``TMPDIR``, read back and deleted)."""

    def __init__(self):
        self._prof = self._span = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        try:  # the server's and clients' threads too, where torch can
            config = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
            self._prof = profile(activities=activities,
                                 experimental_config=config)
        except (TypeError, AttributeError):
            self._prof = profile(activities=activities)
        self._prof.start()
        self._span = torch.autograd.profiler.record_function(TRACED)
        self._span.__enter__()

    def stop(self) -> None:
        self._span.__exit__(None, None, None)
        self._prof.stop()

    def collect(self) -> list:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.remove(path)


def traced_window(events) -> tuple:
    """(start, end) in microseconds of the ``TRACED`` span."""
    spans = [e for e in events if e.get("name") == TRACED
             and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise ValueError(f"{len(spans)} '{TRACED}' spans in the trace")
    return spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]


def device_events(events, window=None) -> list:
    """Device operations as (name, start, end) in microseconds, clipped to
    ``window``."""
    out = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        s, t = e["ts"], e["ts"] + e["dur"]
        if window is not None:
            s, t = max(s, window[0]), min(t, window[1])
            if t <= s:
                continue
        out.append((e["name"], s, t))
    return out


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def matches(name: str, patterns, exclude=()) -> bool:
    """Whether a kernel's name holds one of ``patterns`` (case-sensitive)
    and none of ``exclude``."""
    return (any(p in name for p in patterns)
            and not any(x in name for x in exclude))


def kernel_seconds(dev, patterns, exclude=()) -> tuple:
    """(summed seconds, launches) of the device events named by
    ``patterns``."""
    picked = [(s, t) for name, s, t in dev if matches(name, patterns,
                                                       exclude)]
    return sum(t - s for s, t in picked) / 1e6, len(picked)


def busy_idle(events) -> tuple:
    """(busy seconds, traced window seconds) of a trace."""
    window = traced_window(events)
    dev = device_events(events, window)
    return (union_us((s, t) for _, s, t in dev) / 1e6,
            (window[1] - window[0]) / 1e6)


def _gaps(dev, window) -> list:
    """The idle stretches of the device inside ``window``."""
    gaps, end = [], window[0]
    for s, t in sorted((s, t) for _, s, t in dev):
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if window[1] > end:
        gaps.append((end, window[1]))
    return gaps


def _host_labels(host, gaps) -> list:
    """What the host was doing in each gap (gaps sorted and disjoint): the
    harness span and the host operation that overlap it most, the innermost
    on a tie. One sweep over the host events sorted by start."""
    host = sorted(host, key=lambda e: e["ts"])
    labels, active, i = [], [], 0
    for g0, g1 in gaps:
        while i < len(host) and host[i]["ts"] < g1:
            active.append(host[i])
            i += 1
        active = [e for e in active if e["ts"] + e["dur"] > g0]
        best = {}
        for e in active:
            ov = min(e["ts"] + e["dur"], g1) - max(e["ts"], g0)
            if ov <= 0:
                continue
            key = "span" if e["cat"] == "user_annotation" else "op"
            score = (ov, -e["dur"])
            if key not in best or score > best[key][0]:
                best[key] = (score, e["name"])
        labels.append(f"{best.get('span', (None, '-'))[1]} / "
                      f"{best.get('op', (None, 'idle host'))[1]}")
    return labels


def breakdown(events, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps
    by what the host was doing, in seconds, over the traced window."""
    window = traced_window(events)
    dev = device_events(events, window)
    by_name = {}
    for name, s, t in dev:
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e6
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e
            and e.get("name") != TRACED]
    by_host = {}
    gaps = _gaps(dev, window)
    for gap, label in zip(gaps, _host_labels(host, gaps)):
        by_host[label] = by_host.get(label, 0.0) + (gap[1] - gap[0]) / 1e6
    return {
        "device_ops": [[n[:160], v] for n, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n[:160], v] for n, v in sorted(
            by_host.items(), key=lambda kv: -kv[1])[:top]],
    }
