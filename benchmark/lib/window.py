"""The arithmetic of a measured window: a rate is all the work over all the
time, and a percentile is taken over every request, never over chunks."""

from __future__ import annotations

import math


def rate(work: float, seconds: float) -> float:
    """Work completed in the window over the window's whole length."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, by linear
    interpolation between the closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def completed_in(events, start: float, end: float) -> list:
    """Latencies of the (submitted, resolved) pairs resolved in [start,
    end]."""
    return [done - sent for sent, done in events if start <= done <= end]


class HostUsage:
    """What the host did in the window, for standard error: this process's
    CPU seconds, its involuntary context switches (other work took its
    cores), and the load average at the start."""

    def __init__(self):
        import os
        import resource

        self._r = resource
        self.start = resource.getrusage(resource.RUSAGE_SELF)
        self.load = os.getloadavg()[0]

    def since(self, seconds: float) -> dict:
        end = self._r.getrusage(self._r.RUSAGE_SELF)
        cpu = (end.ru_utime + end.ru_stime
               - self.start.ru_utime - self.start.ru_stime)
        return {"cpu_cores": cpu / seconds,
                "preempted": end.ru_nivcsw - self.start.ru_nivcsw,
                "load_avg": self.load}
