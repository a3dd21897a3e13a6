"""The program's own spans in a traced run: the ``mmalz.*`` ranges that the
port records through ``utils.profiling.span`` (its train step's phases on
the calling thread, its loader's on the producer thread), on the
profiler's clock beside the device's events.

The caller's thread is the one that holds the harness's ``TRACED`` span.
A program older than these spans records none of them, and a reader then
finds nothing and returns None."""

from __future__ import annotations

from benchmark.lib import trace

STEP = "mmalz.step"
LOADER_WAIT = "mmalz.loader.wait"
LOADER_COLLATE = "mmalz.loader.collate"


def caller_tid(events):
    """The thread that ran the traced steps."""
    return next(e.get("tid") for e in events if e.get("name") == trace.TRACED
                and e.get("cat") == "user_annotation")


def named(events, name: str, tid=None) -> list:
    """(start, end) in microseconds of the spans called ``name`` (on thread
    ``tid`` where given) that start inside the traced stretch."""
    lo, hi = trace.traced_window(events)
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("name") == name
                  and e.get("cat") == "user_annotation"
                  and (tid is None or e.get("tid") == tid)
                  and lo <= e["ts"] < hi)


def device_idle_us(events, intervals) -> float:
    """Microseconds of the traced stretch in which the device ran nothing
    and one of ``intervals`` (disjoint, as one thread's spans of one name
    are) was open."""
    window = trace.traced_window(events)
    gaps = trace._gaps(trace.device_events(events, window), window)
    return sum(max(0.0, min(g1, s1) - max(g0, s0))
               for g0, g1 in gaps for s0, s1 in intervals)


def mean_ms(intervals):
    """The mean length of ``intervals`` in ms, None for none."""
    if not intervals:
        return None
    return sum(t - s for s, t in intervals) / len(intervals) / 1e3


def caller_idle_ms(ctx, name: str):
    """Device-idle ms a traced step inside the caller's ``name`` spans, or
    None where the program recorded no step spans (a loader that never
    blocked reads 0)."""
    events = ctx.get("trace")
    if not events or not ctx.get("traced_steps"):
        return None
    tid = caller_tid(events)
    if not named(events, STEP, tid):
        return None
    return (device_idle_us(events, named(events, name, tid)) / 1e3
            / ctx["traced_steps"])
