"""Device: 1 - (the union of device intervals) / (the traced stretch), in
%, over the traced stretch of serving."""

from benchmark.lib import trace


def read(ctx):
    if not ctx.get("trace"):
        return None
    busy, span = trace.busy_idle(ctx["trace"])
    return 100.0 * (1.0 - busy / span)
