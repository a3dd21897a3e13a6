"""Front end (``inference/server.py`` BatchingServer): the samples it
served in the window over its batches times the top rung, from its own
counters ``samples_served`` and ``batches_served``, in %."""


def read(ctx):
    (b0, s0, _), (b1, s1, _) = ctx["window"]
    if b1 == b0:
        return None
    return 100.0 * (s1 - s0) / ((b1 - b0) * ctx["batch"])
