"""Train step (``train/state.py`` make_train_step): ms a traced step that
the device sat idle inside the caller's ``mmalz.step`` spans: the step's
own host work (launches, autograd, host synchronises) not hidden behind
the device's queue."""

from benchmark.lib import spans


def read(ctx):
    return spans.caller_idle_ms(ctx, spans.STEP)
