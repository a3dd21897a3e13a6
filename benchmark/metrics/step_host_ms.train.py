"""Train step (``train/state.py`` make_train_step): mean host ms of the
caller's ``mmalz.step`` spans in the traced stretch, the time the host
takes to enqueue a step; beside the device's busy ms a step it says how
near the host is to pacing the card."""

from benchmark.lib import spans


def read(ctx):
    if not ctx.get("trace"):
        return None
    events = ctx["trace"]
    return spans.mean_ms(spans.named(events, spans.STEP,
                                     spans.caller_tid(events)))
