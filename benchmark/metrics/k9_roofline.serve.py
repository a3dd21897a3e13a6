"""int8 convolution (``ops/int8_conv.py``, K9): the least time of K9's
launches in the traced stretch (one launch a convolution of the backbone,
each launch the forward's bound at its rung over the number of
convolutions, the rungs weighted as the server's histogram served them
there) over their device time, in %."""

from benchmark.lib import readers, trace, yardstick

PATTERNS = ("int8_conv3d_kernel", "int8_conv3d_gathered")


def read(ctx):
    dev = readers.device_in_window(ctx)
    weights = readers.rung_weights(ctx, ctx.get("traced_counters", ((0, 0, {}),
                                                                    (0, 0, {}))))
    if not dev or not weights:
        return None
    seconds, launches = trace.kernel_seconds(dev, PATTERNS, readers.NOT_PORT)
    if not launches:
        return None
    convs = readers.backbone_convs(ctx)
    per_launch = sum(w * yardstick.k9_forward_bound_s(convs, r)
                     for r, w in weights.items()) / len(convs)
    return readers.share(per_launch * launches, seconds)
