"""Serve core (``inference/quantize.py``, the int8 graph): analytic forward
convolution operations a scan times the scans a second of the run, over
one H100's 1,979 TOP/s of int8, in %."""

from benchmark.lib import readers, yardstick


def read(ctx):
    rate = ctx.get("scans_per_s")
    if not rate:
        return None
    ops = yardstick.forward_flops(readers.backbone_convs(ctx))
    return 100.0 * ops * rate / yardstick.INT8_OP_PER_S
