"""BatchNorm (``ops/hopper_bn.py``, K4-K7): Σ over the traced steps of the
least time of each BatchNorm kernel's work (each tensor moved once at 3.35
TB/s, or its float32 operations at 67 TFLOP/s) over the device time of
K4-K7, in %. Frozen towers run only K4 and K5."""

from benchmark.lib import readers, trace

PATTERNS = ("::reduce_kernel<", "::apply_kernel<", "::dx_kernel<")


def read(ctx):
    dev = readers.device_in_window(ctx)
    if not dev or not ctx.get("traced_steps"):
        return None
    seconds, launches = trace.kernel_seconds(dev, PATTERNS, readers.NOT_PORT)
    if not launches:
        return None
    kernels = (("bn_stats", "bn_apply", "bn_grad_sum", "bn_dx")
               if readers.trained_towers(ctx) else ("bn_stats", "bn_apply"))
    bound = readers.bn_step_bound_s(ctx, kernels) * ctx["traced_steps"]
    return readers.share(bound, seconds)
