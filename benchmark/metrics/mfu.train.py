"""Train step: analytic convolution FLOPs a sample times the samples a
second of the traced run (away from its traced stretch), over one H100's
989 TFLOP/s of bf16, in %."""

from benchmark.lib import readers, yardstick


def read(ctx):
    rate = ctx.get("samples_per_s")
    if not rate:
        return None
    flops = yardstick.conv_flops_per_sample(ctx["config"], ctx["bench_dir"],
                                            readers.trained_towers(ctx))
    return 100.0 * flops * rate / yardstick.BF16_FLOP_PER_S
