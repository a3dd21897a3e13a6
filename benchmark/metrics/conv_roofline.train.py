"""Backbone convolutions (cuDNN's, through ``models/resnet3d.py`` and
``pet_cnn.py``): the traced steps' analytic convolution FLOPs at 989
TFLOP/s of bf16 over the device time of the convolution and GEMM kernels
(cuDNN's and cuBLAS's, and cuDNN's layout transposes), in %."""

from benchmark.lib import readers, trace, yardstick

WORDS = ("conv", "gemm", "xmma", "cutlass", "implicit", "winograd", "fprop",
         "dgrad", "wgrad", "cudnn", "gemv", "nchwtonhwc", "nhwctonchw")
EXCLUDE = ("at::native", "int8_conv3d")


def read(ctx):
    dev = readers.device_in_window(ctx)
    if not dev or not ctx.get("traced_steps"):
        return None
    seconds = sum(t - s for name, s, t in dev
                  if trace.matches(name.lower(), WORDS)
                  and not trace.matches(name, EXCLUDE)) / 1e6
    flops = (yardstick.conv_flops_per_sample(ctx["config"], ctx["bench_dir"],
                                             readers.trained_towers(ctx))
             * ctx["batch"] * ctx["traced_steps"])
    return readers.share(flops / yardstick.BF16_FLOP_PER_S, seconds)
