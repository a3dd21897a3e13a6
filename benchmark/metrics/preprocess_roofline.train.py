"""Preprocess (``ops/hopper_norm.py``): the per-scan MRI normalisation of
the traced steps, K3 (z-score) or K1 + K2 (quantile min-max), its least
time (volume and mask read once, the output written once, at 3.35 TB/s)
over the device time of those kernels, in %."""

from benchmark.lib import readers, trace, yardstick

PATTERNS = {
    "zscore": ("zscore_kernel", "zscore_partials_kernel",
               "zscore_apply_kernel"),
    "min_max": ("select_cluster_kernel", "keys_kernel", "init_targets_kernel",
                "digit_hist_kernel", "digit_pick_kernel", "neighbour_kernel",
                "finish_kernel", "minmax_apply_kernel"),
}
BOUNDS = {"zscore": ("zscore",), "min_max": ("minmax_select", "minmax_apply")}


def read(ctx):
    dev = readers.device_in_window(ctx)
    if not dev or not ctx.get("traced_steps"):
        return None
    mode = ctx["config"]["preprocess"]["train"]["mri"]["mode"]
    seconds, launches = trace.kernel_seconds(dev, PATTERNS[mode],
                                             readers.NOT_PORT)
    if not launches:
        return None
    b = yardstick.norm_bound_s(ctx["batch"], readers.voxels(ctx))
    bound = sum(b[k] for k in BOUNDS[mode]) * ctx["traced_steps"]
    return readers.share(bound, seconds)
