"""Preprocess in the serve (``ops/hopper_norm.py``, K1 + K2): the least
time of the traced stretch's min-max normalisations (one a batch, counted
by K2's launches, the rungs weighted as the server's histogram served them
there) over the device time of K1 and K2, in %."""

from benchmark.lib import readers, trace, yardstick

K1 = ("select_cluster_kernel", "keys_kernel", "init_targets_kernel",
      "digit_hist_kernel", "digit_pick_kernel", "neighbour_kernel",
      "finish_kernel")
K2 = ("minmax_apply_kernel",)


def read(ctx):
    dev = readers.device_in_window(ctx)
    weights = readers.rung_weights(ctx, ctx.get("traced_counters", ((0, 0, {}),
                                                                    (0, 0, {}))))
    if not dev or not weights:
        return None
    k1_s, _ = trace.kernel_seconds(dev, K1, readers.NOT_PORT)
    k2_s, batches = trace.kernel_seconds(dev, K2, readers.NOT_PORT)
    if not batches:
        return None
    per_batch = 0.0
    for rung, w in weights.items():
        b = yardstick.norm_bound_s(rung, readers.voxels(ctx))
        per_batch += w * (b["minmax_select"] + b["minmax_apply"])
    return readers.share(per_batch * batches, k1_s + k2_s)
