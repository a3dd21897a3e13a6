"""What the per-layer metric readers share: the bound of the work a
configuration's step or batch does in a layer, from its shapes, and the
device time of the kernels a reader names, from the traced stretch.

A reader returns None where it finds nothing to read (no such kernel in the
trace, no traced stretch), and the harness leaves the metric out."""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

from benchmark.lib import trace, yardstick

METRICS = Path(__file__).resolve().parents[1] / "metrics"

# The port's kernels live in anonymous namespaces of its CUDA sources; the
# library's kernels of the same names live in at::native.
NOT_PORT = ("at::native", "cub::", "thrust::")


def trained_towers(ctx) -> bool:
    return (ctx["config"]["model"] == "anat_cnn"
            or ctx["regime"].get("lr_pretrained") is not None)


def device_in_window(ctx) -> list:
    events = ctx.get("trace")
    if not events:
        return []
    return trace.device_events(events, trace.traced_window(events))


def share(bound_s: float, seconds: float):
    """bound / time in %, or None with no time to divide by."""
    if seconds <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / seconds


def voxels(ctx) -> int:
    return math.prod(ctx["grid"])


def item_bytes(ctx) -> int:
    return 2 if str(ctx["dtype"]).endswith("bfloat16") else 4


def backbone_convs(ctx) -> list:
    """The convolution records of the cell's backbone at the run's grid."""
    return yardstick.backbone_convs(ctx["config"], ctx["bench_dir"],
                                    ctx["grid"])


def bn_step_bound_s(ctx, kernels) -> float:
    """Σ of K4-K7's bounds over one step's BatchNorms: one per convolution
    of each MRI tower's backbone that runs, at the step's batch."""
    towers = ctx["config"]["towers"]["mri"] if trained_towers(ctx) else 1
    total = 0.0
    for conv in backbone_convs(ctx):
        shape = (ctx["batch"], conv[2]) + tuple(conv[7])
        b = yardstick.bn_bound_s(shape, item_bytes(ctx))
        total += sum(b[k] for k in kernels)
    return towers * total


def rung_weights(ctx, counters) -> dict:
    """rung -> share of the batches served between two counter readings
    (batches_served, samples_served, histogram of real sizes)."""
    (_, _, h0), (_, _, h1) = counters
    ladder = sorted(set(ctx["ladder"]) | {ctx["batch"]})
    counts = {}
    for size, n in h1.items():
        k = n - h0.get(size, 0)
        if k > 0:
            rung = next(r for r in ladder if size <= r)
            counts[rung] = counts.get(rung, 0) + k
    total = sum(counts.values())
    return {r: c / total for r, c in counts.items()} if total else {}


def same_as(metric: str):
    """The ``read`` of the reader ``metrics/<metric>.py``: a metric split
    by the end-to-end metric it moves reads the same quantity."""
    path = METRICS / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"_portbench_same_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
