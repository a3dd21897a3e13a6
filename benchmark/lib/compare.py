"""The comparison that decides ``correct``: the numbers a run compares with
the reference, each against its limit.

Train cells compare three steps. A leaf's gap is the gap between the
program's and the reference's norm of that leaf, over the larger of the
leaf's reference norm and the median leaf's:
  * ``loss_gap``: the largest relative gap of a step's loss; ``loss1_gap``
    the first step's;
  * ``loss1_self_gap``: the relative gap between the program's first loss
    and the reference's weighted cross-entropy of the program's own first
    logits over the batch's labels: the loss layer alone, with none of the
    forward's rounding (a loss over other rows than the logits' reads far
    off);
  * ``logit1_gap``: the first step's largest logit gap over its largest
    reference logit; ``logit1_mean_gap`` the mean gap over the mean
    reference logit;
  * ``grad_gap``: the largest leaf gap of the first gradient as the
    optimizer takes it; ``grad_gap_median`` the median leaf's;
  * ``grad1_diff``: the largest leaf's norm of the difference of the two
    first gradients, over the same denominator; ``grad1_diff_median`` the
    median leaf's. Before any update both sides hold the same weights and
    inputs, so no earlier step's rounding is amplified here; unlike a
    norm, the difference sees a gradient taken over other rows, rescaled
    or of the other sign; ``head_grad1_diff`` the largest over the
    configuration's fusion heads alone (the leaves nearest the loss, whose
    gradient sees the least rounding), where it has heads;
  * ``update_gap``: the largest leaf gap of the change after three steps,
    leaving out the leaves whose reference gradient is under a thousandth
    of the median leaf's (those move under Adam by round-off alone);
    ``update_gap_median`` the median leaf's.
A cell compares the numbers its ``limits`` name.
Serve cells compare the sampled requests' answers:
  * ``logit_gap``: the largest logit gap over the largest reference logit;
  * ``prob_gap``: the largest probability gap.
"""

from __future__ import annotations

import math
import statistics

from benchmark.reference import nets


def _leaf_gaps(prog: dict, ref: dict, leaves) -> list:
    leaves = list(leaves)
    if not leaves:
        raise ValueError("no leaves to compare")
    missing = set(leaves) - set(prog)
    if missing:
        raise ValueError(f"the program holds no {sorted(missing)[:3]}")
    median = statistics.median(ref[k] for k in leaves)
    return [abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
            for k in leaves]


def _diff_gaps(prog: dict, ref: dict, ref_norms: dict) -> list:
    """Each leaf's |g_prog - g_ref| over the larger of |g_ref| and the
    median leaf's."""
    median = statistics.median(ref_norms.values())
    return [float((prog[k].float() - ref[k].float()).norm())
            / max(ref_norms[k], median, 1e-30) for k in ref]


def train_numbers(prog: dict, ref: dict) -> dict:
    """Every train number of the program's readings against the
    reference's (``reference.train.readings``' layout)."""
    if set(prog["grad"]) != set(ref["grad"]):
        raise ValueError("the program trains other leaves than the "
                         "reference")
    median = statistics.median(ref["grad"].values())
    moved = [k for k, g in ref["grad"].items() if g >= 1e-3 * median]
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    grads = _leaf_gaps(prog["grad"], ref["grad"], ref["grad"])
    updates = _leaf_gaps(prog["update"], ref["update"], moved)
    if prog["logits1"].shape == ref["logits1"].shape:
        dl = (prog["logits1"] - ref["logits1"]).abs()
        logit1 = (float(dl.max() / ref["logits1"].abs().max()),
                  float(dl.mean() / ref["logits1"].abs().mean()))
    else:  # answers for other rows than the batch's
        logit1 = (math.inf, math.inf)
    if prog["logits1"].shape[0] == ref["labels1"].shape[0]:
        own = float(nets.weighted_cross_entropy(
            prog["logits1"].float(), ref["labels1"], ref["class_weights"]))
        loss1_self = abs(prog["loss"][0] - own) / abs(own)
    else:
        loss1_self = math.inf
    grad1 = _diff_gaps(prog["grad1"], ref["grad1"], ref["grad"])
    heads = {}
    if ref.get("heads"):
        heads["head_grad1_diff"] = max(_diff_gaps(
            prog["grad1"], {k: ref["grad1"][k] for k in ref["heads"]},
            {k: ref["grad"][k] for k in ref["heads"]}))
    return {**heads, "loss_gap": max(losses), "loss1_gap": losses[0],
            "loss1_self_gap": loss1_self,
            "logit1_gap": logit1[0], "logit1_mean_gap": logit1[1],
            "grad_gap": max(grads),
            "grad_gap_median": statistics.median(grads),
            "grad1_diff": max(grad1),
            "grad1_diff_median": statistics.median(grad1),
            "update_gap": max(updates),
            "update_gap_median": statistics.median(updates)}


def serve_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {'logits': (N, C), 'probs': (N, C)} tensors of
    the same requests."""
    scale = max(float(ref["logits"].abs().max()), 1e-30)
    return {
        "logit_gap": float((prog["logits"] - ref["logits"]).abs().max())
        / scale,
        "prob_gap": float((prog["probs"] - ref["probs"]).abs().max()),
    }


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {'value', 'limit'}}) over the numbers ``limits``
    names: each at or under its limit, and finite."""
    report = {k: {"value": numbers[k], "limit": lim}
              for k, lim in limits.items()}
    ok = all(math.isfinite(r["value"]) and r["value"] <= r["limit"]
             for r in report.values())
    return ok, report
