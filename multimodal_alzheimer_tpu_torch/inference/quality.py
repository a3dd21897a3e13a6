"""Dataset-level quality of optimized serve cores.

Port of ``multimodal_alzheimer_tpu/inference/quality.py``: any set of serve
cores (the float model, BN-folded, int8) runs over one labeled eval set, and
each gets F1 / MCC / balanced accuracy, its confusion matrix, and deltas and
prediction agreement against a baseline core (the reference's test protocol,
pkg/models/base_model.py:135-239, on serving graphs it never had).

Serve cores follow the serving contract, ``batch -> {'logits', 'probs',
...}`` on tensors (``inference/quantize.py``, ``predictor.model_serve_fn``).
Batches carry raw inputs and ``'label'``; the label is stripped before the
core sees a batch. The bootstrap draws its (draws, n) index matrix with
``metrics/bootstrap.draw_indices`` from a seeded ``torch.Generator``: JAX's
protocol with other draws. Cores evaluated with one seed resample the same
index matrix, so cross-core deltas are paired.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_alzheimer_tpu_torch.metrics.bootstrap import draw_indices
from multimodal_alzheimer_tpu_torch.metrics.classification import (
    balanced_accuracy,
    confusion_matrix,
    f1_per_class,
    matthews_corrcoef,
)
from multimodal_alzheimer_tpu_torch.utils.device import resolve_device


def _batches(data: dict, batch_size: int):
    n = len(data["label"])
    for i in range(0, n - n % batch_size, batch_size):
        yield {k: v[i:i + batch_size] for k, v in data.items()}


def _metrics(preds: torch.Tensor, labels: torch.Tensor, n_classes: int):
    """(confusion matrix, [macro f1, MCC, balanced accuracy]) in float32.
    The macro mean is the sum times float32(1 / C), as XLA lowers JAX's
    ``mean``, so the two packages report the same bits."""
    cm = confusion_matrix(preds, labels, n_classes)
    f1 = f1_per_class(cm).sum() * float(np.float32(1.0 / n_classes))
    return cm, torch.stack([f1, matthews_corrcoef(cm),
                            balanced_accuracy(cm)])


def _bootstrap_draws(preds, labels, n_classes: int, seed: int = 0,
                    n_drawings: int = 1000) -> np.ndarray:
    """(n_drawings, 3) float64 resamples of [f1, mcc, balanced_acc] over
    the index matrix ``draw_indices`` draws from a CPU generator seeded
    with ``seed``."""
    preds = torch.as_tensor(np.asarray(preds), dtype=torch.int64)
    labels = torch.as_tensor(np.asarray(labels), dtype=torch.int64)
    gen = torch.Generator().manual_seed(int(seed))
    idx = draw_indices(len(preds), n_drawings, gen)
    return torch.stack([_metrics(preds[row], labels[row], n_classes)[1]
                        for row in idx]).double().numpy()


def evaluate_serve(serve, data: dict, n_classes: int, batch_size: int = 32,
                   bootstrap: int = 0, bootstrap_seed: int = 0,
                   device="cuda") -> dict:
    """Run one serve core over labeled stacked arrays or tensors.

    ``data``: ``'label'`` plus the core's raw inputs; inputs not yet on
    ``device`` (the card unless the caller asks for the CPU) are copied
    there batch by batch. The tail that does not fill a batch is dropped;
    an eval set smaller than ``batch_size`` shrinks the batch to fit; an
    empty set is an error.

    Returns ``{'f1', 'mcc', 'balanced_acc', 'confusion', 'preds',
    'pred_counts', 'probs', 'n'}`` with numpy values; ``bootstrap`` > 0 adds
    ``f1_ci`` / ``mcc_ci`` / ``balanced_acc_ci`` (1.96 std over that many
    resamples, Bessel-corrected) and the raw ``boot_draws``.
    """
    device = resolve_device(device)
    n_total = len(data["label"])
    if n_total == 0:
        raise ValueError("evaluate_serve: empty eval set (no labels)")
    batch_size = min(batch_size, n_total)
    preds, probs, labels = [], [], []
    with torch.inference_mode():
        for batch in _batches(data, batch_size):
            batch = dict(batch)
            labels.append(np.asarray(batch.pop("label")))
            out = serve({k: torch.as_tensor(v).to(device)
                         for k, v in batch.items()})
            p = out["probs"].float().cpu().numpy()
            probs.append(p)
            preds.append(p.argmax(-1))
    preds = np.concatenate(preds)
    labels = np.concatenate(labels)
    cm, values = _metrics(torch.from_numpy(preds).long(),
                          torch.from_numpy(labels).long(), n_classes)
    out = {
        "f1": float(values[0]),
        "mcc": float(values[1]),
        "balanced_acc": float(values[2]),
        "confusion": cm.numpy(),
        "preds": preds,
        "pred_counts": np.bincount(preds, minlength=n_classes).tolist(),
        "probs": np.concatenate(probs),
        "n": int(len(preds)),
    }
    if bootstrap:
        draws = _bootstrap_draws(preds, labels, n_classes, bootstrap_seed,
                                bootstrap)
        ci = 1.96 * draws.std(axis=0, ddof=1)  # torch.std's Bessel
        out.update(f1_ci=float(ci[0]), mcc_ci=float(ci[1]),
                   balanced_acc_ci=float(ci[2]), boot_draws=draws)
    return out


def compare_serve_cores(cores: dict, data: dict, n_classes: int,
                        batch_size: int = 32, baseline: str = "float",
                        bootstrap: int = 0, device="cuda") -> dict:
    """Evaluate every core on the same data, moved to ``device`` once;
    report deltas against ``baseline``.

    Each result gains ``delta_f1``, ``delta_mcc`` (negative: worse than the
    baseline), ``agreement`` (the share of samples whose argmax matches the
    baseline's) and ``max_prob_abs_err``. ``bootstrap`` > 0 adds each
    core's CIs and the paired ``delta_f1_ci`` / ``delta_mcc_ci``: every core
    resamples the same index matrix, so a delta draw compares identical
    samples.
    """
    assert baseline in cores, (baseline, sorted(cores))
    device = resolve_device(device)
    label = np.asarray(data["label"])
    data = {k: (label if k == "label" else torch.as_tensor(v).to(device))
            for k, v in data.items()}
    results = {name: evaluate_serve(serve, data, n_classes, batch_size,
                                    bootstrap=bootstrap, device=device)
               for name, serve in cores.items()}
    base = results[baseline]
    for r in results.values():
        r["delta_f1"] = r["f1"] - base["f1"]
        r["delta_mcc"] = r["mcc"] - base["mcc"]
        r["agreement"] = float((r["preds"] == base["preds"]).mean())
        r["max_prob_abs_err"] = float(
            np.abs(r["probs"] - base["probs"]).max())
        if bootstrap:
            delta = r["boot_draws"] - base["boot_draws"]  # paired draws
            ci = 1.96 * delta.std(axis=0, ddof=1)
            r["delta_f1_ci"] = float(ci[0])
            r["delta_mcc_ci"] = float(ci[1])
    return results


def format_comparison(results: dict, baseline: str = "float") -> str:
    """Human table: one row per core, confusion deltas appended. With
    bootstrap CIs, f1 and the f1 delta render as ``x±c``."""
    with_ci = any("f1_ci" in r for r in results.values())
    if with_ci:
        lines = [f"{'core':>18} {'f1±ci':>15} {'mcc':>7} {'bal_acc':>7} "
                 f"{'Δf1±ci':>16} {'Δmcc':>8} {'agree':>7} {'max|Δp|':>8}"]
    else:
        lines = [f"{'core':>18} {'f1':>7} {'mcc':>7} {'bal_acc':>7} "
                 f"{'Δf1':>8} {'Δmcc':>8} {'agree':>7} {'max|Δp|':>8}"]
    for name, r in results.items():
        if with_ci:
            lines.append(
                f"{name:>18} "
                f"{r['f1']:.4f}±{r.get('f1_ci', 0):.4f} "
                f"{r['mcc']:7.4f} {r['balanced_acc']:7.4f} "
                f"{r['delta_f1']:+.4f}±{r.get('delta_f1_ci', 0):.4f} "
                f"{r['delta_mcc']:+8.4f} {r['agreement']:7.4f} "
                f"{r['max_prob_abs_err']:8.1e}")
            continue
        lines.append(
            f"{name:>18} {r['f1']:7.4f} {r['mcc']:7.4f} "
            f"{r['balanced_acc']:7.4f} {r['delta_f1']:+8.4f} "
            f"{r['delta_mcc']:+8.4f} {r['agreement']:7.4f} "
            f"{r['max_prob_abs_err']:8.1e}")
    base_cm = results[baseline]["confusion"]
    for name, r in results.items():
        if name != baseline and not np.array_equal(r["confusion"], base_cm):
            lines.append(f"confusion delta {name} - {baseline}:\n"
                         f"{r['confusion'] - base_cm}")
    return "\n".join(lines)
