"""Classification metrics built from confusion matrices.

Port of ``multimodal_alzheimer_tpu/metrics/classification.py``
(torchmetrics-compatible conventions):
  * confusion matrix rows = true class, columns = predicted class,
  * per-class F1 = 2TP / (2TP + FP + FN), 0 when the denominator is 0,
  * macro F1 averages over *all* classes, including absent ones,
  * multiclass MCC via the covariance form; 0 when the denominator is 0.
Every function takes and returns float32 tensors on the inputs' device.
"""

from __future__ import annotations

import torch


def predictions_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the class axis (reference: confusion_matrix.py:85)."""
    return logits.argmax(dim=-1)


def confusion_matrix(preds: torch.Tensor, labels: torch.Tensor,
                     n_classes: int,
                     weights: torch.Tensor | None = None) -> torch.Tensor:
    """(n_classes, n_classes) float32 counts; rows true, cols predicted.
    ``weights`` (same shape as preds) counts a sample that many times."""
    idx = labels.long() * n_classes + preds.long()
    if weights is None:
        weights = torch.ones(idx.shape, dtype=torch.float32,
                             device=idx.device)
    flat = torch.zeros(n_classes * n_classes, dtype=torch.float32,
                       device=idx.device)
    return flat.index_add(0, idx, weights.to(torch.float32)).reshape(
        n_classes, n_classes)


def f1_per_class(cm: torch.Tensor) -> torch.Tensor:
    tp = cm.diagonal()
    fn = cm.sum(dim=1) - tp
    fp = cm.sum(dim=0) - tp
    denom = 2.0 * tp + fp + fn
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.where(denom > 0, 2.0 * tp / safe, torch.zeros_like(denom))


def f1_macro(cm: torch.Tensor) -> torch.Tensor:
    return f1_per_class(cm).mean()


def matthews_corrcoef(cm: torch.Tensor) -> torch.Tensor:
    """Multiclass MCC (covariance form) from a confusion matrix."""
    t = cm.sum(dim=1)  # true counts per class
    p = cm.sum(dim=0)  # predicted counts per class
    c = cm.trace()
    s = cm.sum()
    cov_ytyp = c * s - torch.dot(t, p)
    cov_ypyp = s * s - torch.dot(p, p)
    cov_ytyt = s * s - torch.dot(t, t)
    denom = torch.sqrt(cov_ytyt * cov_ypyp)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.where(denom > 0, cov_ytyp / safe, torch.zeros_like(denom))


def balanced_accuracy(cm: torch.Tensor) -> torch.Tensor:
    """Mean per-class recall over the classes present."""
    support = cm.sum(dim=1)
    safe = torch.where(support > 0, support, torch.ones_like(support))
    recall = torch.where(support > 0, cm.diagonal() / safe,
                         torch.zeros_like(support))
    n_present = (support > 0).sum().clamp(min=1)
    return recall.sum() / n_present


def epoch_metrics(logits: torch.Tensor, labels: torch.Tensor,
                  n_classes: int) -> dict:
    """Macro and per-class F1, MCC, balanced accuracy and the confusion
    matrix of one epoch's outputs (reference: base_model.py:91-133)."""
    cm = confusion_matrix(predictions_from_logits(logits), labels, n_classes)
    per_class = f1_per_class(cm)
    out = {
        "f1": per_class.mean(),
        "mcc": matthews_corrcoef(cm),
        "balanced_accuracy": balanced_accuracy(cm),
        "confusion_matrix": cm,
    }
    for i in range(n_classes):
        out[f"f1_class_{i}"] = per_class[i]
    return out
