"""Classification losses: weighted cross-entropy and focal loss.

Port of ``multimodal_alzheimer_tpu/losses/classification.py``:

* ``weighted_cross_entropy`` is ``torch.nn.CrossEntropyLoss(weight=w)`` with
  ``reduction='mean'``: the per-sample NLL weighted by ``w[label]`` over the
  sum of the applied weights (reference: pet_cnn.py:47-48);
* ``focal_loss`` is the reference FocalLoss (focalloss.py:20-40):
  ``-(1-p_t)^gamma * log p_t`` with ``p_t`` detached and the optional
  per-class ``alpha`` applied to ``log p_t`` after ``p_t`` is formed.

Both run in float32, as the JAX package does (the reference uses float64
logits; PARITY.md divergence 2).

Inside a ``parallel.data_parallel`` block the logits are the rank's rows of
a global batch, and each loss is the rank's share of the global one:
``sum_local(w * nll) / sum_global(w)`` (the denominator all-reduced, without
gradient), a mean divided by the global row count. The ranks' losses sum to
the single-device loss and their gradients to its gradient, which an
average of per-rank weighted means would not give when the ranks hold
different classes.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from multimodal_alzheimer_tpu_torch.parallel.mesh import split


def _gather_log_probs(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Per-sample log p(label) from raw (N, C) logits and (N,) labels."""
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return log_probs.gather(-1, labels.long()[:, None])[:, 0]


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights=None) -> torch.Tensor:
    """``sum_i w[y_i] * nll_i / sum_i w[y_i]`` (the plain mean without
    ``class_weights``)."""
    nll = -_gather_log_probs(logits, labels)
    dp = split()
    if class_weights is None:
        return nll.mean() if dp is None else nll.sum() / dp.global_rows
    w = torch.as_tensor(class_weights, dtype=nll.dtype,
                        device=nll.device)[labels.long()]
    if dp is None:
        return (w * nll).sum() / w.sum()
    return (w * nll).sum() / dp.mesh.all_reduce_(w.sum().detach())


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               gamma: float = 0.0, alpha=None,
               size_average: bool = True) -> torch.Tensor:
    """``-(1-p_t)^gamma log p_t``; a scalar ``alpha`` expands to
    ``[alpha, 1-alpha]``."""
    logpt = _gather_log_probs(logits, labels)
    pt = logpt.detach().exp()  # the reference detaches pt via .data
    if alpha is not None:
        alpha = torch.as_tensor(alpha, dtype=logpt.dtype, device=logpt.device)
        if alpha.ndim == 0:
            alpha = torch.stack([alpha, 1.0 - alpha])
        logpt = logpt * alpha[labels.long()]
    loss = -1.0 * (1.0 - pt) ** gamma * logpt
    if not size_average:
        return loss.sum()
    dp = split()
    return loss.mean() if dp is None else loss.sum() / dp.global_rows


def make_criterion(hparams: dict) -> Callable:
    """Focal loss when ``fl_gamma`` is truthy, else CE weighted by
    ``loss_class_weights`` (reference: mri_models/anat_cnn.py:81-85)."""
    fl_gamma = hparams.get("fl_gamma")
    if fl_gamma:
        gamma = float(fl_gamma)
        return lambda logits, labels: focal_loss(logits, labels, gamma=gamma)
    weights: Optional[list] = hparams.get("loss_class_weights")
    return lambda logits, labels: weighted_cross_entropy(logits, labels,
                                                         weights)
