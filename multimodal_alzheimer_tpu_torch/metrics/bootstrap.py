"""Bootstrap confidence intervals for classification metrics.

Port of ``multimodal_alzheimer_tpu/metrics/bootstrap.py`` (reference:
base_model.py:219-239): draw an (n_draws, n) index matrix with replacement,
build every resample's confusion matrix at once, and reduce. CI is
1.96 * std with Bessel's correction (``torch.std``'s default).

``draw_indices`` is apart from the rest so that a test can hand both
packages the same index matrix: the JAX package draws with ``jax.random``
and the port with a ``torch.Generator``, which give other numbers.
"""

from __future__ import annotations

from typing import Callable

import torch

from multimodal_alzheimer_tpu_torch.metrics.classification import (
    confusion_matrix,
    predictions_from_logits,
)


def draw_indices(n: int, n_drawings: int,
                 generator: torch.Generator) -> torch.Tensor:
    """(n_drawings, n) int64 indices in [0, n), drawn with replacement."""
    return torch.randint(0, n, (n_drawings, n), generator=generator,
                         device=generator.device)


def bootstrap_from_indices(metric_fn: Callable, logits: torch.Tensor,
                           labels: torch.Tensor, n_classes: int,
                           idx: torch.Tensor):
    """(mean, 1.96 * std) of ``metric_fn(cm)`` over the resamples ``idx``."""
    preds = predictions_from_logits(logits)
    idx = idx.to(preds.device)
    values = torch.stack([
        metric_fn(confusion_matrix(preds[row], labels[row], n_classes))
        for row in idx])
    return values.mean(), 1.96 * values.std()


def bootstrap_metric(metric_fn: Callable, logits: torch.Tensor,
                     labels: torch.Tensor, n_classes: int,
                     generator: torch.Generator, n_drawings: int = 1000):
    """Bootstrap mean and 1.96*std CI of a confusion-matrix metric (e.g.
    ``f1_macro`` or ``matthews_corrcoef``), resampling with ``generator``."""
    idx = draw_indices(int(labels.shape[0]), n_drawings, generator)
    return bootstrap_from_indices(metric_fn, logits, labels, n_classes, idx)
