"""Soft-voting ensemble across per-modality models.

Port of ``multimodal_alzheimer_tpu/utils/majority_voting.py`` (reference:
pkg/utils/outdated/majority_voting.py:76-295): average the per-model
softmax probability vectors, optionally weighting each model by its
validation macro-F1, and argmax the blend, on the logits' device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def soft_vote(logits_per_model: Sequence[torch.Tensor],
              weights: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Blend model outputs: (M x (N, C) logits) -> (N,) predictions.

    ``weights`` (e.g. per-modality val F1 scores, majority_voting.py:55-57)
    scales each model's probability vector before averaging; None means
    unweighted. A tie takes the first class, as ``jnp.argmax`` does.
    """
    probs = torch.stack([torch.softmax(torch.as_tensor(l), dim=-1)
                         for l in logits_per_model])  # (M, N, C)
    if weights is not None:
        w = torch.as_tensor(weights, dtype=probs.dtype,
                            device=probs.device).reshape(-1, 1, 1)
        probs = probs * (w / torch.sum(w))
    return torch.argmax(torch.mean(probs, dim=0), dim=-1)
