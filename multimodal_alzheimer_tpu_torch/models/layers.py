"""Shared 3D building blocks (PyTorch, NCDHW).

Only what the MRI classifier needs at inference: eval BatchNorm (eps 1e-5),
``max_pool3d`` with torch's floor semantics and the JAX package's guard
against a tower too deep for its volume, ``global_avg_pool``, and the weight
initialisation from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


def batch_norm3d(features: int, device=None) -> nn.BatchNorm3d:
    return nn.BatchNorm3d(features, eps=BN_EPS, device=device)


def batch_norm1d(features: int, device=None) -> nn.BatchNorm1d:
    return nn.BatchNorm1d(features, eps=BN_EPS, device=device)


def max_pool3d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Max pool with stride = window and VALID (floor) padding, NCDHW."""
    if min(x.shape[2:5]) < window:
        # A zero-size pool output would turn the whole model NaN after GAP.
        raise ValueError(
            f"max_pool3d: spatial dims {tuple(x.shape[2:5])} smaller than "
            f"the {window}^3 window — the conv tower is too deep for this "
            f"volume size")
    return F.max_pool3d(x, window, window)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool3d(1) + Flatten: (B, C, D, H, W) -> (B, C)."""
    return x.mean(dim=(2, 3, 4))


@torch.no_grad()
def reset_parameters(module: nn.Module,
                     generator: torch.Generator | None = None) -> None:
    """Flax's default initialisation, drawn from ``generator``.

    Conv and Linear weights ~ N(0, 1/fan_in) (LeCun normal, untruncated),
    biases 0; BatchNorm scale 1, bias 0, running mean 0, running var 1.
    """
    for m in module.modules():
        if isinstance(m, (nn.Conv3d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
