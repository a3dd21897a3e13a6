"""Shared 3D building blocks (PyTorch, NCDHW).

BatchNorm as the JAX package builds it (``models/layers.py:85-96``,
``models/resnet3d.py:100-129``): eps 1e-5, flax's momentum convention
(``running = 0.9 * running + 0.1 * batch statistic``), and one of four
modules chosen by ``batch_norm``. All four keep flax's tree under torch's
names (``weight``, ``bias``, ``running_mean``, ``running_var``), so
``models/convert.py`` maps them either way, and all four normalise with the
running statistics in eval mode. In train mode they normalise with the batch
statistics and differ in how:

* ``FlaxBatchNorm`` (the default): flax's ``nn.BatchNorm``; the running
  variance tracks the biased batch variance ``E[x^2] - E[x]^2``;
* ``TorchStatsBatchNorm`` (``bn_torch_stats``): torch's own EMA, with the
  unbiased batch variance;
* ``FusedBatchNorm`` (``fused_bn="full"`` or ``True``): statistics, apply
  and backward in the Hopper kernels of ``ops/hopper_bn.py``;
* ``HybridBatchNorm`` (``fused_bn="hybrid"``): the statistics kernel, a
  plain apply, and the closed-form statistics VJP.

Also ``max_pool3d`` with torch's floor semantics and the JAX package's guard
against a tower too deep for its volume, ``global_avg_pool``, and flax's
weight initialisation from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_alzheimer_tpu_torch.ops import hopper_bn

BN_EPS = 1e-5
FLAX_MOMENTUM = 0.9  # running = 0.9 * running + 0.1 * batch statistic
# Standard deviation of a standard normal cut at +-2 (flax's lecun_normal).
_TRUNCATED_STD = 0.87962566103423978


class _BatchNorm(nn.Module):
    """Scale, bias and running statistics over axis 1 of (B, C, ...)."""

    def __init__(self, features: int, eps: float = BN_EPS, device=None):
        super().__init__()
        self.num_features = features
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=self.eps)
        return self._train_forward(x)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def _track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """flax's EMA of the batch statistics."""
        self.running_mean.copy_(FLAX_MOMENTUM * self.running_mean
                                + (1.0 - FLAX_MOMENTUM) * mean)
        self.running_var.copy_(FLAX_MOMENTUM * self.running_var
                               + (1.0 - FLAX_MOMENTUM) * var)

    def extra_repr(self) -> str:
        return f"{self.num_features}, eps={self.eps}"


class FlaxBatchNorm(_BatchNorm):
    """flax ``nn.BatchNorm``: the running variance tracks the biased batch
    variance ``max(0, E[x^2] - E[x]^2)``."""

    def _train_forward(self, x):
        y = F.batch_norm(x, None, None, self.weight, self.bias,
                         training=True, eps=self.eps)
        with torch.no_grad():
            xf = x.to(torch.float32)
            axes = [0] + list(range(2, x.ndim))
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            self._track(mean, var)
        return y


class TorchStatsBatchNorm(_BatchNorm):
    """torch's running statistics (``nn.BatchNorm*d``, momentum 0.1): the
    running variance tracks the unbiased batch variance."""

    def _train_forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=True,
                            momentum=1.0 - FLAX_MOMENTUM, eps=self.eps)


class FusedBatchNorm(_BatchNorm):
    """``pallas_bn.FusedBatchNorm``: forward and backward in the kernels."""

    def _train_forward(self, x):
        y, mean, var = hopper_bn.batch_norm_train(x, self.weight, self.bias,
                                                  self.eps)
        self._track(mean, var)
        return y


class HybridBatchNorm(_BatchNorm):
    """``pallas_bn.HybridBatchNorm``: kernel statistics, plain apply."""

    def _train_forward(self, x):
        mean, var = hopper_bn.lane_packed_stats(x)
        self._track(mean.detach(), var.detach())
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean.reshape(shape)) * mul.reshape(shape)
                + self.bias.reshape(shape))


def batch_norm(features: int, fused=False, device=None) -> _BatchNorm:
    """The BatchNorm factory: ``fused`` is False (flax), ``"full"`` or True
    (the kernels), ``"hybrid"`` or ``"torch_stats"``."""
    if fused is True or fused == "full":
        return FusedBatchNorm(features, device=device)
    if fused == "hybrid":
        return HybridBatchNorm(features, device=device)
    if fused == "torch_stats":
        return TorchStatsBatchNorm(features, device=device)
    if fused is False:
        return FlaxBatchNorm(features, device=device)
    raise ValueError(f"fused_bn must be False, True, 'full', 'hybrid' or "
                     f"'torch_stats', got {fused!r}")


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

    Conv and Linear weights: flax's ``lecun_normal``, i.e. a standard normal
    cut at +-2 and scaled by ``sqrt(1/fan_in) / 0.8796...`` (the cut
    normal's standard deviation), so the weights have variance 1/fan_in;
    biases 0. BatchNorm: scale 1, bias 0, running mean 0, running var 1.
    """
    for m in module.modules():
        if isinstance(m, (nn.Conv3d, nn.Linear)):
            std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNCATED_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, _BatchNorm):
            m.reset_parameters()
