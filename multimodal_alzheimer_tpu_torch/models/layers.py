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

Compute dtype (JAX's ``dtype`` field): parameters and running statistics
stay float32, statistics are taken in float32, and each module computes as
its JAX counterpart does with ``dtype``, which is where a bfloat16 port
goes wrong quietly:

* ``FlaxBatchNorm`` (flax ``_normalize``): ``(x - mean) * (rsqrt(var + eps)
  * scale) + bias`` in float32, cast to ``dtype`` once at the end;
* ``TorchStatsBatchNorm`` (JAX ``layers.py:79-82``), ``HybridBatchNorm``
  (``pallas_bn.py:404-405``) and ``FusedBatchNorm`` in eval mode
  (``pallas_bn.py:299-301``): ``(x - mean) * mul + bias`` in ``dtype``
  arithmetic, with x, mean, ``mul = rsqrt(var + eps) * scale`` and bias
  cast to ``dtype`` first; the chain itself is evaluated in float32 and
  rounded to ``dtype`` once, as XLA evaluates an elementwise chain of
  ``dtype`` operands (it keeps the excess precision inside a fusion);
* ``FusedBatchNorm`` in train mode: the kernels read x in ``dtype`` and
  write y in it, computing in float32;
* ``Conv3d`` and ``Linear`` (flax ``nn.Conv``/``nn.Dense`` with float32
  params): input, weight and bias cast to ``dtype``, the product in it.

Data parallelism (``parallel.data_parallel``): inside the block every
BatchNorm in train mode normalises over the global batch, as GSPMD does
under JAX's mesh. ``FusedBatchNorm`` and ``HybridBatchNorm`` all-reduce the
kernels' sums (``ops/hopper_bn.py``); ``FlaxBatchNorm`` and
``TorchStatsBatchNorm``, whose ``F.batch_norm`` or mean can see only the
rank's rows, take the moments from the all-reduced sums of x and x^2 in
float32 (``parallel.all_reduce_sum``, which autograd differentiates) and
keep their own formula, rounded to ``dtype`` once. The running statistics
track the global moments on every rank. ``Dropout`` and
``traced_dropout`` draw the keep mask at the global batch shape and keep
the rank's rows, so that the ranks together draw the single-device mask.
Outside the block nothing changes.

Tensor and spatial parallelism (``parallel.tensor_parallel``, a 3-D mesh of
``parallel/tp.py``): ``Conv3d`` gathers its input channels where its kernel
is sharded on O and fetches its depth halo, ``Linear`` sums a row-split
product over the model ranks, each BatchNorm normalises its channel slice
with statistics over data x spatial (the global count with the global
depth), ``global_avg_pool`` adds the depth slabs' sums, and ``max_pool3d``
fetches its window. A layer whose parameters are whole takes its input
whole (``tp.channels``). Dropout draws the global-batch mask of the rank's
rows at its own shape, so under a model axis a channel-sharded dropout
draws other masks than one device does.

Also ``max_pool3d`` with torch's floor semantics and the JAX package's guard
against a tower too deep for its volume, ``global_avg_pool``, flax's
weight initialisation from an explicit ``torch.Generator``, flax's
``Dropout`` with its keep mask drawn from an explicit generator,
``traced_dropout`` / ``TracedDropout`` (the same masking with the rate given
at call time, ``layers.py:123-136``), and the small CNN's ``ConvBlock3D`` /
``ConvTower3D`` (``layers.py:361-442``).

The JAX ``ConvBlock3D`` lowers its conv, ReLU and pool through
``S2DConvReLUPool`` (and its BatchNorm through ``ParityBatchNorm``) for
narrow inputs by default (``s2d_pool=True``): a TPU lowering of the same
function. The port runs the plain conv -> BN -> ReLU -> pool, with the same
parameter tree.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_alzheimer_tpu_torch.ops import hopper_bn, narrow_conv
from multimodal_alzheimer_tpu_torch.parallel import tp as sharding
from multimodal_alzheimer_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    split,
)

BN_EPS = 1e-5
FLAX_MOMENTUM = 0.9  # running = 0.9 * running + 0.1 * batch statistic
# Standard deviation of a standard normal cut at +-2 (flax's lecun_normal).
_TRUNCATED_STD = 0.87962566103423978


_STATE = threading.local()


@contextlib.contextmanager
def no_tracking():
    """BatchNorms in train mode leave their running statistics alone in
    this thread while the block runs (a rematerialised block's second
    forward)."""
    before = getattr(_STATE, "frozen", False)
    _STATE.frozen = True
    try:
        yield
    finally:
        _STATE.frozen = before


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` computing in ``compute_dtype`` (flax ``nn.Conv`` with
    ``dtype``): input, weight and bias cast to it; the parameters stay in
    their own dtype."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, depth_pad=None) -> torch.Tensor:
        """``depth_pad`` (lo, hi): zero planes before and after the depth
        axis, which a depth-sharded conv takes from its neighbours.

        On the CPU a reduced-precision conv of a map one voxel thick that
        autograd will differentiate runs in float32 on the operands rounded
        to ``compute_dtype`` and rounds its result once, as XLA's CPU
        backend runs a bfloat16 convolution: there oneDNN's own bfloat16
        conv3d backward returns NaN weight gradients at random (the strided
        ResNet's 1-voxel layer-3/4 maps at 12x14x12). Every other conv stays
        oneDNN's. Under a spatial axis every rank decides alike, from the
        map's global depth and every rank's slab of it (``_thin``): the
        ranks exchange halo planes in the dtype they compute in.

        On the card a narrow bfloat16 conv that ``ops/narrow_conv.takes``
        (the PET towers' 1 -> 8 and 8 -> 16 blocks, 5^3, "same") runs on
        K10 with its gradients, outside a spatial or channel axis; every
        other conv runs ``F.conv3d``."""
        dt = self.compute_dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        x, weight = x.to(dt), self.weight.to(dt)
        tp = sharding.active()
        upcast = (dt != torch.float32 and x.device.type == "cpu"
                  and torch.is_grad_enabled()
                  and (x.requires_grad or weight.requires_grad)
                  and _thin(x, tp))
        if upcast:
            x, weight = x.float(), weight.float()
            bias = bias.float() if bias is not None else None
        if tp is not None and tp.tp.shape[1:] != (1, 1):
            y = sharding.conv3d(self, x, weight, bias, depth_pad)
        elif depth_pad is None and narrow_conv.takes(self, x):
            return narrow_conv.conv3d(x, weight, bias, self.stride,
                                      self.padding, self.dilation,
                                      self.groups)
        else:
            if depth_pad is not None:
                x = F.pad(x, (0, 0, 0, 0) + tuple(depth_pad))
            y = self._conv_forward(x, weight, bias)
        return y.to(dt) if upcast else y


def _thin(x: torch.Tensor, tp) -> bool:
    """Whether the map x holds is one voxel thick along an axis. Under a
    spatial axis x is a depth slab: then whether the volume's global depth,
    its H or W, or any spatial rank's non-empty slab is one voxel, the same
    answer on every rank."""
    dims = list(x.shape[2:])
    if tp is not None and tp.tp.shape[2] > 1:
        depth, n = tp.global_depth(x), tp.tp.shape[2]
        slabs = (sharding.depth_slab(depth, q, n) for q in range(n))
        dims = [depth] + dims[1:] + [hi - lo for lo, hi in slabs if hi > lo]
    return min(dims) == 1


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (flax ``nn.Dense`` with
    ``dtype``)."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        tp = sharding.active()
        if tp is not None and tp.tp.shape[1] > 1:
            return sharding.linear(self, x.to(dt), self.weight.to(dt),
                                   self.bias.to(dt))
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class _BatchNorm(nn.Module):
    """Scale, bias and running statistics over axis 1 of (B, C, ...);
    ``dtype`` is the compute dtype (JAX's ``dtype`` field)."""

    def __init__(self, features: int, eps: float = BN_EPS, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.num_features = features
        self.eps = eps
        self.dtype = dtype
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
        x = self._channels(x)
        if not self.training:
            return self._affine(x, self.running_mean, self.running_var)
        return self._train_forward(x)

    def _channels(self, x: torch.Tensor) -> torch.Tensor:
        """Under a model axis, x as these parameters take it: the rank's
        channel slice where they are sharded, else whole."""
        tp = sharding.active()
        if tp is None or tp.tp.shape[1] == 1:
            return x
        mode = ("sharded" if self.weight.shape[0] != self.num_features
                else "replicated")
        return sharding.channels(x, self.num_features, mode, tp)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _affine(self, x, mean, var) -> torch.Tensor:
        """``(x - mean) * (rsqrt(var + eps) * scale) + bias`` on operands
        cast to ``dtype`` (JAX ``layers.py:79-82``), evaluated in float32
        and rounded to ``dtype`` once."""
        dt = self.dtype
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight

        def operand(t):
            return t.to(dt).to(torch.float32)

        y = ((operand(x) - operand(mean).reshape(shape))
             * operand(mul).reshape(shape) + operand(self.bias).reshape(shape))
        return y.to(dt)

    @torch.no_grad()
    def _track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """flax's EMA of the batch statistics (none under ``no_tracking``)."""
        if getattr(_STATE, "frozen", False):
            return
        self.running_mean.copy_(FLAX_MOMENTUM * self.running_mean
                                + (1.0 - FLAX_MOMENTUM) * mean)
        self.running_var.copy_(FLAX_MOMENTUM * self.running_var
                               + (1.0 - FLAX_MOMENTUM) * var)

    def extra_repr(self) -> str:
        return f"{self.num_features}, eps={self.eps}"


def _global_moments(x: torch.Tensor, dp):
    """float32 (mean, E[x^2] - mean^2) per channel over the global batch of
    which ``x`` holds the rank's rows: the sums of x and x^2 all-reduced in
    one differentiable collective."""
    xf = x.to(torch.float32)
    axes = [0] + list(range(2, x.ndim))
    sums = all_reduce_sum(torch.stack([xf.sum(axes), (xf * xf).sum(axes)]),
                          dp.stats_mesh(x))
    n = dp.stats_count(x)
    mean = sums[0] / n
    return mean, sums[1] / n - mean * mean


class FlaxBatchNorm(_BatchNorm):
    """flax ``nn.BatchNorm``: the running variance tracks the biased batch
    variance ``max(0, E[x^2] - E[x]^2)``. ``F.batch_norm`` computes in
    float32 for a bfloat16 input and rounds once, as flax's ``_normalize``
    does before its cast to ``dtype``."""

    def forward(self, x):
        x = self._channels(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=self.eps).to(self.dtype)
        return self._train_forward(x)

    def _train_forward(self, x):
        dp = split()
        if dp is not None:
            mean, var = _global_moments(x, dp)
            var = torch.clamp(var, min=0.0)
            shape = (1, -1) + (1,) * (x.ndim - 2)
            mul = torch.rsqrt(var + self.eps) * self.weight
            y = ((x.to(torch.float32) - mean.reshape(shape))
                 * mul.reshape(shape) + self.bias.reshape(shape))
            self._track(mean.detach(), var.detach())
            return y.to(self.dtype)
        y = F.batch_norm(x, None, None, self.weight, self.bias,
                         training=True, eps=self.eps).to(self.dtype)
        with torch.no_grad():
            xf = x.to(torch.float32)
            axes = [0] + list(range(2, x.ndim))
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            self._track(mean, var)
        return y


class TorchStatsBatchNorm(_BatchNorm):
    """torch's running statistics (``nn.BatchNorm*d``, momentum 0.1): the
    running variance tracks the unbiased batch variance. JAX's
    ``TorchStatsBatchNorm``: float32 batch statistics ``E[x^2] - E[x]^2``,
    the running variance Bessel-corrected, the normalisation in ``dtype``
    arithmetic."""

    def _train_forward(self, x):
        dp = split()
        if dp is not None:
            mean, var = _global_moments(x, dp)
            n = dp.stats_count(x)
        else:
            xf = x.to(torch.float32)
            axes = [0] + list(range(2, x.ndim))
            mean = xf.mean(axes)
            var = (xf * xf).mean(axes) - mean * mean
            n = x.numel() // x.shape[1]
        self._track(mean.detach(), var.detach() * (n / max(n - 1, 1)))
        return self._affine(x, mean, var)


class FusedBatchNorm(_BatchNorm):
    """``pallas_bn.FusedBatchNorm``: forward and backward in the kernels,
    which read and write ``dtype``."""

    def _train_forward(self, x):
        y, mean, var = hopper_bn.batch_norm_train(x.to(self.dtype),
                                                  self.weight, self.bias,
                                                  self.eps)
        self._track(mean, var)
        return y


class HybridBatchNorm(_BatchNorm):
    """``pallas_bn.HybridBatchNorm``: kernel statistics, plain apply."""

    def _train_forward(self, x):
        x = x.to(self.dtype)
        mean, var = hopper_bn.lane_packed_stats(x)
        self._track(mean.detach(), var.detach())
        return self._affine(x, mean, var)


def batch_norm(features: int, fused=False, device=None,
               dtype=torch.float32) -> _BatchNorm:
    """The BatchNorm factory: ``fused`` is False (flax), ``"full"`` or True
    (the kernels), ``"hybrid"`` or ``"torch_stats"``; ``dtype`` is the
    compute dtype."""
    kwargs = dict(device=device, dtype=dtype)
    if fused is True or fused == "full":
        return FusedBatchNorm(features, **kwargs)
    if fused == "hybrid":
        return HybridBatchNorm(features, **kwargs)
    if fused == "torch_stats":
        return TorchStatsBatchNorm(features, **kwargs)
    if fused is False:
        return FlaxBatchNorm(features, **kwargs)
    raise ValueError(f"fused_bn must be False, True, 'full', 'hybrid' or "
                     f"'torch_stats', got {fused!r}")


def max_pool3d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Max pool with stride = window and VALID (floor) padding, NCDHW."""
    sp = sharding.spatial()
    dims = tuple(x.shape[2:5])
    if sp is not None:
        dims = (sp.global_depth(x),) + dims[1:]
    if min(dims) < window:
        # A zero-size pool output would turn the whole model NaN after GAP.
        raise ValueError(
            f"max_pool3d: spatial dims {dims} smaller than "
            f"the {window}^3 window — the conv tower is too deep for this "
            f"volume size")
    if sp is not None:
        return sharding.pool_window(
            x, window, window, 0, 0.0,
            lambda xw, first, depth: F.max_pool3d(xw, window, window))
    return F.max_pool3d(x, window, window)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool3d(1) + Flatten: (B, C, D, H, W) -> (B, C); over
    the depth slabs of every spatial rank under a spatial axis."""
    sp = sharding.spatial()
    if sp is not None:
        return sharding.global_avg_pool(x, sp)
    return x.mean(dim=(2, 3, 4))


def _uniform(x: torch.Tensor, generator) -> torch.Tensor:
    """U[0, 1) float32 of x's shape from ``generator``; inside a
    ``data_parallel`` block the rank's rows of a draw at the global batch
    shape."""
    dp = split()
    if dp is None:
        return torch.rand(x.shape, generator=generator, device=x.device)
    u = torch.rand((dp.global_rows,) + tuple(x.shape[1:]),
                   generator=generator, device=x.device)
    return u[dp.offset:dp.offset + x.shape[0]]


class Dropout(nn.Module):
    """flax ``nn.Dropout`` in train mode: keep each element with
    probability ``1 - p`` and scale the survivors by ``1 / (1 - p)``; the
    identity in eval mode and at ``p = 0``. The result keeps x's dtype: flax
    divides by the Python float ``1 - p`` (a weak type), as torch divides by
    it here. The keep mask is drawn from
    ``generator`` (torch's global RNG on the input's device when None); it
    must live on the input's device. ``set_dropout_generator`` sets it."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = _uniform(x, self.generator) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))

    def extra_repr(self) -> str:
        return f"p={self.p}"


def traced_dropout(x: torch.Tensor, rate: float,
                   generator: torch.Generator | None,
                   dtype=torch.float32) -> torch.Tensor:
    """Dropout whose rate is a call-time value (JAX ``traced_dropout``,
    ``layers.py:123-136``): a Bernoulli keep mask with ``keep = 1 - rate``
    in float32, survivors divided by ``keep`` rounded to ``dtype`` (the
    compute dtype), the rest 0. The K-trial trainer (``train/vmap_hpo.py``)
    gives each trial its own rate this way. ``rate == 0.0`` returns ``x``
    itself, bit-exact to no dropout, and draws nothing from ``generator``.
    Callers gate on train mode."""
    if float(rate) == 0.0:
        return x
    keep = (torch.ones((), dtype=torch.float32)
            - torch.tensor(float(rate), dtype=torch.float32))
    mask = _uniform(x, generator) < keep.item()
    # both values are exact as Python floats, so no operand is rounded
    return torch.where(mask, x / keep.to(dtype).item(),
                       torch.zeros((), dtype=x.dtype, device=x.device))


class TracedDropout(nn.Module):
    """Holds the generator of a model's ``traced_dropout`` calls (set by
    ``set_dropout_generator``); ``forward(x, rate)`` drops in train mode
    only. No parameters, so no state-dict entries."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor, rate) -> torch.Tensor:
        if not self.training:
            return x
        return traced_dropout(x, rate, self.generator, self.dtype)


def set_dropout_generator(module: nn.Module,
                          generator: torch.Generator | None) -> None:
    """Every ``Dropout`` and ``TracedDropout`` in ``module`` draws its masks
    from ``generator`` (JAX passes ``rngs={"dropout": key}`` to the
    step)."""
    for m in module.modules():
        if isinstance(m, (Dropout, TracedDropout)):
            m.generator = generator


class ConvBlock3D(nn.Module):
    """Conv3d('same', bias) -> [BN] -> ReLU -> MaxPool(2) -> [Dropout]
    (reference pet_cnn.py:17-28); submodules ``conv``, ``bn``; ``dtype`` is
    the compute dtype. ``forward(x, dropout_rate)``: a rate given at call
    time replaces the static ``dropout_p`` (``traced_dropout``)."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 use_batchnorm: bool = False, dropout_p=None,
                 bn_torch_stats: bool = False, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.conv = Conv3d(in_features, features, kernel_size,
                           padding="same", device=device, compute_dtype=dtype)
        self.bn = (batch_norm(features,
                              "torch_stats" if bn_torch_stats else False,
                              device, dtype)
                   if use_batchnorm else None)
        self.dropout = Dropout(dropout_p) if dropout_p is not None else None
        self.traced_dropout = TracedDropout(dtype)

    def forward(self, x: torch.Tensor, dropout_rate=None) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        x = max_pool3d(F.relu(x))
        if dropout_rate is not None:
            x = self.traced_dropout(x, dropout_rate)
        elif self.dropout is not None:
            x = self.dropout(x)
        return x


class ConvTower3D(nn.Module):
    """``block_{i}``: one ConvBlock3D per (width, kernel) pair
    (pet_cnn.py:17-28); ``out_features`` is the last block's width."""

    def __init__(self, in_features: int, conv_out, filter_size,
                 use_batchnorm: bool = False, dropout_p=None,
                 bn_torch_stats: bool = False, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.out_features = in_features
        self.n_blocks = 0
        for i, (features, kernel) in enumerate(zip(conv_out, filter_size)):
            self.add_module(f"block_{i}", ConvBlock3D(
                self.out_features, features, kernel, use_batchnorm,
                dropout_p, bn_torch_stats, device, dtype))
            self.out_features = features
            self.n_blocks = i + 1

    def forward(self, x: torch.Tensor, dropout_rate=None) -> torch.Tensor:
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x, dropout_rate)
        return x


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
