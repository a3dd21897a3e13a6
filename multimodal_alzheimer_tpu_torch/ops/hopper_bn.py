"""Training-mode BatchNorm: Hopper kernels, plain versions, autograd.

Counterpart of ``multimodal_alzheimer_tpu/ops/pallas_bn.py``. Four kernels
in ``csrc/batch_norm.cu`` do the work on the card:

* ``bn_stats``: per-channel [sum x; sum x^2] (the TPU's ``_sum_kernel``);
* ``bn_apply``: ``((x - mean) * inv) * scale + bias`` (``_apply_kernel``);
* ``bn_grad_sum``: per-channel [sum g; sum g * xhat] (``_grad_sum_kernel``);
* ``bn_dx``: ``(scale * inv) * ((g - red0) - xhat * red1)`` (``_dx_kernel``).

They take activations of shape (B, C, ...) with channels on axis 1, the
model's NCDHW layout, viewed as (B, C, S) rows without a copy. JAX's
functions take (N, C) with channels last; the statistics and gradients are
the same. x and g are float32 or bfloat16 (the model's compute dtype); the
statistics, scale, bias and sums are float32. As in the Pallas bodies,
every function reads x and g in their dtype, computes in float32 and
returns y and dx in x's dtype, rounded once. Each wrapper takes the plain
PyTorch version for CPU tensors only. For a CUDA tensor it launches the
kernel or raises (x and g float32 or bfloat16 and of one dtype, the rest
float32, contiguous, one device). Every kernel launch adds one to
``LAUNCHES[name]``.

``batch_norm_train`` (forward K4 then K5, backward K6 then K7) and
``lane_packed_stats`` (K4, with the closed-form statistics VJP) are the
``torch.autograd.Function`` counterparts of the JAX custom VJPs. Inside a
``parallel.data_parallel`` block they normalise over the global batch, as
GSPMD does under JAX's mesh: K4's sums are all-reduced before the moments
and K5, K6's before K7, which divides by the global count; the
``lane_packed_stats`` VJP all-reduces the statistics' cotangents. The
scale and bias gradients stay the rank's own sums: the train step sums
every parameter gradient over the ranks. Under a 3-D mesh
(``parallel/tp.py``) the kernels run on the rank's channel slice of its
depth slab, and the sums are all-reduced over data x spatial, the global
count taking the global depth.
"""

from __future__ import annotations

import torch

from multimodal_alzheimer_tpu_torch.ops import _native
from multimodal_alzheimer_tpu_torch.parallel.mesh import current

LAUNCHES = {"bn_stats": 0, "bn_apply": 0, "bn_grad_sum": 0, "bn_dx": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(B, C, S) view of a (B, C, ...) activation."""
    if x.ndim < 2:
        raise ValueError(f"BatchNorm input needs (B, C, ...), got "
                         f"{tuple(x.shape)}")
    return x.reshape(x.shape[0], x.shape[1], -1)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    """(C,) -> (1, C, 1), broadcasting over (B, C, S)."""
    return v.reshape(1, -1, 1)


# dtype codes of the C entry points (csrc/batch_norm.cu)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel_operands(data, stats=()) -> int:
    """Raise on anything the kernels do not take; return the dtype code.
    ``data``: the activations (x, and g where there is one), float32 or
    bfloat16, of one dtype; ``stats``: the per-channel operands, float32."""
    x = data[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f"the BatchNorm kernels take float32 or bfloat16 "
                        f"activations, got {x.dtype}")
    for t in data[1:]:
        if t.dtype != x.dtype:
            raise TypeError(f"activations of dtypes {x.dtype} and {t.dtype}")
    for t in stats:
        if t.dtype != torch.float32:
            raise TypeError(f"the BatchNorm kernels take float32 statistics, "
                            f"got {t.dtype}")
    for t in tuple(data) + tuple(stats):
        if t.device != x.device:
            raise ValueError(f"operands on {x.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError("the BatchNorm kernels take contiguous tensors")
    return _DTYPES[x.dtype]


# ---------------------------------------------------------------- plain --


def bn_stats_plain(x3: torch.Tensor) -> torch.Tensor:
    """Plain version of ``bn_stats`` on (B, C, S): (2, C) float32 [sum;
    sum x^2]."""
    x3 = x3.float()
    return torch.stack([x3.sum(dim=(0, 2)), (x3 * x3).sum(dim=(0, 2))])


def bn_apply_plain(x3, mean, inv, scale, bias) -> torch.Tensor:
    """Plain version of ``bn_apply`` on (B, C, S), in x's dtype."""
    c = _per_channel
    y = ((x3.float() - c(mean)) * c(inv)) * c(scale) + c(bias)
    return y.to(x3.dtype)


def bn_grad_sum_plain(g3, x3, mean, inv) -> torch.Tensor:
    """Plain version of ``bn_grad_sum``: (2, C) float32 [sum g; sum g *
    xhat]."""
    g3 = g3.float()
    xhat = (x3.float() - _per_channel(mean)) * _per_channel(inv)
    return torch.stack([g3.sum(dim=(0, 2)), (g3 * xhat).sum(dim=(0, 2))])


def bn_dx_plain(g3, x3, mean, inv, scale, red) -> torch.Tensor:
    """Plain version of ``bn_dx`` in x's dtype; ``red`` is (2, C) [sum g;
    sum g xhat]/N."""
    c = _per_channel
    xhat = (x3.float() - c(mean)) * c(inv)
    dx = c(scale * inv) * ((g3.float() - c(red[0])) - xhat * c(red[1]))
    return dx.to(x3.dtype)


# ------------------------------------------------------------- wrappers --


def _reduce_kernel(name: str, dtype: int, x3: torch.Tensor,
                   *extra) -> torch.Tensor:
    """``bn_stats`` (no extra operands) or ``bn_grad_sum`` (g, mean, inv):
    one launch, no workspace."""
    lib = _native.library()
    b, c, s = x3.shape
    device = x3.device
    sums = torch.empty((2, c), dtype=torch.float32, device=device)
    if name == "bn_stats":
        code = lib.bn_stats(x3.data_ptr(), dtype, b, c, s, sums.data_ptr(),
                            device.index, _native.stream(device))
    else:
        g3, mean, inv = extra
        code = lib.bn_grad_sum(g3.data_ptr(), x3.data_ptr(), dtype,
                               mean.data_ptr(), inv.data_ptr(), b, c, s,
                               sums.data_ptr(), device.index,
                               _native.stream(device))
    _native.check(code, name)
    LAUNCHES[name] += 1
    return sums


def bn_stats(x: torch.Tensor) -> torch.Tensor:
    """(2, C) float32 [sum x; sum x^2] over every axis but 1."""
    x3 = _rows(x)
    if not _native.on_cuda(x3):
        return bn_stats_plain(x3)
    return _reduce_kernel("bn_stats", _kernel_operands((x3,)), x3)


def bn_apply(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
             scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``((x - mean) * inv) * scale + bias`` with (C,) operands, x's shape
    and dtype."""
    x3 = _rows(x)
    if not _native.on_cuda(x3):
        return bn_apply_plain(x3, mean, inv, scale, bias).reshape(x.shape)
    dtype = _kernel_operands((x3,), (mean, inv, scale, bias))
    lib = _native.library()
    b, c, s = x3.shape
    y = torch.empty_like(x3)
    code = lib.bn_apply(x3.data_ptr(), dtype, mean.data_ptr(), inv.data_ptr(),
                        scale.data_ptr(), bias.data_ptr(), y.data_ptr(), b, c,
                        s, x3.device.index, _native.stream(x3.device))
    _native.check(code, "bn_apply")
    LAUNCHES["bn_apply"] += 1
    return y.reshape(x.shape)


def bn_grad_sum(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                inv: torch.Tensor) -> torch.Tensor:
    """(2, C) float32 [sum g; sum g * (x - mean) * inv]."""
    g3, x3 = _rows(g), _rows(x)
    if not _native.on_cuda(x3):
        return bn_grad_sum_plain(g3, x3, mean, inv)
    dtype = _kernel_operands((x3, g3), (mean, inv))
    return _reduce_kernel("bn_grad_sum", dtype, x3, g3, mean, inv)


def bn_dx(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
          inv: torch.Tensor, scale: torch.Tensor,
          red: torch.Tensor) -> torch.Tensor:
    """``(scale * inv) * ((g - red[0]) - xhat * red[1])``, x's shape and
    dtype."""
    g3, x3 = _rows(g), _rows(x)
    if not _native.on_cuda(x3):
        return bn_dx_plain(g3, x3, mean, inv, scale, red).reshape(x.shape)
    dtype = _kernel_operands((x3, g3), (mean, inv, scale, red))
    lib = _native.library()
    b, c, s = x3.shape
    dx = torch.empty_like(x3)
    code = lib.bn_dx(g3.data_ptr(), x3.data_ptr(), dtype, mean.data_ptr(),
                     inv.data_ptr(), scale.data_ptr(), red.data_ptr(),
                     dx.data_ptr(), b, c, s, x3.device.index,
                     _native.stream(x3.device))
    _native.check(code, "bn_dx")
    LAUNCHES["bn_dx"] += 1
    return dx.reshape(x.shape)


# ------------------------------------------------------------- autograd --


def _count(x: torch.Tensor) -> int:
    """Elements per channel: N of the (N, C) view the JAX kernels take."""
    return x.numel() // x.shape[1]


def _moments(sums: torch.Tensor, n: int):
    """mean = sum/n, var = sum_sq/n - mean^2 (biased, in f32, as JAX; it can
    cancel)."""
    mean = sums[0] / n
    return mean, sums[1] / n - mean * mean


def _global_moments(ctx, x: torch.Tensor):
    """K4's (mean, var) of ``x`` over the batch, global inside a
    ``data_parallel`` block (the sums all-reduced, one collective); keeps
    the block and the count N on ``ctx`` for the backward."""
    sums = bn_stats(x)
    dp = current()
    ctx.mesh = None if dp is None else dp.stats_mesh(x)
    ctx.n = _count(x)
    if dp is not None:
        ctx.mesh.all_reduce_(sums)
        ctx.n = dp.stats_count(x)
    return _moments(sums, ctx.n)


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        mean, var = _global_moments(ctx, x)
        y = bn_apply(x, mean, torch.rsqrt(var + eps), scale, bias)
        ctx.save_for_backward(x, scale, mean, var)
        ctx.eps = eps
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        # The statistics' cotangents are ignored, as in pallas_bn._bn_bwd.
        x, scale, mean, var = ctx.saved_tensors
        inv = torch.rsqrt(var + ctx.eps)
        gy = gy.contiguous()
        sums = bn_grad_sum(gy, x, mean, inv)  # [dbias; dscale], this rank's
        red = sums
        if ctx.mesh is not None:
            red = ctx.mesh.all_reduce_(sums.clone())
        dx = bn_dx(gy, x, mean, inv, scale, red / ctx.n)
        return dx, sums[1], sums[0], None


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5):
    """Training-mode BatchNorm over every axis but 1: ``(y, mean, var)``
    with the biased batch variance; gradients for x, scale and bias."""
    return _BatchNormTrain.apply(x, scale, bias, eps)


class _LanePackedStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        mean, var = _global_moments(ctx, x)
        ctx.save_for_backward(x, mean)
        return mean, var

    @staticmethod
    def backward(ctx, gmean, gvar):
        x, mean = ctx.saved_tensors
        n = ctx.n
        if ctx.mesh is not None:  # every rank's loss reaches the statistics
            gmean, gvar = ctx.mesh.all_reduce_(torch.stack([gmean, gvar]))
        c = _per_channel
        # d mean/dx = 1/N; d var/dx = 2 (x - mean) / N (biased variance), in
        # float32, returned in x's dtype
        dx = c(gmean / n) + c((2.0 / n) * gvar) * (_rows(x).float() - c(mean))
        return dx.reshape(x.shape).to(x.dtype)


def lane_packed_stats(x: torch.Tensor):
    """Per-channel ``(mean, var)`` (biased) through ``bn_stats``, with the
    closed-form VJP of ``pallas_bn.lane_packed_stats``. The port keeps the
    JAX name; it packs no lanes."""
    return _LanePackedStats.apply(x)
