"""int8 3D convolution with a float32 epilogue, and the same convolution
with the int8 graph's next steps fused into it: the Hopper kernel K9 and its
plain versions.

Counterpart of ``multimodal_alzheimer_tpu/inference/quantize.py``'s
``_conv_int8``: ``float32(conv_int32(q, wq)) * scale + bias`` with int8
operands and int32 sums, the convolution of every layer of the int8 serving
graphs (``inference/quantize.py``). The JAX package leaves it to XLA; here
``int8_conv3d`` (``csrc/int8_conv3d.cu``) computes it on the tensor cores.
``int8_conv3d_fused`` adds, in the order ``_backbone_forward`` applies them,
a residual (a float32 tensor, or an int8 carrier dequantized by its scale),
a ReLU and the requant to an int8 carrier, in the same kernel's epilogue.

Layouts, as the kernel takes them:

* ``x``: int8 ``(B, D, H, W, C)``, contiguous (channels-last, JAX's NDHWC);
* ``w``: int8 ``(F, K_pad)`` from ``pack_weight``: ``K = kd * kh * kw * C``
  tap-major and channel-minor, zero-padded to a multiple of 32;
* ``scale``, ``bias``: float32 ``(F,)``;
* the result: float32 (or, requantized, int8) ``(B, Do, Ho, Wo, F)``; a
  residual has the result's shape.

``kernel`` is ``(kd, kh, kw)``, ``stride`` and ``dilation`` one int each for
all three dimensions, ``pads`` ``((lo, hi),) * 3`` of zeros (exact: symmetric
int8 has zero point 0).

The wrappers take the plain versions for CPU tensors only; for CUDA tensors
they launch K9 or raise, and each launch adds one to
``LAUNCHES["int8_conv3d"]``. Both go through custom ops,
``mmalz_port::int8_conv3d`` and ``mmalz_port::int8_conv3d_fused`` (their
CPU kernels the plain versions, their CUDA kernels K9, fake kernels for
shapes), so ``torch.export`` records the ops and an exported program runs
the same kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_alzheimer_tpu_torch.ops import _native

# The residual's kind as the kernel takes it.
_RESIDUAL_KIND = {None: 0, torch.float32: 1, torch.int8: 2}

LAUNCHES = {"int8_conv3d": 0}
K_ALIGN = 32
# K * 127^2 < 2^31: no int32 sum can overflow (csrc/int8_conv3d.cu kMaxK).
MAX_K = 133142


def reset_launches() -> None:
    LAUNCHES["int8_conv3d"] = 0


def padded_k(k: int) -> int:
    return -(-k // K_ALIGN) * K_ALIGN


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """(F, C, kd, kh, kw) int8 (torch's conv layout) -> (F, K_pad) int8,
    tap-major and channel-minor, zero-padded to a multiple of 32."""
    f = wq.shape[0]
    flat = wq.permute(0, 2, 3, 4, 1).reshape(f, -1)
    return F.pad(flat, (0, padded_k(flat.shape[1]) - flat.shape[1])
                 ).contiguous()


def unpack_weight(w: torch.Tensor, kernel, c: int) -> torch.Tensor:
    """Inverse of ``pack_weight``: (F, K_pad) -> (F, C, kd, kh, kw)."""
    kd, kh, kw = kernel
    f = w.shape[0]
    return w[:, :kd * kh * kw * c].reshape(f, kd, kh, kw, c).permute(
        0, 4, 1, 2, 3)


def output_size(size, kernel, stride: int, dilation: int, pads) -> tuple:
    return tuple((n + lo + hi - dilation * (k - 1) - 1) // stride + 1
                 for n, k, (lo, hi) in zip(size, kernel, pads))


def int8_conv3d_plain(x, w, scale, bias, kernel, stride: int, dilation: int,
                      pads) -> torch.Tensor:
    """Plain version: ``F.conv3d`` in float64 on the int8 values (exact: a
    sum stays below 2^31 < 2^53), converted to int32, then to float32, then
    ``* scale`` and ``+ bias`` as two float32 operations."""
    c = x.shape[-1]
    wt = unpack_weight(w, kernel, c).to(torch.float64)
    xt = x.permute(0, 4, 1, 2, 3).to(torch.float64)
    (dl, dh), (hl, hh), (wl, wh) = pads
    xt = F.pad(xt, (wl, wh, hl, hh, dl, dh))
    acc = F.conv3d(xt, wt, stride=stride, dilation=dilation)
    acc = acc.to(torch.int32).permute(0, 2, 3, 4, 1).contiguous()
    return acc.to(torch.float32) * scale + bias


def int8_conv3d_fused_plain(x, w, scale, bias, kernel, stride: int,
                            dilation: int, pads, residual=None,
                            residual_scale: float = 1.0, relu: bool = False,
                            out_inv=None) -> torch.Tensor:
    """Plain version of the fused convolution: ``int8_conv3d_plain``, then
    the int8 graph's torch operations (``inference/quantize.py``'s
    ``_Int8Ctx``) in its order: ``+ residual`` (an int8 residual first
    dequantized, ``q.to(float32) * residual_scale``), ReLU, and with
    ``out_inv`` the requant ``clamp(round(v * out_inv), -127, 127)`` to
    int8."""
    v = int8_conv3d_plain(x, w, scale, bias, kernel, stride, dilation, pads)
    if residual is not None:
        if residual.dtype == torch.int8:
            residual = residual.to(torch.float32) * residual_scale
        v = v + residual
    if relu:
        v = F.relu(v)
    if out_inv is not None:
        v = torch.clamp(torch.round(v * out_inv), -127, 127).to(torch.int8)
    return v


def _check(x, w, scale, bias, kernel, pads) -> None:
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_conv3d takes int8 x and w, got {x.dtype} and "
                        f"{w.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("int8_conv3d takes float32 scale and bias")
    if x.ndim != 5 or w.ndim != 2 or len(kernel) != 3 or len(pads) != 3:
        raise ValueError(f"int8_conv3d takes x (B, D, H, W, C) and w "
                         f"(F, K_pad), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("int8_conv3d takes contiguous x (channels-last) "
                         "and w")
    k = kernel[0] * kernel[1] * kernel[2] * x.shape[-1]
    if k > MAX_K:
        raise ValueError(f"int8_conv3d: K = {k} taps x channels could "
                         f"overflow an int32 sum (at most {MAX_K})")
    if w.shape[1] != padded_k(k):
        raise ValueError(f"w has {w.shape[1]} columns, K = {k} packs to "
                         f"{padded_k(k)}")
    f = w.shape[0]
    if scale.shape != (f,) or bias.shape != (f,):
        raise ValueError(f"scale and bias must be ({f},)")
    devices = {t.device for t in (x, w, scale, bias)}
    if len(devices) != 1:
        raise ValueError(
            f"int8_conv3d operands on {sorted(map(str, devices))}")


def _check_residual(x, w, kernel, stride, dilation, pads, residual):
    if residual is None:
        return
    if residual.dtype not in (torch.float32, torch.int8):
        raise TypeError(f"int8_conv3d_fused takes a float32 or int8 "
                        f"residual, got {residual.dtype}")
    size = output_size(x.shape[1:4], kernel, stride, dilation, pads)
    shape = (x.shape[0],) + size + (w.shape[0],)
    if tuple(residual.shape) != shape or not residual.is_contiguous():
        raise ValueError(f"the residual must be a contiguous {shape}, got "
                         f"{tuple(residual.shape)}")
    if residual.device != x.device:
        raise ValueError(f"residual on {residual.device}, x on {x.device}")


def _kernel(x, w, scale, bias, kernel, stride, dilation, pads, residual=None,
            residual_scale=1.0, relu=False, out_inv=None):
    """One launch of K9, no workspace."""
    b, d, h, wd, c = x.shape
    f = w.shape[0]
    size = output_size((d, h, wd), kernel, stride, dilation, pads)
    out = torch.empty((b,) + size + (f,), device=x.device,
                      dtype=torch.float32 if out_inv is None else torch.int8)
    (dl, dh), (hl, hh), (wl, wh) = pads
    device = x.device
    code = _native.library().int8_conv3d(
        x.data_ptr(), w.data_ptr(), scale.contiguous().data_ptr(),
        bias.contiguous().data_ptr(),
        None if residual is None else residual.data_ptr(),
        _RESIDUAL_KIND[None if residual is None else residual.dtype],
        residual_scale, int(relu), int(out_inv is not None),
        0.0 if out_inv is None else out_inv, out.data_ptr(), b, d, h, wd, c,
        f, *kernel, w.shape[1], stride, dilation, dl, dh, hl, hh, wl, wh,
        device.index, _native.stream(device))
    _native.check(code, "int8_conv3d")
    LAUNCHES["int8_conv3d"] += 1
    return out


@torch.library.custom_op("mmalz_port::int8_conv3d", mutates_args=(),
                         device_types="cpu")
def _op(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
        bias: torch.Tensor, kernel: list[int], stride: int, dilation: int,
        pads: list[int]) -> torch.Tensor:
    return int8_conv3d_plain(x, w, scale, bias, kernel, stride, dilation,
                             _pairs(pads))


@_op.register_kernel("cuda")
def _(x, w, scale, bias, kernel, stride, dilation, pads):
    return _kernel(x, w, scale, bias, tuple(kernel), stride, dilation,
                   _pairs(pads))


@_op.register_fake
def _(x, w, scale, bias, kernel, stride, dilation, pads):
    size = output_size(x.shape[1:4], kernel, stride, dilation, _pairs(pads))
    return x.new_empty((x.shape[0],) + size + (w.shape[0],),
                       dtype=torch.float32)


def _pairs(flat) -> tuple:
    return tuple((flat[i], flat[i + 1]) for i in range(0, 6, 2))


def int8_conv3d(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor, kernel, stride: int = 1,
                dilation: int = 1, pads=((0, 0),) * 3) -> torch.Tensor:
    """``float32(conv_int32(x, w)) * scale + bias``: K9 on the card, the
    plain version on the CPU (the module docstring has the layouts)."""
    kernel = tuple(int(k) for k in kernel)
    pads = tuple((int(lo), int(hi)) for lo, hi in pads)
    _check(x, w, scale, bias, kernel, pads)
    _native.on_cuda(x)  # raises for a device with neither route
    return _op(x, w, scale, bias, list(kernel), int(stride), int(dilation),
               [p for pair in pads for p in pair])


@torch.library.custom_op("mmalz_port::int8_conv3d_fused", mutates_args=(),
                         device_types="cpu")
def _fused_op(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor, residual: Optional[torch.Tensor],
              kernel: list[int], stride: int, dilation: int, pads: list[int],
              residual_scale: float, relu: bool,
              out_inv: Optional[float]) -> torch.Tensor:
    return int8_conv3d_fused_plain(
        x, w, scale, bias, kernel, stride, dilation, _pairs(pads), residual,
        residual_scale, relu, out_inv)


@_fused_op.register_kernel("cuda")
def _(x, w, scale, bias, residual, kernel, stride, dilation, pads,
      residual_scale, relu, out_inv):
    return _kernel(x, w, scale, bias, tuple(kernel), stride, dilation,
                   _pairs(pads), residual, residual_scale, relu, out_inv)


@_fused_op.register_fake
def _(x, w, scale, bias, residual, kernel, stride, dilation, pads,
      residual_scale, relu, out_inv):
    size = output_size(x.shape[1:4], kernel, stride, dilation, _pairs(pads))
    return x.new_empty((x.shape[0],) + size + (w.shape[0],),
                       dtype=torch.float32 if out_inv is None else torch.int8)


def int8_conv3d_fused(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, kernel, stride: int = 1,
                      dilation: int = 1, pads=((0, 0),) * 3, *,
                      residual: Optional[torch.Tensor] = None,
                      residual_scale: float = 1.0, relu: bool = False,
                      out_scale: Optional[float] = None) -> torch.Tensor:
    """``int8_conv3d`` with the int8 graph's next steps in its epilogue:
    ``+ residual`` (float32, or an int8 carrier times ``residual_scale``),
    ReLU if ``relu``, and with ``out_scale`` the requant to an int8 carrier
    of that scale (``clamp(round(v * f32(1 / out_scale)), -127, 127)``, the
    reciprocal rounded to float32 once, as ``_Int8Ctx.requant`` takes it).
    K9 on the card, ``int8_conv3d_fused_plain`` on the CPU."""
    kernel = tuple(int(k) for k in kernel)
    pads = tuple((int(lo), int(hi)) for lo, hi in pads)
    _check(x, w, scale, bias, kernel, pads)
    _check_residual(x, w, kernel, stride, dilation, pads, residual)
    _native.on_cuda(x)  # raises for a device with neither route
    out_inv = (None if out_scale is None
               else float(np.float32(1.0 / out_scale)))
    return _fused_op(x, w, scale, bias, residual, list(kernel), int(stride),
                     int(dilation), [p for pair in pads for p in pair],
                     float(np.float32(residual_scale)), bool(relu), out_inv)
