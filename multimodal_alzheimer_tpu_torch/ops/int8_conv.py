"""int8 3D convolution with a float32 epilogue: the Hopper kernel K9 and its
plain version.

Counterpart of ``multimodal_alzheimer_tpu/inference/quantize.py``'s
``_conv_int8``: ``float32(conv_int32(q, wq)) * scale + bias`` with int8
operands and int32 sums, the convolution of every layer of the int8 serving
graphs (``inference/quantize.py``). The JAX package leaves it to XLA; here
``int8_conv3d`` (``csrc/int8_conv3d.cu``) computes it on the tensor cores.

Layouts, as the kernel takes them:

* ``x``: int8 ``(B, D, H, W, C)``, contiguous (channels-last, JAX's NDHWC);
* ``w``: int8 ``(F, K_pad)`` from ``pack_weight``: ``K = kd * kh * kw * C``
  tap-major and channel-minor, zero-padded to a multiple of 32;
* ``scale``, ``bias``: float32 ``(F,)``;
* the result: float32 ``(B, Do, Ho, Wo, F)``.

``kernel`` is ``(kd, kh, kw)``, ``stride`` and ``dilation`` one int each for
all three dimensions, ``pads`` ``((lo, hi),) * 3`` of zeros (exact: symmetric
int8 has zero point 0).

The wrapper takes the plain version for CPU tensors only; for CUDA tensors
it launches K9 or raises, and each launch adds one to
``LAUNCHES["int8_conv3d"]``. Both go through the custom op
``mmalz_port::int8_conv3d`` (its CPU kernel the plain version, its CUDA
kernel K9, a fake kernel for shapes), so ``torch.export`` records the op and
an exported program runs the same kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multimodal_alzheimer_tpu_torch.ops import _native

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


def _kernel(x, w, scale, bias, kernel, stride, dilation, pads):
    """One launch of K9, no workspace."""
    b, d, h, wd, c = x.shape
    f = w.shape[0]
    size = output_size((d, h, wd), kernel, stride, dilation, pads)
    out = torch.empty((b,) + size + (f,), dtype=torch.float32,
                      device=x.device)
    (dl, dh), (hl, hh), (wl, wh) = pads
    device = x.device
    code = _native.library().int8_conv3d(
        x.data_ptr(), w.data_ptr(), scale.contiguous().data_ptr(),
        bias.contiguous().data_ptr(), out.data_ptr(), b, d, h, wd, c, f,
        *kernel, w.shape[1], stride, dilation, dl, dh, hl, hh, wl, wh,
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
