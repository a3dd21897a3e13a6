"""Narrow stride-1 "same" 3-D convolutions in bfloat16 (K10).

``conv3d(x, weight, bias)`` is ``F.conv3d(x, weight, bias, padding=k //
2)`` as a ``torch.autograd.Function`` over the kernels of
``csrc/narrow_conv3d.cu``: the forward (``fprop``), the input gradient
(``dgrad``: the same kernel on dy, reading the weights flipped and with
their two channel axes swapped) and the weight and bias gradient (``wgrad``: float32
partials a block, merged in block order, so two calls give the same bits).
bfloat16 operands, float32 sums, one rounding to bfloat16 of each output,
as cuDNN's bfloat16 convolution. The input gradient is computed only where
autograd asks for it.

The JAX package leaves these convolutions to XLA; no Pallas kernel is
replaced. They are the ``SmallPETCNN`` towers' first two blocks (1 -> 8
and 8 -> 16 channels, 5^3, on the full grid and its first pool), which
cuDNN ran at about 1% of their bound with its layout transposes.

``takes(conv, x)`` is the rule ``models/layers.Conv3d`` asks: a function of
the convolution's channels, kernel, stride, dilation, padding and groups
and of its input's dtype and device. It takes a bfloat16 conv on a CUDA
tensor whose (C_in, C_out, k) is in ``SHAPES`` with stride 1, dilation 1,
one group and "same" zero padding; where ``SHAPES`` has no input-gradient
kernel for it (1 -> 8), only an input that needs no gradient. Every other
convolution (float32, the ResNets' 64-channel and strided convs, the
1 -> 64 stride-2 stem) stays on ``F.conv3d``.

Each entry point runs its plain version for CPU tensors only (``F.conv3d``
and ``aten.convolution_backward``, what autograd computes for it). For a
CUDA tensor it launches its kernel or raises. Each launch adds one to
``LAUNCHES[direction]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multimodal_alzheimer_tpu_torch.ops import _native

LAUNCHES = {"fprop": 0, "dgrad": 0, "wgrad": 0}
# (C_in, C_out, k) of the layers the rule takes, and the instances of
# csrc/narrow_conv3d.cu: fprop and wgrad of each layer, fprop of
# (C_out, C_in, k) for the input gradients that have one.
SHAPES = ((1, 8, 5), (8, 16, 5))
DGRAD = ((8, 16, 5),)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def rule(cin: int, cout: int, kernel, stride, dilation, padding, groups: int,
         dtype, device, input_grad: bool = False) -> bool:
    """Whether a convolution of these properties runs on K10. Every conv of
    a model asks on every call, so the channel test, which refuses the
    ResNets' convs, comes first."""
    k = kernel[0]
    return ((cin, cout, k) in SHAPES and torch.device(device).type == "cuda"
            and dtype == torch.bfloat16 and tuple(kernel) == (k,) * 3
            and tuple(stride) == (1, 1, 1) and tuple(dilation) == (1, 1, 1)
            and groups == 1
            and (padding == "same" or tuple(padding) == (k // 2,) * 3)
            and (not input_grad or (cin, cout, k) in DGRAD))


def takes(conv: torch.nn.Conv3d, x: torch.Tensor) -> bool:
    """``rule`` for the module ``conv`` applied to ``x`` (in its compute
    dtype): zero padding only."""
    return conv.padding_mode == "zeros" and rule(
        conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride,
        conv.dilation, conv.padding, conv.groups, x.dtype, x.device,
        x.requires_grad and torch.is_grad_enabled())


def fprop_plain(x, weight, bias=None):
    return F.conv3d(x, weight, bias, padding=weight.shape[2] // 2)


def backward_plain(dy, x, weight, with_bias: bool, mask) -> tuple:
    """(dx, dw, db) of ``fprop_plain`` as autograd computes them; ``mask``
    says which of the three to compute."""
    p = weight.shape[2] // 2
    return torch.ops.aten.convolution_backward(
        dy, x, weight, [weight.shape[0]] if with_bias else None, [1] * 3,
        [p] * 3, [1] * 3, False, [0] * 3, 1,
        [mask[0], mask[1], mask[2] and with_bias])


def dgrad_plain(dy, weight):
    shape = (dy.shape[0], weight.shape[1]) + tuple(dy.shape[2:])
    x = torch.empty(shape, dtype=dy.dtype, device=dy.device)
    return backward_plain(dy, x, weight, False, (True, False, False))[0]


def wgrad_plain(x, dy, weight_shape, with_bias: bool) -> tuple:
    weight = torch.empty(weight_shape, dtype=x.dtype, device=x.device)
    _, dw, db = backward_plain(dy, x, weight, with_bias, (False, True, True))
    return dw, db


def _check(what: str, x, weight=None, dy=None) -> None:
    """Raise on anything the kernels do not take."""
    tensors = [t for t in (x, weight, dy) if t is not None]
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what} takes bfloat16, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{what}: operands on {x.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")
    if x.ndim != 5 or (dy is not None and dy.shape[2:] != x.shape[2:]):
        raise ValueError(f"{what} takes NCDHW operands of one grid")


def _launch_fprop(x, weight, bias, cin: int, cout: int, k: int,
                  flipped: bool = False):
    b, _, d, h, w = x.shape
    y = torch.empty((b, cout, d, h, w), dtype=x.dtype, device=x.device)
    code = _native.library().narrow_conv3d_fprop(
        x.data_ptr(), weight.data_ptr(),
        bias.data_ptr() if bias is not None else None, y.data_ptr(), b, d, h,
        w, cin, cout, k, int(flipped), x.device.index,
        _native.stream(x.device))
    _native.check(code, "narrow_conv3d_fprop")
    return y


def fprop(x, weight, bias=None):
    """``conv(x, weight) + bias`` (bias may be None)."""
    if not _native.on_cuda(x):
        return fprop_plain(x, weight, bias)
    cout, cin, k = weight.shape[:3]
    _check("narrow_conv3d fprop", x, weight)
    if (cin, cout, k) not in SHAPES or weight.shape[1:] != (cin, k, k, k) \
            or x.shape[1] != cin:
        raise ValueError(f"narrow_conv3d has no forward for x "
                         f"{tuple(x.shape)} and weight {tuple(weight.shape)}")
    if bias is not None:
        if bias.shape != (cout,):
            raise ValueError(f"narrow_conv3d: bias {tuple(bias.shape)} for "
                             f"{cout} output channels")
        _check("narrow_conv3d fprop", x, bias)
    y = _launch_fprop(x, weight, bias, cin, cout, k)
    LAUNCHES["fprop"] += 1
    return y


def dgrad(dy, weight):
    """The input gradient of ``fprop`` at output gradient ``dy``."""
    if not _native.on_cuda(dy):
        return dgrad_plain(dy, weight)
    cout, cin, k = weight.shape[:3]
    _check("narrow_conv3d dgrad", dy, weight)
    if (cin, cout, k) not in DGRAD or dy.shape[1] != cout:
        raise ValueError(f"narrow_conv3d has no input gradient for dy "
                         f"{tuple(dy.shape)} and weight "
                         f"{tuple(weight.shape)}")
    # the kernel reads the weights transposed and flipped: no copy of them
    dx = _launch_fprop(dy, weight, None, cout, cin, k, flipped=True)
    LAUNCHES["dgrad"] += 1
    return dx


def wgrad(x, dy, weight_shape, with_bias: bool) -> tuple:
    """(dw, db) of ``fprop`` at output gradient ``dy``: db None without a
    bias."""
    if not _native.on_cuda(x):
        return wgrad_plain(x, dy, weight_shape, with_bias)
    cout, cin, k = weight_shape[:3]
    _check("narrow_conv3d wgrad", x, dy=dy)
    lib = _native.library()
    floats = lib.narrow_conv3d_partial_floats(cin, cout, k)
    if floats == 0 or x.shape[1] != cin or dy.shape[1] != cout \
            or dy.shape[0] != x.shape[0]:
        raise ValueError(f"narrow_conv3d has no weight gradient for x "
                         f"{tuple(x.shape)} and dy {tuple(dy.shape)}")
    device = x.device
    partials = torch.empty(floats, dtype=torch.float32, device=device)
    dw = torch.empty(tuple(weight_shape), dtype=x.dtype, device=device)
    db = (torch.empty(cout, dtype=x.dtype, device=device) if with_bias
          else None)
    b, _, d, h, w = x.shape
    code = lib.narrow_conv3d_wgrad(
        x.data_ptr(), dy.data_ptr(), partials.data_ptr(), dw.data_ptr(),
        db.data_ptr() if db is not None else None, b, d, h, w, cin, cout, k,
        device.index, _native.stream(device))
    _native.check(code, "narrow_conv3d_wgrad")
    LAUNCHES["wgrad"] += 1
    return dw, db


class _NarrowConv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.with_bias = bias is not None
        return fprop(x, weight, bias)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.contiguous()
        need_x, need_w, need_b = ctx.needs_input_grad
        if not _native.on_cuda(dy):
            dx, dw, db = backward_plain(dy, x, weight, ctx.with_bias,
                                        (need_x, need_w, need_b))
            return dx, dw, db
        dx = dgrad(dy, weight) if need_x else None
        dw = db = None
        if need_w or need_b:
            dw, db = wgrad(x, dy, weight.shape, ctx.with_bias and need_b)
        return dx, dw if need_w else None, db


def conv3d(x, weight, bias=None, stride=1, padding="same", dilation=1,
           groups: int = 1):
    """``F.conv3d(x, weight, bias, stride, padding, dilation, groups)``
    through K10, with its gradients. Raises for what K10 does not compute:
    a stride or dilation other than 1, groups, padding other than "same",
    an even or non-cubic kernel, operands other than bfloat16; on the card
    also a (C_in, C_out, k) with no instance (``SHAPES``)."""
    k = weight.shape[2]
    triple = (lambda v: (v,) * 3 if isinstance(v, int) else tuple(v))
    if (triple(stride) != (1, 1, 1) or triple(dilation) != (1, 1, 1)
            or groups != 1 or not (padding == "same"
                                   or triple(padding) == (k // 2,) * 3)):
        raise ValueError(f"narrow_conv3d takes stride 1, dilation 1, one "
                         f"group and 'same' padding, got stride {stride}, "
                         f"dilation {dilation}, groups {groups}, padding "
                         f"{padding}")
    if weight.ndim != 5 or weight.shape[2:] != (k,) * 3 or k % 2 == 0 \
            or x.ndim != 5 or x.shape[1] != weight.shape[1]:
        raise ValueError(f"narrow_conv3d takes NCDHW x and an odd cubic "
                         f"kernel of its channels, got x {tuple(x.shape)} "
                         f"and weight {tuple(weight.shape)}")
    for t in (x, weight) + ((bias,) if bias is not None else ()):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"narrow_conv3d takes bfloat16, got {t.dtype}")
    return _NarrowConv3d.apply(x.contiguous(), weight.contiguous(), bias)
