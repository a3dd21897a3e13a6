"""The stem max pool with a hand-written Hopper backward (K8).

Counterpart of ``multimodal_alzheimer_tpu/ops/pallas_maxpool.py``.
``max_pool3d_pl`` is MaxPool3d(k=3, stride=2, pad=1) on NCDHW as a
``torch.autograd.Function``: its forward is the library pool, and it saves
``x`` and ``y``; its backward is ``max_pool3d_backward``, which takes the
winner of each window from ``x == y``, as the JAX function does, and never
torch's pool indices.

``max_pool3d_backward`` launches the kernel of ``csrc/maxpool_bwd.cu`` on a
CUDA tensor (float32 or bfloat16, contiguous, one device, at any storage
offset; anything else raises, and so does a plane whose slab of one output
slice does not fit in a block's shared memory: f32 slices of more than
about 14,000 elements) and runs ``ops/maxpool.max_pool3d_backward_plain`` on
a CPU tensor. One launch per call, no workspace; every launch adds one to
``LAUNCHES["maxpool_bwd"]``.

On a depth window (``first``, ``depth``; ``ops/maxpool.window_outputs``),
for a volume whose depth is sharded (``parallel/tp.py``): the forward pools
the outputs whose windows the planes read, and the backward is the same
kernel told where the window lies. A window that starts at plane 0 is
today's call on its planes; one that starts at an odd plane (an interior
slab, with its lead plane) goes through the entry point
``maxpool_bwd_window`` and adds one to ``LAUNCHES["maxpool_bwd_window"]``.

The kernel chooses per shape how many output slices a block takes (its
model of a short grid's load on each SM; ``slab_plan()`` reports the
choice); the result is the same bit for bit at any slab.
"""

from __future__ import annotations

import ctypes

import torch

from multimodal_alzheimer_tpu_torch.ops import _native
from multimodal_alzheimer_tpu_torch.ops.maxpool import (
    max_pool3d_backward_plain,
    pool_forward_window,
    window_outputs,
)

LAUNCHES = {"maxpool_bwd": 0, "maxpool_bwd_window": 0}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _pooled(n: int) -> int:
    return (n - 1) // 2 + 1


def _check_operands(x: torch.Tensor, y: torch.Tensor,
                    g: torch.Tensor, lead: int = 0) -> None:
    """Raise on anything the kernel does not take."""
    if x.ndim != 5:
        raise ValueError(f"max_pool3d_backward takes NCDHW x, got shape "
                         f"{tuple(x.shape)}")
    want = (tuple(x.shape[:2]) + (_pooled(x.shape[2] - lead),)
            + tuple(_pooled(n) for n in x.shape[3:]))
    for name, t in (("y", y), ("g", g)):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; the pool "
                             f"of x {tuple(x.shape)} is {want}")
    for t in (x, y, g):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"the max-pool kernel takes float32 or bfloat16, "
                            f"got {t.dtype}")
        if t.dtype != x.dtype:
            raise TypeError(f"operands of {x.dtype} and {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"operands on {x.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError("the max-pool kernel takes contiguous tensors")
    d, h, w = x.shape[2:]
    if _native.library().maxpool_bwd_slab(d - lead, h, w,
                                          _DTYPE_CODES[x.dtype]) == 0:
        raise ValueError(f"the max-pool kernel stages slices of H x W = "
                         f"{h} x {w} {x.dtype} in shared memory, and a slab "
                         f"of them does not fit")


def max_pool3d_backward(x: torch.Tensor, y: torch.Tensor,
                        g: torch.Tensor, first: int = 0, depth=None,
                        slab: int = 0) -> torch.Tensor:
    """dx of MaxPool3d(3, 2, 1) from x (B, C, D, H, W), its pool y and the
    cotangent g, all of one dtype: the first ``x == y`` offset of each
    window takes g, added in ascending output order. With ``depth``, x is
    the depth window ``[first, first + D)`` of a volume of depth ``depth``
    and y, g the outputs that read it. ``slab`` (1-8 output slices a
    block) overrides the kernel's own choice (``slab_plan()``), for tests
    and timing; the result is the same."""
    lead = 0
    if depth is not None:
        lead, _, do = window_outputs(first, x.shape[2], depth)
        if y.shape[2] != do:
            raise ValueError(f"y has {y.shape[2]} output planes; the window "
                             f"has {do}")
    if not _native.on_cuda(x):
        return max_pool3d_backward_plain(x, y, g, first, depth)
    _check_operands(x, y, g, lead)
    lib = _native.library()
    b, c, d, h, w = x.shape
    dx = torch.empty_like(x)
    args = (x.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(), b * c,
            d, h, w)
    tail = (_DTYPE_CODES[x.dtype], slab, x.device.index,
            _native.stream(x.device))
    name = "maxpool_bwd_window" if lead else "maxpool_bwd"
    if lead:
        code = lib.maxpool_bwd_window(*args, lead, *tail)
    else:
        code = lib.maxpool_bwd(*args, *tail)
    _native.check(code, name)
    LAUNCHES[name] += 1
    return dx


PLAN_KEYS = ("td", "blocks", "resident", "smem")


def slab_plan(x: torch.Tensor, first: int = 0, depth=None) -> dict:
    """The slab the kernel takes for x (on the card, as
    ``max_pool3d_backward`` takes it): output slices ``td`` a block, the
    grid's ``blocks``, the blocks ``resident`` on the card at once, and a
    block's shared memory ``smem`` in bytes."""
    d = x.shape[2]
    lead = 0 if depth is None else window_outputs(first, d, depth)[0]
    out = (ctypes.c_int64 * len(PLAN_KEYS))()
    b, c, _, h, w = x.shape
    code = _native.library().maxpool_bwd_plan(
        b * c, d, h, w, lead, _DTYPE_CODES[x.dtype], x.device.index,
        ctypes.addressof(out))
    _native.check(code, "maxpool_bwd_plan")
    return dict(zip(PLAN_KEYS, list(out)))


class _MaxPool3dPL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, first, depth):
        y = pool_forward_window(x, first, depth)
        ctx.save_for_backward(x, y)
        ctx.first, ctx.depth = first, depth
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return (max_pool3d_backward(x, y, g.to(x.dtype).contiguous(),
                                    ctx.first, ctx.depth), None, None)


def max_pool3d_pl(x: torch.Tensor, first: int = 0,
                  depth=None) -> torch.Tensor:
    """MaxPool3d(3, 2, 1) over the last three axes of NCDHW ``x``, with the
    backward of ``max_pool3d_backward``; of the depth window ``[first, first
    + D)`` of a volume of depth ``depth`` when that is given."""
    return _MaxPool3dPL.apply(x, first, depth)
