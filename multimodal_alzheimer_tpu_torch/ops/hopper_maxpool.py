"""The stem max pool with a hand-written Hopper backward (K8).

Counterpart of ``multimodal_alzheimer_tpu/ops/pallas_maxpool.py``.
``max_pool3d_pl`` is MaxPool3d(k=3, stride=2, pad=1) on NCDHW as a
``torch.autograd.Function``: its forward is the library pool, and it saves
``x`` and ``y``; its backward is ``max_pool3d_backward``, which takes the
winner of each window from ``x == y``, as the JAX function does, and never
torch's pool indices.

``max_pool3d_backward`` launches the kernel of ``csrc/maxpool_bwd.cu`` on a
CUDA tensor (float32 or bfloat16, contiguous, one device; anything else
raises) and runs ``ops/maxpool.max_pool3d_backward_plain`` on a CPU tensor.
Every kernel launch adds one to ``LAUNCHES["maxpool_bwd"]``.
"""

from __future__ import annotations

import torch

from multimodal_alzheimer_tpu_torch.ops import _native
from multimodal_alzheimer_tpu_torch.ops.maxpool import (
    max_pool3d_backward_plain,
    pool_forward,
)

LAUNCHES = {"maxpool_bwd": 0}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    LAUNCHES["maxpool_bwd"] = 0


def _pooled(n: int) -> int:
    return (n - 1) // 2 + 1


def _check_operands(x: torch.Tensor, y: torch.Tensor,
                    g: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
    if x.ndim != 5:
        raise ValueError(f"max_pool3d_backward takes NCDHW x, got shape "
                         f"{tuple(x.shape)}")
    want = tuple(x.shape[:2]) + tuple(_pooled(n) for n in x.shape[2:])
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


def max_pool3d_backward(x: torch.Tensor, y: torch.Tensor,
                        g: torch.Tensor) -> torch.Tensor:
    """dx of MaxPool3d(3, 2, 1) from x (B, C, D, H, W), its pool y and the
    cotangent g, all of one dtype: the first ``x == y`` offset of each
    window takes g, added in ascending output order."""
    if not _native.on_cuda(x):
        return max_pool3d_backward_plain(x, y, g)
    _check_operands(x, y, g)
    lib = _native.library()
    b, c, d, h, w = x.shape
    work = torch.empty(y.numel(), dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    code = lib.maxpool_bwd(x.data_ptr(), y.data_ptr(), g.data_ptr(),
                           work.data_ptr(), dx.data_ptr(), b * c, d, h, w,
                           _DTYPE_CODES[x.dtype], x.device.index,
                           _native.stream(x.device))
    _native.check(code, "maxpool_bwd")
    LAUNCHES["maxpool_bwd"] += 1
    return dx


class _MaxPool3dPL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = pool_forward(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return max_pool3d_backward(x, y, g.to(x.dtype).contiguous())


def max_pool3d_pl(x: torch.Tensor) -> torch.Tensor:
    """MaxPool3d(3, 2, 1) over the last three axes of NCDHW ``x``, with the
    backward of ``max_pool3d_backward``."""
    return _MaxPool3dPL.apply(x)
