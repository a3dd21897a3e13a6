"""Per-scan quantile min-max normalisation: Hopper kernels and plain versions.

Counterpart of ``multimodal_alzheimer_tpu/ops/pallas_norm.py``'s
``batched_masked_quantiles``, ``per_scan_minmax`` and ``minmax_apply``. Two
kernels in ``csrc/minmax_norm.cu`` do the work on the card:

* ``minmax_select``: exact per-scan order statistics by an 8-bit digit radix
  select (the TPU's ``_minmax_select_kernel``);
* ``minmax_apply``: ``clamp((x - qmin) / (qmax - qmin), 0, 1) * mask`` (the
  TPU's ``_minmax_apply_kernel``).

Each wrapper takes the plain PyTorch version for CPU tensors only. For a CUDA
tensor it launches the kernel or raises; no other device is accepted. Every
kernel launch adds one to ``LAUNCHES[name]``, so a run can show that its
requests went through the kernels.
"""

from __future__ import annotations

import torch

from multimodal_alzheimer_tpu_torch.ops import _native
from multimodal_alzheimer_tpu_torch.ops.quantile import (
    interpolate,
    order_stats_rows,
)

LAUNCHES = {"minmax_select": 0, "minmax_apply": 0}

_MAX_QS = 8  # kMaxTargets in csrc/minmax_norm.cu


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _rows(volume: torch.Tensor, mask: torch.Tensor):
    """(B, N) contiguous float32 views of a (B, ...) volume and mask."""
    if volume.shape != mask.shape:
        raise ValueError(f"volume {tuple(volume.shape)} and mask "
                         f"{tuple(mask.shape)} differ in shape")
    if volume.device != mask.device:
        raise ValueError(f"volume on {volume.device}, mask on {mask.device}")
    b = volume.shape[0]
    return (volume.reshape(b, -1).to(torch.float32).contiguous(),
            mask.reshape(b, -1).to(torch.float32).contiguous())


def order_stats_plain(vol: torch.Tensor, mask: torch.Tensor,
                      qs: torch.Tensor):
    """Plain version of ``minmax_select``: a full sort of each row."""
    return order_stats_rows(vol * mask, qs)


def _order_stats_kernel(vol: torch.Tensor, mask: torch.Tensor,
                        qs: torch.Tensor):
    lib = _native.library()
    b, n = vol.shape
    n_qs = qs.numel()
    if not 1 <= n_qs <= _MAX_QS:
        raise ValueError(f"minmax_select takes 1 to {_MAX_QS} quantile "
                         f"levels, got {n_qs}")
    device = vol.device
    work = torch.empty(lib.minmax_select_workspace_words(b, n, n_qs),
                       dtype=torch.int32, device=device)
    out = torch.empty((b, 1 + 2 * n_qs), dtype=torch.int32, device=device)
    code = lib.minmax_select(
        vol.data_ptr(), mask.data_ptr(), qs.data_ptr(), b, n, n_qs,
        work.data_ptr(), out.data_ptr(), device.index,
        _native.stream(device))
    _native.check(code, "minmax_select")
    LAUNCHES["minmax_select"] += 1
    return (out[:, 0].to(torch.int64), _decode_keys(out[:, 1::2]),
            _decode_keys(out[:, 2::2]))


def _decode_keys(keys: torch.Tensor) -> torch.Tensor:
    """Inverse of the kernel's order-preserving float -> uint32 key map."""
    keys = keys.contiguous()
    bits = torch.where(keys < 0, keys & 0x7FFFFFFF, ~keys)
    return bits.view(torch.float32)


def order_stats(volume: torch.Tensor, mask: torch.Tensor,
                qs: tuple[float, ...]):
    """Per-scan ``(n, v_lo, v_hi)`` order statistics of ``{x*mask != 0}``.

    ``qs`` are formed in Python double and cast to float32, as in JAX.
    Returns the (B,) int64 valid counts and two (B, Q) float32 tensors.
    """
    vol, msk = _rows(volume, mask)
    qs_t = torch.tensor(qs, dtype=torch.float32, device=vol.device)
    if _native.on_cuda(vol):
        return _order_stats_kernel(vol, msk, qs_t)
    return order_stats_plain(vol, msk, qs_t)


def batched_masked_quantiles(volume: torch.Tensor, mask: torch.Tensor,
                             qs: tuple[float, ...]) -> torch.Tensor:
    """(B, Q) exact per-scan quantiles of the nonzero masked voxels.

    Matches ``torch.quantile(..., interpolation='linear')`` over each scan's
    ``{x*mask != 0}`` voxels; needs >= 2 valid voxels per scan for a
    meaningful result (a scan with none gives NaN).
    """
    n, v_lo, v_hi = order_stats(volume, mask, qs)
    qs_t = torch.tensor(qs, dtype=torch.float32, device=v_lo.device)
    return interpolate(n, v_lo, v_hi, qs_t)


def minmax_apply_plain(volume: torch.Tensor, mask: torch.Tensor,
                       qmin: torch.Tensor, qmax: torch.Tensor) -> torch.Tensor:
    """Plain version of ``minmax_apply`` on (B, ...) operands."""
    expand = (slice(None),) + (None,) * (volume.ndim - 1)
    out = (volume - qmin[expand]) / (qmax - qmin)[expand]
    return torch.clamp(out, 0.0, 1.0) * mask


def _minmax_apply_kernel(vol: torch.Tensor, mask: torch.Tensor,
                         qmin: torch.Tensor, qmax: torch.Tensor):
    lib = _native.library()
    b, n = vol.shape
    if qmin.shape != (b,) or qmax.shape != (b,):
        raise ValueError(f"qmin {tuple(qmin.shape)} and qmax "
                         f"{tuple(qmax.shape)} must both be ({b},)")
    q = torch.stack([qmin, qmax], dim=1).to(vol.device, torch.float32)
    out = torch.empty_like(vol)
    device = vol.device
    code = lib.minmax_apply(
        vol.data_ptr(), mask.data_ptr(), q.data_ptr(),
        out.data_ptr(), b, n, device.index,
        _native.stream(device))
    _native.check(code, "minmax_apply")
    LAUNCHES["minmax_apply"] += 1
    return out


def minmax_apply(volume: torch.Tensor, mask: torch.Tensor,
                 qmin: torch.Tensor, qmax: torch.Tensor) -> torch.Tensor:
    """``clamp((x - qmin) / (qmax - qmin), 0, 1) * mask`` with (B,) per-scan
    bounds, as float32 of the volume's shape."""
    vol, msk = _rows(volume, mask)
    if _native.on_cuda(vol):
        return _minmax_apply_kernel(vol, msk, qmin, qmax).reshape(
            volume.shape)
    return minmax_apply_plain(vol, msk, qmin.to(torch.float32),
                              qmax.to(torch.float32)).reshape(volume.shape)


def per_scan_minmax(volume: torch.Tensor, mask: torch.Tensor,
                    quantile: float = 0.99) -> torch.Tensor:
    """Quantile min-max normalisation of a (B, ...) batch, per scan.

    ``(x - Q(1-q)) / (Q(q) - Q(1-q))`` clamped to [0, 1] and re-masked
    (reference: dataloader.py:261-270), with exact quantiles.
    """
    quants = batched_masked_quantiles(volume, mask, (quantile, 1.0 - quantile))
    return minmax_apply(volume, mask, quants[:, 1], quants[:, 0])
