"""Exact quantiles over the nonzero-masked voxel set (plain PyTorch).

Same semantics as ``multimodal_alzheimer_tpu.ops.quantile``: masking
multiplies the volume by the mask and then drops *all* zeros, invalid voxels
sort to the tail as +inf, and the rank arithmetic is f32
(``rank = q*(n-1)``, ``lo = floor(rank)``, ``hi = min(lo+1, n-1)``,
``v_lo + frac*(v_hi - v_lo)``), matching
``torch.quantile(values, q, interpolation='linear')``.

The row functions work on a (B, N) batch of flattened masked volumes; they
are the plain version the radix-select kernel (``ops/hopper_norm.py``) is
held against, and share :func:`interpolate` with it, so equal order
statistics give bit-equal quantiles.
"""

from __future__ import annotations

import numpy as np
import torch


def order_stats_rows(vals: torch.Tensor, qs: torch.Tensor):
    """Per-row sorted[lo] and sorted[min(lo+1, n-1)] of the nonzero entries.

    Args:
      vals: (B, N) float32 masked values; zeros are invalid.
      qs: (Q,) float32 quantile levels on the same device.

    Returns:
      ``(n, v_lo, v_hi)``: (B,) int64 valid counts and two (B, Q) float32
      order statistics. A row with no valid entry gives +inf.
    """
    valid = vals != 0
    inf = torch.tensor(float("inf"), dtype=vals.dtype, device=vals.device)
    sorted_vals = torch.sort(torch.where(valid, vals, inf), dim=1).values
    n = valid.sum(dim=1)
    last = vals.shape[1] - 1
    rank = qs[None, :] * (n - 1).to(torch.float32)[:, None]
    lo = torch.floor(rank).to(torch.int64).clamp(0, last)
    hi = (lo + 1).clamp(max=last)
    v_lo = torch.gather(sorted_vals, 1, lo)
    v_hi = torch.where(hi < n[:, None], torch.gather(sorted_vals, 1, hi), v_lo)
    return n, v_lo, v_hi


def interpolate(n: torch.Tensor, v_lo: torch.Tensor, v_hi: torch.Tensor,
                qs: torch.Tensor) -> torch.Tensor:
    """Linear interpolation between the order statistics, in f32."""
    rank = qs[None, :] * (n - 1).to(torch.float32)[:, None]
    frac = rank - torch.floor(rank)
    return v_lo + frac * (v_hi - v_lo)


def masked_nonzero_quantile(volume: torch.Tensor, mask: torch.Tensor | None,
                            qs: tuple[float, ...]):
    """Exact linear-interpolation quantiles of one scan's nonzero voxels.

    Args:
      volume: any-shape float tensor (one scan).
      mask: optional binary mask, same shape (1 = keep voxel).
      qs: quantile levels in [0, 1], cast to float32 as JAX does.

    Returns:
      ``(quantiles, v_lo, v_hi)``: three (Q,) tensors, the quantiles and the
      two order statistics they interpolate between.
    """
    vals = volume.reshape(1, -1).to(torch.float32)
    if mask is not None:
        vals = vals * mask.reshape(1, -1).to(torch.float32)
    qs_t = torch.tensor(qs, dtype=torch.float32, device=vals.device)
    n, v_lo, v_hi = order_stats_rows(vals, qs_t)
    return interpolate(n, v_lo, v_hi, qs_t)[0], v_lo[0], v_hi[0]


def host_masked_nonzero_quantile(volume: np.ndarray,
                                 mask: np.ndarray | None,
                                 qs) -> np.ndarray:
    """numpy twin of :func:`masked_nonzero_quantile` for host-side memoing.

    Port of JAX ``ops/quantile.py:host_masked_nonzero_quantile``: exact
    selection by one shared ``np.partition`` over every requested order
    statistic, with the same f32 rank arithmetic as the device paths, so
    the memoised bounds equal the radix-select kernel's order statistics
    bit for bit and its interpolated quantiles to about 1 ulp. The dataset
    (``data/dataset.py``) computes each sample's min-max bounds once with
    it.
    """
    vals = volume.astype(np.float32, copy=False).ravel()
    if mask is not None:
        vals = vals * mask.astype(np.float32, copy=False).ravel()
    vals = vals[vals != 0.0]
    n = vals.size
    if n < 2:
        raise ValueError(f"need >= 2 valid voxels, got {n}")
    ranks = [np.float32(q) * np.float32(n - 1) for q in qs]
    los = [int(np.floor(r)) for r in ranks]
    his = [min(lo + 1, n - 1) for lo in los]
    part = np.partition(vals, sorted(set(los + his)))
    out = np.empty(len(qs), np.float32)
    for i, (rank, lo, hi) in enumerate(zip(ranks, los, his)):
        frac = np.float32(rank) - np.float32(lo)
        out[i] = part[lo] + frac * (part[hi] - part[lo])
    return out


def masked_nonzero_mean_std(volume: torch.Tensor, mask: torch.Tensor | None):
    """Mean and Bessel-corrected std of one scan's nonzero masked voxels.

    Two passes, as ``torch.std_mean`` over the same value set.
    """
    vals = volume.reshape(-1)
    if mask is not None:
        vals = vals * mask.reshape(-1)
    valid = vals != 0
    n = valid.sum().to(vals.dtype)
    mean = torch.where(valid, vals, 0).sum() / n
    sq = torch.where(valid, (vals - mean) ** 2, 0)
    var = sq.sum() / torch.clamp(n - 1, min=1)
    return mean, torch.sqrt(var)
