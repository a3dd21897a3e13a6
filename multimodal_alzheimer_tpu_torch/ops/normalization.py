"""On-device volume normalisation (PyTorch port of ``ops/normalization.py``).

Supported modes (reference dataloader.py parity):
  * PET: z-score with train-split global stats (dataloader.py:213-217),
  * MRI 'per_scan_norm'='normalize': per-scan z-score over nonzero brain
    voxels, then re-masked (dataloader.py:252-260),
  * MRI 'per_scan_norm'='min_max': quantile min-max into [0,1] with clamping,
    then re-masked (dataloader.py:261-270),
  * MRI 'all_scan_norm': z-score with precomputed split stats
    (dataloader.py:274-278), which ``compute_split_stats`` estimates.

The batched per-scan modes (min-max and z-score) go through the Hopper
kernels of ``ops/hopper_norm`` on CUDA tensors and through their plain
versions on CPU tensors.
"""

from __future__ import annotations

import torch

from multimodal_alzheimer_tpu_torch.ops import hopper_norm
from multimodal_alzheimer_tpu_torch.ops.quantile import (
    masked_nonzero_mean_std,
    masked_nonzero_quantile,
)

_PER_SCAN_ERROR = ('If you want to normalize per scan you have to pass '
                   'either "normalize" or "min_max"')
_KEYS_ERROR = ('If you use the argument "normalize_mri" only '
               '"per_scan_norm" or "all_scan_norm" are allowed as keys!')


def zscore_normalize(volume: torch.Tensor, mean, std) -> torch.Tensor:
    """(x - mean) / std — torchvision.Normalize semantics on a volume."""
    return (volume - mean) / std


def normalize_pet(volume: torch.Tensor, mean: float,
                  std: float) -> torch.Tensor:
    """PET z-score with train-split constants (e.g. 0.5145/0.5383)."""
    return zscore_normalize(volume, mean, std)


def mri_per_scan_zscore(volume: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Per-scan z-score over nonzero brain voxels, re-masked afterwards."""
    mean, std = masked_nonzero_mean_std(volume, mask)
    return zscore_normalize(volume, mean, std) * mask


def mri_per_scan_minmax(volume: torch.Tensor, mask: torch.Tensor,
                        quantile: float = 0.99) -> torch.Tensor:
    """Quantile min-max into [0,1] over one scan's nonzero voxels, re-masked.

    quant_max = Q(q), quant_min = Q(1-q); scale, clamp, re-mask.
    """
    quants, _, _ = masked_nonzero_quantile(volume, mask,
                                           (quantile, 1.0 - quantile))
    quant_max, quant_min = quants[0], quants[1]
    out = (volume - quant_min) / (quant_max - quant_min)
    return torch.clamp(out, 0.0, 1.0) * mask


def normalize_mri(volume: torch.Tensor, mask: torch.Tensor | None,
                  normalize_mri_cfg: dict | None,
                  quantile: float = 0.99) -> torch.Tensor:
    """Dispatch on the reference's ``normalize_mri`` config dict (one scan).

    Config shapes: {'per_scan_norm': 'normalize'} |
    {'per_scan_norm': 'min_max'} | {'all_scan_norm': {'mean': m, 'std': s}}
    | None.
    """
    if normalize_mri_cfg is None:
        return volume
    if len(normalize_mri_cfg) != 1:
        raise ValueError(_KEYS_ERROR)
    if "per_scan_norm" in normalize_mri_cfg:
        mode = normalize_mri_cfg["per_scan_norm"]
        if mode == "normalize":
            return mri_per_scan_zscore(volume, mask)
        if mode == "min_max":
            _check_quantile(quantile)
            return mri_per_scan_minmax(volume, mask, quantile)
        raise ValueError(_PER_SCAN_ERROR)
    if "all_scan_norm" in normalize_mri_cfg:
        stats = normalize_mri_cfg["all_scan_norm"]
        return zscore_normalize(volume, stats["mean"], stats["std"])
    raise ValueError(_KEYS_ERROR)


def _check_quantile(quantile: float) -> None:
    if not 0.0 <= quantile <= 1.0:
        raise ValueError(f"quantile must lie in [0, 1], got {quantile}")


def batched_mri_per_scan_minmax(volume: torch.Tensor, mask: torch.Tensor,
                                quantile: float = 0.99) -> torch.Tensor:
    """Batched quantile min-max, the production MRI path: exact quantiles
    from the radix-select kernel and the fused apply kernel on the card."""
    return hopper_norm.per_scan_minmax(volume, mask, quantile)


def batched_minmax_apply(volume: torch.Tensor, mask: torch.Tensor,
                         qmin: torch.Tensor,
                         qmax: torch.Tensor) -> torch.Tensor:
    """(x - qmin)/(qmax - qmin) -> clamp [0,1] -> remask with given (B,)
    memoised per-scan quantiles: the apply kernel alone, with no select."""
    return hopper_norm.minmax_apply(volume, mask, qmin, qmax)


def batched_normalize_mri(volume: torch.Tensor, mask: torch.Tensor | None,
                          normalize_mri_cfg: dict | None,
                          quantile: float = 0.99,
                          qminmax: torch.Tensor | None = None) -> torch.Tensor:
    """Batch-level ``normalize_mri`` dispatch over a (B, ...) volume batch.

    normalize takes the z-score kernel for the whole batch; min_max takes
    the min-max kernels' path, or, when ``qminmax`` (B, 2)
    [Q(1-q), Q(q)] memoised per-scan quantiles are supplied, skips the
    selection entirely.
    """
    if normalize_mri_cfg is None:
        return volume
    if len(normalize_mri_cfg) != 1:
        raise ValueError(_KEYS_ERROR)
    if mask is None:
        mask = torch.ones_like(volume)
    if "per_scan_norm" in normalize_mri_cfg:
        mode = normalize_mri_cfg["per_scan_norm"]
        if mode == "normalize":
            return hopper_norm.per_scan_zscore(volume, mask)
        if mode == "min_max":
            _check_quantile(quantile)
            if qminmax is not None:
                return batched_minmax_apply(volume, mask,
                                            qminmax[:, 0], qminmax[:, 1])
            return batched_mri_per_scan_minmax(volume, mask, quantile)
        raise ValueError(_PER_SCAN_ERROR)
    if "all_scan_norm" in normalize_mri_cfg:
        stats = normalize_mri_cfg["all_scan_norm"]
        return zscore_normalize(volume, stats["mean"], stats["std"])
    raise ValueError(_KEYS_ERROR)


def compute_split_stats(volumes_iter) -> tuple[float, float]:
    """Streaming split-level mean/std over an iterable of volumes.

    Port of ``ops/normalization.py:171-192`` (reference
    pkg/utils/standardization.py:34-55): accumulates per-scan means of x
    and x**2 in float32, then ``std = sqrt(E[mean_x2] - mean**2)`` (a
    mean-of-means estimator, not a true pooled std, reproduced as it is:
    the reference's published constants were computed this way). Each
    volume is taken as float32, as JAX takes it with 64-bit mode off.
    """
    mean_x = torch.zeros((), dtype=torch.float32)
    mean_x2 = torch.zeros((), dtype=torch.float32)
    count = torch.zeros((), dtype=torch.float32)
    for vol in volumes_iter:
        vol = torch.as_tensor(vol).to(torch.float32)
        mean_x = mean_x + vol.mean()
        mean_x2 = mean_x2 + (vol * vol).mean()
        count = count + 1
    mean = mean_x / count
    std = torch.sqrt(mean_x2 / count - mean * mean)
    return float(mean), float(std)
