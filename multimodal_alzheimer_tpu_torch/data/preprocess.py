"""Batch preprocessing on the device: raw batch dict -> model inputs.

Port of ``MultiModalDataset.get_device_preprocess``
(``multimodal_alzheimer_tpu/data/dataset.py``) as a plain function, so the
serving path needs neither pandas nor the dataset class.
"""

from __future__ import annotations

import torch

from multimodal_alzheimer_tpu_torch.ops.normalization import (
    batched_normalize_mri,
    normalize_pet as _normalize_pet,
)


def make_device_preprocess(normalize_pet: dict | None = None,
                           normalize_mri: dict | None = None,
                           quantile: float = 0.99):
    """Return ``preprocess(batch) -> batch`` for tensors on any device.

    It maps {'pet1451': (B,...), 'mri': (B,...), 'mri_mask': (B,...),
    'mri_qminmax': (B, 2), ...} to the same dict with normalised volumes;
    'mri_mask' and 'mri_qminmax' are consumed. Half-width volumes are
    upcast to float32 before any arithmetic.
    """
    def preprocess(batch: dict) -> dict:
        out = dict(batch)
        for k in ("pet1451", "mri", "mri_mask"):
            if k in out and out[k].dtype != torch.float32:
                out[k] = out[k].to(torch.float32)
        if "pet1451" in out and normalize_pet:
            out["pet1451"] = _normalize_pet(
                out["pet1451"], normalize_pet["mean"], normalize_pet["std"])
        qminmax = out.pop("mri_qminmax", None)
        if "mri" in out and normalize_mri:
            out["mri"] = batched_normalize_mri(
                out["mri"], out.pop("mri_mask", None), normalize_mri,
                quantile, qminmax=qminmax)
        out.pop("mri_mask", None)
        return out

    return preprocess
