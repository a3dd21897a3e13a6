"""Labeled synthetic volumes for tests and card runs.

Port of ``make_labeled_volumes`` and ``ArrayDataset`` from
``multimodal_alzheimer_tpu/data/synthetic.py:94-163``: the same numpy draws
from the same seed, so both packages see the same data.
"""

from __future__ import annotations

import numpy as np


def make_labeled_volumes(n: int,
                         shape=(91, 109, 91),
                         n_classes: int = 3,
                         seed: int = 0,
                         contrast: float = 0.8,
                         contrast_jitter: float = 0.0,
                         modalities=("mri",),
                         tabular_dim: int = 9) -> dict:
    """Labeled synthetic volumes with a learnable class signal.

    Class k brightens the k-th axial slab of the volume by
    ``1 + contrast``: a spatial pattern that survives the per-scan
    normalisation, where a global mean shift would not. A per-sample
    contrast jitter makes some samples ambiguous.

    Returns a dict of stacked arrays: ``label`` plus, per requested
    modality, ``mri``+``mri_mask`` (ADNI-like intensities ~N(900,200)),
    ``pet1451`` (~N(0.5, 0.25)), and/or ``tabular`` ((n, tabular_dim),
    class-shifted means).
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    out = {"label": labels}
    slabs = np.array_split(np.arange(shape[0]), n_classes)
    per_sample = np.clip(
        rng.normal(contrast, contrast_jitter, n), 0.0, None)

    def brighten(vols):
        for i, k in enumerate(labels):
            vols[i, slabs[k]] *= 1.0 + per_sample[i]
        return vols

    if "mri" in modalities:
        mri = np.abs(rng.normal(900, 200, (n,) + shape)).astype(np.float32)
        out["mri"] = brighten(mri)
        out["mri_mask"] = (rng.random((n,) + shape) > 0.35).astype(
            np.float32)
    if "pet1451" in modalities:
        pet = rng.normal(0.5, 0.25, (n,) + shape).astype(np.float32)
        out["pet1451"] = brighten(pet)
    if "tabular" in modalities:
        tab = rng.normal(size=(n, tabular_dim)).astype(np.float32)
        out["tabular"] = tab + labels[:, None].astype(np.float32)
    return out


class ArrayDataset:
    """Indexable dataset over ``make_labeled_volumes``-style stacked
    arrays (what ``data.pipeline.DataLoader`` consumes)."""

    def __init__(self, data: dict):
        self.data = data
        self.n = len(data["label"])

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.data.items()}
