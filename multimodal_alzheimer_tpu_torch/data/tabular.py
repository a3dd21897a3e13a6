"""Tabular clinical features (reference dataloader.py:291-308).

Port of ``multimodal_alzheimer_tpu/data/tabular.py``. The 9-feature vector
order is ``[AGE, PTEDUCAT, Ventricles, Hippocampus, WholeBrain, Entorhinal,
Fusiform, MidTemp, ICV]``.

Reference quirk (dataloader.py:301): ``whole_brain = sample['PTEDUCAT']``
duplicates the education feature instead of reading ``WholeBrain``. It is
kept by default (``compat_whole_brain_bug=True``) so the tabular models see
what the reference's saw; pass False for the corrected vector.
"""

from __future__ import annotations

import numpy as np

TABULAR_FEATURES = ("AGE", "PTEDUCAT", "Ventricles", "Hippocampus",
                    "WholeBrain", "Entorhinal", "Fusiform", "MidTemp", "ICV")


def tabular_vector(sample, compat_whole_brain_bug: bool = True) -> np.ndarray:
    """The 9-float feature vector of a manifest row (any mapping)."""
    names = list(TABULAR_FEATURES)
    if compat_whole_brain_bug:
        names[4] = "PTEDUCAT"
    return np.array([sample[k] for k in names], dtype=np.float32)
