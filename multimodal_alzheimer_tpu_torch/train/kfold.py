"""Patient-level k-fold cross-validation loop.

Port of ``multimodal_alzheimer_tpu/train/kfold.py`` with the same numpy
draws, so a seed gives the JAX package's folds. Equivalent of the
reference's (outdated) Lightning KFold custom loop (reference:
pkg/utils/outdated/kfold.py): split patient IDs into k folds, train a fresh
model per fold with the standard driver, and aggregate the per-fold
validation metrics.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def patient_kfold_indices(ids, k: int = 5, seed: int = 0):
    """Yield (train_ids, val_ids) per fold; split by unique patient so no
    subject leaks across folds (DataSplit.py's invariant)."""
    unique = np.asarray(sorted(set(ids)))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(unique))
    folds = np.array_split(perm, k)
    for i in range(k):
        val_ids = set(unique[folds[i]])
        train_ids = set(unique) - val_ids
        yield train_ids, val_ids


def run_kfold(train_fold_fn: Callable, ids, k: int = 5, seed: int = 0):
    """Run ``train_fold_fn(train_ids, val_ids, fold_index) -> metrics dict``
    per fold and return the list plus mean/std of shared scalar metrics."""
    results = []
    for fold, (train_ids, val_ids) in enumerate(
            patient_kfold_indices(ids, k, seed)):
        results.append(train_fold_fn(train_ids, val_ids, fold))
    summary = {}
    if results and isinstance(results[0], dict):
        for key in results[0]:
            values = [r[key] for r in results
                      if isinstance(r.get(key), (int, float))]
            if len(values) == len(results):
                summary[f"{key}_mean"] = float(np.mean(values))
                summary[f"{key}_std"] = float(np.std(values))
    return results, summary
