"""Decision-tree tabular baseline (reference decision_tree.py parity).

Port of ``multimodal_alzheimer_tpu/models/tabular_models/decision_tree.py``:
a host-side sklearn model, as in the reference
(pkg/models/tabular_models/decision_tree.py:1-61): gini criterion,
max_depth 5, class weights from the label distribution; and the MCI probe
(the class fractions a binary CN/Dementia tree gives MCI rows). sklearn is
imported inside ``train_decision_tree``: the card's machine has none.
"""

from __future__ import annotations

import numpy as np


def train_decision_tree(features: np.ndarray, labels: np.ndarray,
                        class_weight: dict | None = None,
                        max_depth: int = 5):
    from sklearn.tree import DecisionTreeClassifier

    clf = DecisionTreeClassifier(criterion="gini", max_depth=max_depth,
                                 class_weight=class_weight, random_state=0)
    clf.fit(features, labels)
    return clf


def predict_mci(clf, mci_features: np.ndarray) -> np.ndarray:
    """Class fractions a binary CN/Dementia tree assigns to MCI samples."""
    preds = clf.predict(mci_features)
    return np.bincount(preds.astype(int), minlength=2) / max(len(preds), 1)
