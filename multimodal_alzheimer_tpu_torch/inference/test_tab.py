"""Evaluate the tabular models (reference inference/test_tab.py, which wraps
TabPFN with hard-coded class weights :25-40; here the TabularMLP checkpoint
carries its weights in its hparams).

Port of ``multimodal_alzheimer_tpu/inference/test_tab.py``. A TabPFN
checkpoint (``tabpfn_{2,3}_class`` in ``path_config.yaml``: a port
checkpoint directory holding a ``TabPFNTransformer`` state dict, e.g. the
reference's ``tabular_baseline.pth`` through ``convert_state_dict``) is
refit in context on the train split, as the reference reloads it
(tabular_models/dl_approach.py:67-70 refits the classifier on the train
CSV), then scored with the shared test protocol: bootstrap F1/MCC with CIs
and the confusion counts (base_model.py:135-239). The bootstrap draws from
a ``torch.Generator`` seeded 5, where JAX splits ``PRNGKey(5)``.

    python -m multimodal_alzheimer_tpu_torch.inference.test_tab
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from multimodal_alzheimer_tpu_torch.data.dataset import MultiModalDataset
from multimodal_alzheimer_tpu_torch.inference.harness import (
    evaluate_checkpoint,
)
from multimodal_alzheimer_tpu_torch.metrics.bootstrap import bootstrap_metric
from multimodal_alzheimer_tpu_torch.metrics.classification import (
    confusion_matrix,
    f1_macro,
    matthews_corrcoef,
    predictions_from_logits,
)
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabpfn import (
    TabPFNClassifier,
    model_from_state_dict,
)
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp import (
    TabularMLP,
)
from multimodal_alzheimer_tpu_torch.train.checkpoint import load_checkpoint
from multimodal_alzheimer_tpu_torch.train.loop import LABEL_NAMES
from multimodal_alzheimer_tpu_torch.utils.path_config import load_path_config
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator


def _split_xy(csv_path: str, binary: bool):
    """(features (N, 9) float32, labels (N,)) of a split's tabular rows."""
    ds = MultiModalDataset(path=str(csv_path), modalities=["tabular"],
                           binary_classification=binary)
    x = np.stack([ds[i]["tabular"] for i in range(len(ds))])
    y = np.asarray([int(ds[i]["label"]) for i in range(len(ds))])
    return x.astype(np.float32), y


def evaluate_tabpfn(checkpoint_path: str, experiment_name: str,
                    n_classes: int, ensemble_size: int = 4,
                    n_bootstrap: int = 1000, out_dir: str | None = None,
                    train_csv: str | None = None,
                    test_csv: str | None = None,
                    confusion_pngs: bool = True, device="cuda") -> dict:
    """Test-protocol evaluation of a TabPFN checkpoint, refit in context on
    the train split. With ``out_dir``, the confusion counts go to
    ``confusion_matrix.json`` there and, with ``confusion_pngs``, the three
    confusion-matrix PNGs (which need the plotting packages)."""
    state_dict, hparams, _ = load_checkpoint(checkpoint_path)
    paths = None
    if train_csv is None or test_csv is None:
        paths = load_path_config()
    train_csv = train_csv or str(paths["train_set_csv"])
    test_csv = test_csv or str(paths["test_set_csv"])
    binary = n_classes == 2
    x_tr, y_tr = _split_xy(train_csv, binary)
    x_te, y_te = _split_xy(test_csv, binary)

    clf = TabPFNClassifier(state_dict=state_dict,
                           model=model_from_state_dict(state_dict),
                           ensemble_size=ensemble_size, device=device)
    clf.fit(x_tr, y_tr)
    if len(clf.classes_) != n_classes:
        raise ValueError(f"train split has {len(clf.classes_)} classes, "
                         f"expected {n_classes}")
    probs = clf.predict_proba(x_te)
    logits = torch.from_numpy(np.log(np.maximum(probs, 1e-9)))
    labels = torch.from_numpy(y_te)

    generator = make_generator(5)
    f1_mean, f1_ci = bootstrap_metric(f1_macro, logits, labels, n_classes,
                                      generator, n_bootstrap)
    mcc_mean, mcc_ci = bootstrap_metric(matthews_corrcoef, logits, labels,
                                        n_classes, generator, n_bootstrap)
    cm = confusion_matrix(predictions_from_logits(logits), labels, n_classes)
    scalars = {
        "test_f1_epoch": float(f1_macro(cm)),
        "test_f1_epoch_boot": float(f1_mean),
        "test_f1_epoch_ci": float(f1_ci),
        "test_mcc_epoch_boot": float(mcc_mean),
        "test_mcc_epoch_ci": float(mcc_ci),
        "tabular_baseline_F1": float(hparams.get("tabular_baseline_F1",
                                                 float("nan"))),
    }
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        counts = cm.numpy().astype(np.int64)
        with open(os.path.join(out_dir, "confusion_matrix.json"), "w") as f:
            json.dump({"labels": LABEL_NAMES[n_classes],
                       "counts": counts.tolist()}, f, indent=2)
        if confusion_pngs:
            from multimodal_alzheimer_tpu_torch.metrics.confusion_plot import (
                save_confusion_matrix_pngs,
            )

            save_confusion_matrix_pngs(counts, LABEL_NAMES[n_classes],
                                       out_dir)
        print(experiment_name, scalars)
    return scalars


def main(confusion_pngs: bool = True, device="cuda") -> dict:
    """Evaluate each tabular checkpoint the path registry names: the MLPs
    through the shared harness, TabPFN refit on the train split; returns
    {key: metrics}."""
    paths = load_path_config()
    results = {}
    for key, name in (("tabular_mlp_2_class", "test_set_tab_2_class"),
                      ("tabular_mlp_3_class", "test_set_tab_3_class")):
        if key in paths:
            results[key] = evaluate_checkpoint(
                TabularMLP.from_hparams, str(paths[key]), name,
                confusion_pngs=confusion_pngs, device=device)
            print(key, results[key])
    for key, n_classes in (("tabpfn_2_class", 2), ("tabpfn_3_class", 3)):
        if key in paths:
            results[key] = evaluate_tabpfn(
                str(paths[key]), f"test_set_tabpfn_{n_classes}_class",
                n_classes, confusion_pngs=confusion_pngs, device=device)
            print(key, results[key])
    return results


if __name__ == "__main__":
    main()
