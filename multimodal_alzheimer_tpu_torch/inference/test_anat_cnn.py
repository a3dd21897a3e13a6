"""Evaluate the MRI Med3D classifier (reference inference/test_anat_cnn.py):
per-scan quantile min-max at the checkpoint's ``norm_percentile``.

Port of ``multimodal_alzheimer_tpu/inference/test_anat_cnn.py``. The
checkpoints named ``mri_cnn_2_class`` and ``mri_cnn_3_class`` in
``path_config.yaml`` are checkpoint directories of the port
(``train/checkpoint.py``).

    python -m multimodal_alzheimer_tpu_torch.inference.test_anat_cnn
"""

from __future__ import annotations

from multimodal_alzheimer_tpu_torch.inference.harness import (
    evaluate_checkpoint,
)
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.utils.path_config import load_path_config


def _norms(hparams):
    return (None, {"per_scan_norm": "min_max"},
            float(hparams.get("norm_percentile", 0.99)))


def main(confusion_pngs: bool = True, device="cuda") -> dict:
    """Evaluate each MRI checkpoint the path registry names; returns
    {key: metrics}."""
    paths = load_path_config()
    results = {}
    for key, name in (("mri_cnn_2_class", "test_set_mri_2_class"),
                      ("mri_cnn_3_class", "test_set_mri_3_class")):
        if key in paths:
            results[key] = evaluate_checkpoint(
                AnatCNN.from_hparams, str(paths[key]), name,
                normalization_from=_norms, confusion_pngs=confusion_pngs,
                device=device)
            print(key, results[key])
    return results


if __name__ == "__main__":
    main()
