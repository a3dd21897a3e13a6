"""Evaluate early fusion under the all-scan MRI z-score (reference
inference/test_early_fusion_samenorm.py:15-18).

Port of ``multimodal_alzheimer_tpu/inference/test_early_fusion_samenorm.py``.
The checkpoint named ``early_fusion_same_norm_2_class`` in
``path_config.yaml`` is a checkpoint directory of the port; its PET
z-score constants come from its hparams, the MRI statistics from
``train_early_fusion.MRI_ALL_SCAN_STATS``.

    python -m multimodal_alzheimer_tpu_torch.inference.test_early_fusion_samenorm
"""

from __future__ import annotations

from multimodal_alzheimer_tpu_torch.inference.harness import (
    evaluate_checkpoint,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.early_fusion import (
    PETMRIEarlyFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.train_early_fusion import (
    MRI_ALL_SCAN_STATS,
)
from multimodal_alzheimer_tpu_torch.utils.path_config import load_path_config


def _norms(hparams):
    return ({"mean": float(hparams["norm_mean"]),
             "std": float(hparams["norm_std"])},
            {"all_scan_norm": MRI_ALL_SCAN_STATS[hparams["n_classes"]]},
            0.99)


def main(confusion_pngs: bool = True, device="cuda") -> dict:
    """Evaluate the checkpoint the path registry names; returns {key:
    metrics}."""
    paths = load_path_config()
    results = {}
    key = "early_fusion_same_norm_2_class"
    if key in paths:
        results[key] = evaluate_checkpoint(
            PETMRIEarlyFusion.from_hparams, str(paths[key]),
            "test_set_early_fusion_samenorm", normalization_from=_norms,
            confusion_pngs=confusion_pngs, device=device)
        print(key, results[key])
    return results


if __name__ == "__main__":
    main()
