"""Evaluate feature-map fusion, maxout and concatenate variants (reference
inference/test_featuremap_fusion.py:40-49).

Port of ``multimodal_alzheimer_tpu/inference/test_featuremap_fusion.py``.
The checkpoints named ``featuremap_fusion_maxout_2_class`` and
``featuremap_fusion_concat_2_class`` in ``path_config.yaml`` are
checkpoint directories of the port; the PET z-score constants come from
their hparams, the MRI statistics from
``train_early_fusion.MRI_ALL_SCAN_STATS``.

    python -m multimodal_alzheimer_tpu_torch.inference.test_featuremap_fusion
"""

from __future__ import annotations

from multimodal_alzheimer_tpu_torch.inference.harness import (
    evaluate_checkpoint,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.featuremap_fusion import (
    PETMRIFeatureMapFusion,
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
    """Evaluate each checkpoint the path registry names; returns {key:
    metrics}."""
    paths = load_path_config()
    results = {}
    for key, name in (
            ("featuremap_fusion_maxout_2_class", "test_set_fmf_maxout"),
            ("featuremap_fusion_concat_2_class", "test_set_fmf_concat")):
        if key in paths:
            results[key] = evaluate_checkpoint(
                PETMRIFeatureMapFusion.from_hparams, str(paths[key]), name,
                normalization_from=_norms, confusion_pngs=confusion_pngs,
                device=device)
            print(key, results[key])
    return results


if __name__ == "__main__":
    main()
