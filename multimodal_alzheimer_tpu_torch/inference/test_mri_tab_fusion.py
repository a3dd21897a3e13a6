"""Evaluate the stage-2 MRI+tabular fusion (reference
inference/test_mri_tab_fusion.py).

Port of ``multimodal_alzheimer_tpu/inference/test_mri_tab_fusion.py``. The
checkpoints named ``mri_tab_2_class`` and ``mri_tab_3_class`` in
``path_config.yaml`` are fusion checkpoint directories of the port; their
hparams name the stage-1 checkpoints ('path_mri', 'path_tabular'), and the
test split takes the MRI checkpoint's min-max percentile.

    python -m multimodal_alzheimer_tpu_torch.inference.test_mri_tab_fusion
"""

from __future__ import annotations

from multimodal_alzheimer_tpu_torch.inference.harness import (
    build_testset,
    evaluate,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.tabular_mri_fusion import (
    TabularMRIFusion,
)
from multimodal_alzheimer_tpu_torch.train.checkpoint import load_checkpoint
from multimodal_alzheimer_tpu_torch.train.driver import stage1_normalizations
from multimodal_alzheimer_tpu_torch.utils.path_config import load_path_config


def load_fusion(checkpoint_path: str):
    """(model, state_dict, hparams, MRI hparams); the state dict is not
    loaded into the model yet."""
    state_dict, hparams, _ = load_checkpoint(checkpoint_path)
    _, mri_hp, _ = load_checkpoint(hparams["path_mri"])
    _, tab_hp, _ = load_checkpoint(hparams["path_tabular"])
    model = TabularMRIFusion.from_hparams(hparams, mri_hp, tab_hp)
    return model, state_dict, hparams, mri_hp


def main(confusion_pngs: bool = True, device="cuda") -> dict:
    """Evaluate each MRI+tabular checkpoint the path registry names;
    returns {key: metrics}."""
    paths = load_path_config()
    results = {}
    for key, name in (("mri_tab_2_class", "test_set_mri_tab_2_class"),
                      ("mri_tab_3_class", "test_set_mri_tab_3_class")):
        if key in paths:
            model, state_dict, hparams, mri_hp = load_fusion(str(paths[key]))
            _, mri_n, q = stage1_normalizations(None, mri_hp)
            testset = build_testset(hparams, None, mri_n, q)
            results[key] = evaluate(model, state_dict, hparams, testset,
                                    name, confusion_pngs=confusion_pngs,
                                    device=device)
            print(key, results[key])
    return results


if __name__ == "__main__":
    main()
