"""Evaluate the stage-2 PET+MRI fusion (reference
inference/test_anat_pet_fusion.py: fusion checkpoint and stage-1 paths from
path_config :30-43).

Port of ``multimodal_alzheimer_tpu/inference/test_anat_pet_fusion.py``. The
checkpoints named ``pet_mri_2_class`` and ``pet_mri_3_class`` in
``path_config.yaml`` are fusion checkpoint directories of the port; their
hparams name the stage-1 checkpoints ('path_pet', 'path_mri'), whose
normalisations the test split takes.

    python -m multimodal_alzheimer_tpu_torch.inference.test_anat_pet_fusion
"""

from __future__ import annotations

from multimodal_alzheimer_tpu_torch.inference.harness import (
    build_testset,
    evaluate,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.anat_pet_fusion import (
    AnatPETFusion,
)
from multimodal_alzheimer_tpu_torch.train.checkpoint import load_checkpoint
from multimodal_alzheimer_tpu_torch.train.driver import stage1_normalizations
from multimodal_alzheimer_tpu_torch.utils.path_config import load_path_config


def load_fusion(checkpoint_path: str):
    """(model, state_dict, hparams, PET hparams, MRI hparams); the state
    dict is not loaded into the model yet."""
    state_dict, hparams, _ = load_checkpoint(checkpoint_path)
    _, pet_hp, _ = load_checkpoint(hparams["path_pet"])
    _, mri_hp, _ = load_checkpoint(hparams["path_mri"])
    model = AnatPETFusion.from_hparams(hparams, pet_hp, mri_hp)
    return model, state_dict, hparams, pet_hp, mri_hp


def main(confusion_pngs: bool = True, device="cuda") -> dict:
    """Evaluate each PET+MRI checkpoint the path registry names; returns
    {key: metrics}."""
    paths = load_path_config()
    results = {}
    for key, name in (("pet_mri_2_class", "test_set_pet_mri_2_class"),
                      ("pet_mri_3_class", "test_set_pet_mri_3_class")):
        if key in paths:
            model, state_dict, hparams, pet_hp, mri_hp = load_fusion(
                str(paths[key]))
            pet_n, mri_n, q = stage1_normalizations(pet_hp, mri_hp)
            testset = build_testset(hparams, pet_n, mri_n, q)
            results[key] = evaluate(model, state_dict, hparams, testset,
                                    name, confusion_pngs=confusion_pngs,
                                    device=device)
            print(key, results[key])
    return results


if __name__ == "__main__":
    main()
