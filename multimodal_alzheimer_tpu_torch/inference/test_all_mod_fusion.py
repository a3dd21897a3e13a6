"""Evaluate the stage-3 all-modalities fusion (reference
inference/test_all_mod_fusion.py).

Port of ``multimodal_alzheimer_tpu/inference/test_all_mod_fusion.py``. The
checkpoints named ``all_mod_2_class`` and ``all_mod_3_class`` in
``path_config.yaml`` are stage-3 checkpoint directories of the port; their
hparams name the stage-2 and stage-1 checkpoints, whose hparams rebuild the
sub-models and whose normalisations the test split takes.

    python -m multimodal_alzheimer_tpu_torch.inference.test_all_mod_fusion
"""

from __future__ import annotations

from multimodal_alzheimer_tpu_torch.inference.harness import (
    build_testset,
    evaluate,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.all_modalities_fusion import (
    AllModalitiesFusion,
)
from multimodal_alzheimer_tpu_torch.train.checkpoint import (
    assert_tower_duplicates_equal,
    load_checkpoint,
)
from multimodal_alzheimer_tpu_torch.train.driver import stage1_normalizations
from multimodal_alzheimer_tpu_torch.utils.path_config import load_path_config


def load_fusion(checkpoint_path: str):
    """(model, state_dict, hparams, PET hparams, MRI hparams); the state
    dict is not loaded into the model yet. A model that shares its towers
    refuses a checkpoint whose duplicate towers differ from their canonical
    copies (towers trained unfrozen): sharing reads only the canonical
    copies and would change its predictions."""
    state_dict, hparams, _ = load_checkpoint(checkpoint_path)
    sub_hparams = [load_checkpoint(hparams[key])[1] for key in (
        "path_anat_pet", "path_anat_tab", "path_pet_tab", "path_pet",
        "path_mri", "path_tabular")]
    model = AllModalitiesFusion.from_hparams(hparams, *sub_hparams)
    if model.share_towers:
        assert_tower_duplicates_equal(state_dict)
    return model, state_dict, hparams, sub_hparams[3], sub_hparams[4]


def main(confusion_pngs: bool = True, device="cuda") -> dict:
    """Evaluate each stage-3 checkpoint the path registry names; returns
    {key: metrics}."""
    paths = load_path_config()
    results = {}
    for key, name in (("all_mod_2_class", "test_set_all_mod_2_class"),
                      ("all_mod_3_class", "test_set_all_mod_3_class")):
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
