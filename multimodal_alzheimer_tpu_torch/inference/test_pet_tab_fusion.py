"""Evaluate the stage-2 PET+tabular fusion (reference
inference/test_pet_tab_fusion.py).

Port of ``multimodal_alzheimer_tpu/inference/test_pet_tab_fusion.py``. The
checkpoints named ``pet_tab_2_class`` and ``pet_tab_3_class`` in
``path_config.yaml`` are fusion checkpoint directories of the port; their
hparams name the stage-1 checkpoints ('path_pet', 'path_tabular'), and the
test split takes the PET checkpoint's z-score constants.

    python -m multimodal_alzheimer_tpu_torch.inference.test_pet_tab_fusion
"""

from __future__ import annotations

from multimodal_alzheimer_tpu_torch.inference.harness import (
    build_testset,
    evaluate,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.pet_tabular_fusion import (
    PETTabularFusion,
)
from multimodal_alzheimer_tpu_torch.train.checkpoint import load_checkpoint
from multimodal_alzheimer_tpu_torch.train.driver import stage1_normalizations
from multimodal_alzheimer_tpu_torch.utils.path_config import load_path_config


def load_fusion(checkpoint_path: str):
    """(model, state_dict, hparams, PET hparams); the state dict is not
    loaded into the model yet."""
    state_dict, hparams, _ = load_checkpoint(checkpoint_path)
    _, pet_hp, _ = load_checkpoint(hparams["path_pet"])
    _, tab_hp, _ = load_checkpoint(hparams["path_tabular"])
    model = PETTabularFusion.from_hparams(hparams, pet_hp, tab_hp)
    return model, state_dict, hparams, pet_hp


def main(confusion_pngs: bool = True, device="cuda") -> dict:
    """Evaluate each PET+tabular checkpoint the path registry names;
    returns {key: metrics}."""
    paths = load_path_config()
    results = {}
    for key, name in (("pet_tab_2_class", "test_set_pet_tab_2_class"),
                      ("pet_tab_3_class", "test_set_pet_tab_3_class")):
        if key in paths:
            model, state_dict, hparams, pet_hp = load_fusion(str(paths[key]))
            pet_n, _, _ = stage1_normalizations(pet_hp, None)
            testset = build_testset(hparams, pet_n, None)
            results[key] = evaluate(model, state_dict, hparams, testset,
                                    name, confusion_pngs=confusion_pngs,
                                    device=device)
            print(key, results[key])
    return results


if __name__ == "__main__":
    main()
