"""Evaluate the small PET CNN on the test split (reference
inference/test_pet_cnn.py): 2-class and 3-class checkpoints, with the PET
z-score constants taken from the checkpoint's hparams (:13-14).

Port of ``multimodal_alzheimer_tpu/inference/test_pet_cnn.py``. The
checkpoints named ``pet_cnn_2_class`` and ``pet_cnn_3_class`` in
``path_config.yaml`` are checkpoint directories of the port
(``train/checkpoint.py``).

    python -m multimodal_alzheimer_tpu_torch.inference.test_pet_cnn
"""

from __future__ import annotations

from multimodal_alzheimer_tpu_torch.inference.harness import (
    build_testset,
    evaluate_checkpoint,
)
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
    SmallPETCNN,
)
from multimodal_alzheimer_tpu_torch.train.checkpoint import load_checkpoint
from multimodal_alzheimer_tpu_torch.utils.path_config import load_path_config


def _norms(hparams):
    return ({"mean": float(hparams["norm_mean"]),
             "std": float(hparams["norm_std"])}, None, 0.99)


def pet_testset_and_model(checkpoint_path: str):
    """(model, state_dict, hparams, test set) of a PET checkpoint; the
    state_dict is not loaded into the model yet."""
    state_dict, hparams, _ = load_checkpoint(checkpoint_path)
    model = SmallPETCNN.from_hparams(hparams)
    pet, mri, q = _norms(hparams)
    return model, state_dict, hparams, build_testset(hparams, pet, mri, q)


def main(confusion_pngs: bool = True, device="cuda") -> dict:
    """Evaluate each PET checkpoint the path registry names; returns
    {key: metrics}."""
    paths = load_path_config()
    results = {}
    for key, name in (("pet_cnn_2_class", "test_set_pet_2_class"),
                      ("pet_cnn_3_class", "test_set_pet_3_class")):
        if key in paths:
            results[key] = evaluate_checkpoint(
                SmallPETCNN.from_hparams, str(paths[key]), name,
                normalization_from=_norms, confusion_pngs=confusion_pngs,
                device=device)
            print(key, results[key])
    return results


if __name__ == "__main__":
    main()
