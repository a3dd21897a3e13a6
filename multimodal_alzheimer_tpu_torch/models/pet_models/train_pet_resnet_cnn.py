"""Train the PET Med3D-ResNet classifier (reference train_pet_resnet_cnn.py).

Port of ``multimodal_alzheimer_tpu/models/pet_models/train_pet_resnet_cnn.py``
(reference: pet_models/train_pet_resnet_cnn.py): seed 15, resnet depth in
{10, 18, 50}, freeze or lr_pretrained sampling, the PET z-score constants,
and ``train_anat_cnn``'s optimizer groups (head at lr, backbone frozen or at
lr_pretrained). Early stopping monitors the epoch validation loss, as in
JAX (the reference's step-level 'val_loss' is a documented divergence).

    train(sample_hparams(trial), "pet_resnet", device="cpu")  # on a CPU
"""

from __future__ import annotations

from multimodal_alzheimer_tpu_torch.models.mri_models.train_anat_cnn import (
    backbone_head_optimizer,
    generate_linear_block_options,
)
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_resnet_cnn import (
    PETResNetCNN,
)
from multimodal_alzheimer_tpu_torch.models.pet_models.train_pet_cnn import (
    pet_normalization,
)
from multimodal_alzheimer_tpu_torch.train.driver import (
    attach_class_weights,
    build_datasets,
    run_training,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

LOG_DIRECTORY = "lightning_logs"
EXPERIMENT_NAME = "optuna_pet_resnet"
SEED = 15


def sample_hparams(trial, n_classes: int = 2) -> dict:
    hparams = {
        "early_stopping_patience": 5,
        "max_epochs": 20,
        "norm_mean": 0.5145,
        "norm_std": 0.5383,
        "n_classes": n_classes,
        "reduce_factor_lr_schedule": None,
        "best_k_checkpoints": 3,
    }
    dense_options = {str(o): o for o in
                     generate_linear_block_options([256, 128, 64], [0, 3])}
    hparams["lr"] = trial.suggest_float("lr", 1e-5, 1e-2, log=True)
    freeze = trial.suggest_categorical("freeze", (True, False))
    hparams["lr_pretrained"] = (None if freeze else trial.suggest_float(
        "lr_pretrained", 1e-7, 1e-5, log=True))
    hparams["conv_out"] = []
    hparams["filter_size"] = []
    hparams["batchnorm_begin"] = trial.suggest_categorical(
        "batchnorm_begin", (True, False))
    hparams["batchnorm_dense"] = trial.suggest_categorical(
        "batchnorm_dense", (True, False))
    hparams["batch_size"] = trial.suggest_categorical("batch_size",
                                                      (8, 16, 32, 64))
    if hparams["batch_size"] >= 64:
        hparams["early_stopping_patience"] = 10
        hparams["max_epochs"] = 50
    hparams["l2_reg"] = trial.suggest_categorical(
        "l2_reg", (0, 1e-1, 1e-2, 1e-3))
    hparams["fl_gamma"] = trial.suggest_categorical("fl_gamma",
                                                    (None, 1, 2, 5))
    hparams["resnet_depth"] = trial.suggest_categorical("resnet_depth",
                                                        (10, 18, 50))
    dense_idx = trial.suggest_categorical("linear_out", list(dense_options))
    hparams["linear_out"] = dense_options[dense_idx]
    return hparams


def train(hparams: dict, experiment_name: str = "",
          experiment_version=None, log_confusion_images: bool = True,
          device="cuda", **run_kwargs):
    """Train ``PETResNetCNN`` on the split's PET volumes with the constant
    z-score in the step; return the last validation loss. The weights start
    from seed ``SEED``. ``run_kwargs`` go to ``run_training``
    (``num_workers``, ``variables_transform``, ...)."""
    trainset, valset = build_datasets(
        hparams, ["pet1451"], normalize_pet=pet_normalization(hparams))
    attach_class_weights(hparams, trainset)
    model = PETResNetCNN.from_hparams(hparams,
                                      generator=make_generator(SEED))
    optimizer = backbone_head_optimizer(hparams, model)
    _, _, last_val_loss = run_training(
        model, hparams, trainset, valset,
        experiment_name=experiment_name,
        experiment_version=experiment_version,
        optimizer=optimizer, log_dir=LOG_DIRECTORY, seed=SEED,
        log_confusion_images=log_confusion_images, device=device,
        **run_kwargs)
    return last_val_loss
