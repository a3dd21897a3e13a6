"""Train the PET Med3D-ResNet classifier (reference train_pet_resnet_cnn.py).

Port of ``multimodal_alzheimer_tpu/models/pet_models/train_pet_resnet_cnn.py``
(reference: pet_models/train_pet_resnet_cnn.py): seed 15, resnet depth in
{10, 18, 50}, freeze or lr_pretrained sampling, the PET z-score constants,
and ``train_anat_cnn``'s optimizer groups (head at lr, backbone frozen or at
lr_pretrained). Early stopping monitors the epoch validation loss, as in
JAX (the reference's step-level 'val_loss' is a documented divergence).
``optuna_optimization`` is the HPO entry point, sequential or
``parallel=K`` trials per bucket through the K-trial trainer.

    train(sample_hparams(trial), "pet_resnet", device="cpu")  # on a CPU
"""

from __future__ import annotations

import functools

from multimodal_alzheimer_tpu_torch.models.mri_models.train_anat_cnn import (
    backbone_head_optimizer,
    generate_linear_block_options,
    head_backbone_lr,
)
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_resnet_cnn import (
    PETResNetCNN,
)
from multimodal_alzheimer_tpu_torch.models.pet_models.train_pet_cnn import (
    pet_normalization,
)
from multimodal_alzheimer_tpu_torch.train import hpo
from multimodal_alzheimer_tpu_torch.train.driver import (
    attach_class_weights,
    build_datasets,
    run_training,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

LOG_DIRECTORY = "lightning_logs"
EXPERIMENT_NAME = "optuna_pet_resnet"
EXPERIMENT_VERSION = None
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


@hpo.oom_guard
def _objective(trial, device="cuda", log_confusion_images: bool = True):
    return train(sample_hparams(trial), EXPERIMENT_NAME, EXPERIMENT_VERSION,
                 log_confusion_images=log_confusion_images, device=device)


def optuna_optimization(n_trials: int = 300, timeout: float = 86400,
                        parallel: int = 0, device="cuda",
                        log_confusion_images: bool = True):
    """HPO entry point. ``parallel=K`` switches to the K-trial searcher: the
    MRI wiring (``train_anat_cnn``) with the PET z-score constants of
    ``train_pet_resnet_cnn.py:107-109``: bucket signature (depth, dense block,
    batchnorm flags, batch size + epoch bump), per-trial lr, l2 and gamma, and
    ``head_backbone_lr`` (head at lr, backbone at lr_pretrained, 0.0 when
    frozen); the split is normalized once (fixed constants).
    """
    study = hpo.create_study(direction="minimize")
    if parallel and parallel > 1:
        from multimodal_alzheimer_tpu_torch.train import vmap_hpo
        from multimodal_alzheimer_tpu_torch.train.fusion_hpo import (
            preprocessed_arrays,
        )

        base = {"n_classes": 2}
        trainset, valset = build_datasets(
            base, ["pet1451"],
            normalize_pet={"mean": 0.5145, "std": 0.5383})
        attach_class_weights(base, trainset)
        train_data = preprocessed_arrays(trainset, device)
        val_data = preprocessed_arrays(valset, device)

        def signature(hparams):
            return (int(hparams["resnet_depth"]),
                    tuple(hparams["linear_out"]),
                    bool(hparams["batchnorm_begin"]),
                    bool(hparams["batchnorm_dense"]),
                    int(hparams["batch_size"]),
                    int(hparams["max_epochs"]),
                    int(hparams["early_stopping_patience"]))

        def batch_objective(sig, rows):
            model = PETResNetCNN.from_hparams(dict(base, **rows[0]),
                                              freeze_backbone=False)
            hp = vmap_hpo.stack_trial_hparams(
                rows, extra_keys=("lr_pretrained",))
            values, _ = vmap_hpo.run_parallel_trials(
                model, hp, train_data, val_data,
                batch_size=int(rows[0]["batch_size"]),
                max_epochs=int(rows[0]["max_epochs"]),
                patience=int(rows[0]["early_stopping_patience"]),
                class_weights=base["loss_class_weights"], seed=SEED,
                apply_fn=vmap_hpo.plain_apply, lr_select=head_backbone_lr,
                device=device)
            return [float(v) for v in values[:len(rows)]]

        vmap_hpo.optimize_batched(study, sample_hparams, batch_objective,
                                  n_trials=n_trials, parallel=parallel,
                                  signature_fn=signature, timeout=timeout)
        return study
    study.optimize(functools.partial(
        _objective, device=device,
        log_confusion_images=log_confusion_images),
        n_trials=n_trials, timeout=timeout)
    return study


if __name__ == "__main__":
    optuna_optimization()
