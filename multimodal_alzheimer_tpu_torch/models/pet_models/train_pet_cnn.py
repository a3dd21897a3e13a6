"""Train the small PET 3D CNN (reference train_pet_cnn.py entry point).

Port of ``multimodal_alzheimer_tpu/models/pet_models/train_pet_cnn.py``: the
reference's fixed and sampled hyperparameters (reference:
pet_models/train_pet_cnn.py:32-118): PET z-score constants 0.5145/0.5383, lr
log-uniform [5e-6, 1e-3], the conv_out ladders, the four filter-size
patterns, batch >= 64 raising patience and epochs, fl_gamma in
{None, 1, 2, 5}, seed 5; and ``train``, one training run from the split
under ``MMALZ_DATA_DIR`` (or ``./data``).

``sample_hparams`` takes any object with optuna's ``suggest_float`` and
``suggest_categorical``; this module does not import optuna.

    train(sample_hparams(trial), "pet", device="cpu")  # on a CPU
"""

from __future__ import annotations

from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
    SmallPETCNN,
)
from multimodal_alzheimer_tpu_torch.train.driver import (
    attach_class_weights,
    build_datasets,
    run_training,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

LOG_DIRECTORY = "lightning_logs"
EXPERIMENT_NAME = "optuna_two_class"
SEED = 5


def sample_hparams(trial, n_classes: int = 3) -> dict:
    """Reference search space (train_pet_cnn.py:36-109)."""
    conv_out_options = []
    for x in (8, 16, 32):
        for n in (3, 4):
            conv_out_options.append(tuple(2 ** i * x for i in range(n)))
    conv_out_index = {str(o): o for o in conv_out_options}
    filter_size_options = [(5, 5, 3, 3), (7, 5, 3, 3), (5, 5, 5, 3),
                           (3, 3, 3, 3)]
    filter_size_index = {str(o): o for o in filter_size_options}

    hparams = {
        "early_stopping_patience": 5,
        "max_epochs": 20,
        "norm_mean": 0.5145,
        "norm_std": 0.5383,
        "reduce_factor_lr_schedule": None,
        "n_classes": n_classes,
        "best_k_checkpoints": 3,
    }
    hparams["lr"] = trial.suggest_float("learning_rate", 5e-6, 1e-3,
                                        log=True)
    conv_idx = trial.suggest_categorical("conv_out", list(conv_out_index))
    hparams["conv_out"] = conv_out_index[conv_idx]
    fs_idx = trial.suggest_categorical("filter_size",
                                       list(filter_size_index))
    filter_size = filter_size_index[fs_idx]
    hparams["filter_size"] = filter_size[:len(hparams["conv_out"])]
    hparams["batchnorm"] = trial.suggest_categorical("batchnorm",
                                                     (True, False))
    hparams["linear_out"] = trial.suggest_categorical(
        "linear_out", (False, 32, 64, 128))
    hparams["batch_size"] = trial.suggest_categorical(
        "batch_size", (8, 16, 32, 64))
    if hparams["batch_size"] >= 64:
        hparams["early_stopping_patience"] = 10
        hparams["max_epochs"] = 50
    if trial.suggest_categorical("dropout_conv", (True, False)):
        hparams["dropout_conv_p"] = trial.suggest_float(
            "dropout_conv_p", 0.05, 0.2)
    if trial.suggest_categorical("dropout_dense", (True, False)):
        hparams["dropout_dense_p"] = trial.suggest_float(
            "dropout_dense_p", 0.2, 0.5)
    hparams["fl_gamma"] = trial.suggest_categorical("fl_gamma",
                                                    (None, 1, 2, 5))
    return hparams


def pet_normalization(hparams: dict) -> dict:
    """The constant PET z-score of the hparams."""
    return {"mean": hparams["norm_mean"], "std": hparams["norm_std"]}


def train(hparams: dict, experiment_name: str = "",
          experiment_version=None, log_confusion_images: bool = True,
          device="cuda", **run_kwargs):
    """Train ``SmallPETCNN`` on the split's PET volumes with the constant
    z-score in the step; return the last validation loss. The weights start
    from seed ``SEED``. ``run_kwargs`` go to ``run_training``
    (``num_workers``, ``variables_transform``, ...)."""
    trainset, valset = build_datasets(
        hparams, ["pet1451"], normalize_pet=pet_normalization(hparams))
    attach_class_weights(hparams, trainset)
    model = SmallPETCNN.from_hparams(hparams,
                                     generator=make_generator(SEED))
    _, _, last_val_loss = run_training(
        model, hparams, trainset, valset,
        experiment_name=experiment_name,
        experiment_version=experiment_version,
        log_dir=LOG_DIRECTORY, seed=SEED,
        log_confusion_images=log_confusion_images, device=device,
        **run_kwargs)
    return last_val_loss
