"""Train the stage-2 PET+tabular fusion (reference
train_pet_tabular_fusion.py). Loaders drop the last partial batch on both
splits (reference :166, :174).

Port of ``multimodal_alzheimer_tpu/models/fusion_models/
train_pet_tabular_fusion.py``. Required hparams: 'path_pet' and
'path_tabular', checkpoint directories of the port, grafted into the
fusion's towers before the first step; the PET datasets take the PET
checkpoint's z-score constants.

``sample_hparams`` takes any object with optuna's ``suggest_float`` and
``suggest_categorical``; this module does not import optuna. The HPO entry
points are not ported.
"""

from __future__ import annotations

from multimodal_alzheimer_tpu_torch.models.fusion_models.pet_tabular_fusion import (
    PETTabularFusion,
)
from multimodal_alzheimer_tpu_torch.train.checkpoint import (
    graft_params,
    load_checkpoint,
)
from multimodal_alzheimer_tpu_torch.train.driver import (
    attach_class_weights,
    build_datasets,
    fusion_optimizer,
    run_training,
    stage1_normalizations,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

LOG_DIRECTORY = "lightning_logs"
EXPERIMENT_NAME = "pet_tabular_fusion"
EXPERIMENT_VERSION = None
SEED = 5

HEAD_NAMES = ("reduce_tab", "reduce_tab_0", "reduce_tab_1",
              "stage2out", "cls2")


def sample_hparams(trial, n_classes: int = 2, path_pet: str = None,
                   path_tabular: str = None) -> dict:
    hparams = {
        "early_stopping_patience": 5,
        "max_epochs": 20,
        "n_classes": n_classes,
        "reduce_factor_lr_schedule": None,
        "best_k_checkpoints": 3,
        "ensemble_size": 4,
        "path_pet": path_pet,
        "path_tabular": path_tabular,
    }
    hparams["lr"] = trial.suggest_float("lr", 1e-5, 1e-2, log=True)
    freeze = trial.suggest_categorical("freeze", (True, False))
    hparams["lr_pretrained"] = (None if freeze else trial.suggest_float(
        "lr_pretrained", 1e-7, 1e-5, log=True))
    hparams["simple_dim_red"] = trial.suggest_categorical(
        "simple_dim_red", (True, False))
    hparams["batch_size"] = trial.suggest_categorical("batch_size",
                                                      (8, 16, 32, 64))
    hparams["l2_reg"] = trial.suggest_categorical(
        "l2_reg", (0, 1e-1, 1e-2, 1e-3))
    hparams["fl_gamma"] = trial.suggest_categorical("fl_gamma",
                                                    (None, 1, 2, 5))
    return hparams


def train(hparams: dict, experiment_name: str = "",
          experiment_version=None, log_confusion_images: bool = True,
          device="cuda", **run_kwargs):
    """Train ``PETTabularFusion`` from the stage-1 checkpoints; return the
    last validation loss. The head starts from seed ``SEED``.
    ``run_kwargs`` go to ``run_training`` (``num_workers``, ...)."""
    pet_sd, pet_hp, _ = load_checkpoint(hparams["path_pet"])
    tab_sd, tab_hp, _ = load_checkpoint(hparams["path_tabular"])

    normalize_pet, _, _ = stage1_normalizations(pet_hp, None)
    trainset, valset = build_datasets(hparams, ["pet1451", "tabular"],
                                      normalize_pet=normalize_pet)
    attach_class_weights(hparams, trainset)

    model = PETTabularFusion.from_hparams(hparams, pet_hp, tab_hp,
                                          generator=make_generator(SEED))
    optimizer = fusion_optimizer(hparams, HEAD_NAMES, model)
    _, _, last_val_loss = run_training(
        model, hparams, trainset, valset,
        experiment_name=experiment_name,
        experiment_version=experiment_version,
        optimizer=optimizer, log_dir=LOG_DIRECTORY, seed=SEED,
        variables_transform=lambda sd: graft_params(
            sd, {"pet_model": pet_sd, "tab_model": tab_sd}),
        drop_last=True, log_confusion_images=log_confusion_images,
        device=device, **run_kwargs)
    return last_val_loss
