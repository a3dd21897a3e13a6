"""Train the stage-2 MRI+tabular fusion (reference
train_mrt_tabular_fusion.py; ensemble_size fixed at 4 :69, modalities
['tabular', 't1w'] :145).

Port of ``multimodal_alzheimer_tpu/models/fusion_models/
train_mrt_tabular_fusion.py``. Required hparams: 'path_mri' and
'path_tabular', checkpoint directories of the port. The stage-1 checkpoints
are grafted into the fusion's towers before the first step; the MRI
datasets take the MRI checkpoint's min-max percentile (bounds memoised per
sample, so the step runs K2 alone).

``sample_hparams`` takes any object with optuna's ``suggest_float`` and
``suggest_categorical``; this module does not import optuna. The HPO entry
points (``_objective``, ``optuna_optimization``) are not ported.
"""

from __future__ import annotations

from multimodal_alzheimer_tpu_torch.models.fusion_models.tabular_mri_fusion import (
    TabularMRIFusion,
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
EXPERIMENT_NAME = "tabular_mri_fusion"
EXPERIMENT_VERSION = None
SEED = 5

HEAD_NAMES = ("reduce_tab", "stage2out", "cls2")


def sample_hparams(trial, n_classes: int = 2, path_mri: str = None,
                   path_tabular: str = None) -> dict:
    hparams = {
        "early_stopping_patience": 5,
        "max_epochs": 20,
        "n_classes": n_classes,
        "reduce_factor_lr_schedule": None,
        "best_k_checkpoints": 3,
        "ensemble_size": 4,
        "path_mri": path_mri,
        "path_tabular": path_tabular,
    }
    hparams["lr"] = trial.suggest_float("lr", 1e-5, 1e-2, log=True)
    freeze = trial.suggest_categorical("freeze", (True, False))
    hparams["lr_pretrained"] = (None if freeze else trial.suggest_float(
        "lr_pretrained", 1e-7, 1e-5, log=True))
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
    """Train ``TabularMRIFusion`` from the stage-1 checkpoints; return the
    last validation loss. The head starts from seed ``SEED``.
    ``run_kwargs`` go to ``run_training`` (``num_workers``, ...)."""
    mri_sd, mri_hp, _ = load_checkpoint(hparams["path_mri"])
    tab_sd, tab_hp, _ = load_checkpoint(hparams["path_tabular"])

    _, normalize_mri, quantile = stage1_normalizations(None, mri_hp)
    trainset, valset = build_datasets(hparams, ["tabular", "t1w"],
                                      normalize_mri=normalize_mri,
                                      quantile=quantile)
    attach_class_weights(hparams, trainset)

    model = TabularMRIFusion.from_hparams(hparams, mri_hp, tab_hp,
                                          generator=make_generator(SEED))
    optimizer = fusion_optimizer(hparams, HEAD_NAMES, model)
    _, _, last_val_loss = run_training(
        model, hparams, trainset, valset,
        experiment_name=experiment_name,
        experiment_version=experiment_version,
        optimizer=optimizer, log_dir=LOG_DIRECTORY, seed=SEED,
        variables_transform=lambda sd: graft_params(
            sd, {"mri_model": mri_sd, "tab_model": tab_sd}),
        log_confusion_images=log_confusion_images, device=device,
        **run_kwargs)
    return last_val_loss
