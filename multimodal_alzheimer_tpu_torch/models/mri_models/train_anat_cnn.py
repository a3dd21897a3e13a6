"""Train the MRI Med3D-ResNet classifier (reference train_anat_cnn.py).

Port of ``multimodal_alzheimer_tpu/models/mri_models/train_anat_cnn.py``:
the search space (reference: mri_models/train_anat_cnn.py:54-140): lr log
[1e-5, 1e-2], freeze or lr_pretrained log [1e-7, 1e-5], per-scan quantile
min-max with q in {0.95, 0.98, 0.99, 1}, resnet depth in {10, 18, 50}, l2
in {0, 1e-1, 1e-2, 1e-3}, the linear-block shape generator, fl_gamma in
{None, 1, 2, 5}, seed 15; and ``train_anat``, one training run from the
split under ``MMALZ_DATA_DIR`` (or ``./data``).

Optimizer groups follow anat_cnn.py:111-126: the 'head' submodule at lr,
the backbone frozen or at lr_pretrained.

``sample_hparams`` takes any object with optuna's ``suggest_float`` and
``suggest_categorical``; this module does not import optuna.
"""

from __future__ import annotations

from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.train.driver import (
    attach_class_weights,
    build_datasets,
    run_training,
)
from multimodal_alzheimer_tpu_torch.train.optim import (
    FROZEN,
    build_optimizer,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

LOG_DIRECTORY = "lightning_logs"
SEED = 15


def generate_linear_block_options(first_layer_options, n_layers_options):
    """Dense-block shapes (train_anat_cnn.py:67-90)."""
    dense_out_options = []
    for x in first_layer_options:
        for n in n_layers_options:
            dense_out_options.append(tuple(x for _ in range(n)))
            dense_out_options.append(tuple(int(x / 2 ** i)
                                           for i in range(n)))
    return dense_out_options


def sample_hparams(trial, n_classes: int = 2) -> dict:
    hparams = {
        "early_stopping_patience": 5,
        "max_epochs": 20,
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
    hparams["norm_percentile"] = trial.suggest_categorical(
        "norm_percentile", (0.95, 0.98, 0.99, 1))
    hparams["fl_gamma"] = trial.suggest_categorical("fl_gamma",
                                                    (None, 1, 2, 5))
    hparams["resnet_depth"] = trial.suggest_categorical("resnet_depth",
                                                        (10, 18, 50))
    dense_idx = trial.suggest_categorical("linear_out",
                                          list(dense_options))
    hparams["linear_out"] = dense_options[dense_idx]
    return hparams


def backbone_head_optimizer(hparams: dict, model):
    """Adam over ``model``: head at lr; backbone frozen or at
    lr_pretrained (anat_cnn.py:111-126)."""
    lr_pretrained = hparams.get("lr_pretrained")

    def label(path):
        if path and path[0] == "head":
            return "head"
        return "pretrained" if lr_pretrained else FROZEN

    return build_optimizer(
        {"head": hparams["lr"],
         "pretrained": lr_pretrained if lr_pretrained else None},
        label, model, l2_reg=hparams.get("l2_reg", 0.0))


def train_anat(hparams: dict, experiment_name: str = "",
               experiment_version=None, log_confusion_images: bool = True,
               device="cuda", **run_kwargs):
    """Train ``AnatCNN`` on the split's T1w scans with per-scan quantile
    min-max at ``hparams['norm_percentile']`` (bounds memoised per sample,
    so the step runs the apply kernel alone); return the last validation
    loss. The weights start from seed ``SEED``. ``run_kwargs`` go to
    ``run_training`` (``num_workers``, ``variables_transform``, ...)."""
    trainset, valset = build_datasets(
        hparams, ["t1w"],
        normalize_mri={"per_scan_norm": "min_max"},
        quantile=hparams["norm_percentile"])
    attach_class_weights(hparams, trainset)
    model = AnatCNN.from_hparams(hparams, generator=make_generator(SEED))
    optimizer = backbone_head_optimizer(hparams, model)

    _, _, last_val_loss = run_training(
        model, hparams, trainset, valset,
        experiment_name=experiment_name,
        experiment_version=experiment_version,
        optimizer=optimizer, log_dir=LOG_DIRECTORY, seed=SEED,
        log_confusion_images=log_confusion_images, device=device,
        **run_kwargs)
    return last_val_loss
