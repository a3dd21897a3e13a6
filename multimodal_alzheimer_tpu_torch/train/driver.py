"""Shared training driver used by the train_<model> entry points.

Port of ``multimodal_alzheimer_tpu/train/driver.py:29-141``: the reference's
per-script template once (reference: train_pet_cnn.py:121-205): seed ->
datasets and loaders -> class weights ``1 - normalised frequency`` -> model
-> logger -> Trainer (EarlyStopping, two top-k checkpoint managers, LR
plateau) -> fit -> last validation loss; and the fusion stages' optimizer
groups and dataset normalisation from the stage-1 checkpoints.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from multimodal_alzheimer_tpu_torch.data.dataset import MultiModalDataset
from multimodal_alzheimer_tpu_torch.data.pipeline import DataLoader
from multimodal_alzheimer_tpu_torch.losses.classification import (
    make_criterion,
)
from multimodal_alzheimer_tpu_torch.train.logging import ExperimentLogger
from multimodal_alzheimer_tpu_torch.train.loop import Trainer
from multimodal_alzheimer_tpu_torch.train.optim import (
    FROZEN,
    build_optimizer,
    single_lr_optimizer,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import seed_everything


def data_csv(mode: str, data_dir: Optional[str] = None) -> str:
    """data/{mode}_path_data_labels.csv under the CWD (reference layout,
    train_pet_cnn.py:143-144); ``MMALZ_DATA_DIR`` overrides the root."""
    root = data_dir or os.environ.get("MMALZ_DATA_DIR",
                                      os.path.join(os.getcwd(), "data"))
    return os.path.join(root, f"{mode}_path_data_labels.csv")


def binary_from_hparams(hparams: dict) -> bool:
    if hparams["n_classes"] not in (2, 3):
        raise ValueError(f"n_classes must be 2 or 3, got "
                         f"{hparams['n_classes']}")
    return hparams["n_classes"] == 2


def build_datasets(hparams: dict, modalities, normalize_pet=None,
                   normalize_mri=None, quantile: float = 0.99,
                   data_dir: Optional[str] = None,
                   modes=("train", "val")):
    binary = binary_from_hparams(hparams)
    return tuple(
        MultiModalDataset(
            path=data_csv(mode, data_dir),
            modalities=list(modalities),
            normalize_pet=normalize_pet,
            normalize_mri=normalize_mri,
            quantile=quantile,
            binary_classification=binary,
            days_threshold=hparams.get("days_threshold", 180),
            cache_dir=hparams.get("volume_cache_dir"),
            cache_dtype=hparams.get("volume_cache_dtype"))
        for mode in modes)


def attach_class_weights(hparams: dict, trainset: MultiModalDataset) -> None:
    """hparams['loss_class_weights'] = 1 - normalised frequency
    (train_pet_cnn.py:166-168)."""
    _, weight_normalized = trainset.get_label_distribution()
    weights = 1.0 - np.nan_to_num(weight_normalized, nan=0.0)
    hparams["loss_class_weights"] = weights.tolist()
    hparams["loss_class_weights_human_readable"] = weights.tolist()


def fusion_optimizer(hparams: dict, head_names: tuple,
                     model: torch.nn.Module) -> torch.optim.Adam:
    """Fusion-stage Adam over ``model`` (anat_pet_fusion.py:94-118): the
    submodules named in ``head_names`` (the new fusion and reduce layers)
    train at ``lr``; the loaded earlier-stage towers are frozen unless
    ``lr_pretrained`` is set, and then train at it."""
    lr_pretrained = hparams.get("lr_pretrained")

    def label(path):
        if path and path[0] in head_names:
            return "head"
        return "pretrained" if lr_pretrained else FROZEN

    return build_optimizer(
        {"head": hparams["lr"],
         "pretrained": lr_pretrained if lr_pretrained else None},
        label, model, l2_reg=hparams.get("l2_reg", 0.0))


def stage1_normalizations(pet_hparams: Optional[dict] = None,
                          mri_hparams: Optional[dict] = None):
    """(normalize_pet, normalize_mri, quantile) of the datasets of a fusion
    stage, from its stage-1 checkpoints' hparams
    (train_anat_pet_fusion.py:154-171): the PET z-score constants, and the
    per-scan min-max at the MRI checkpoint's ``norm_percentile``."""
    normalize_pet = None
    normalize_mri = None
    quantile = 0.99
    if pet_hparams is not None:
        normalize_pet = {"mean": float(pet_hparams["norm_mean"]),
                         "std": float(pet_hparams["norm_std"])}
    if mri_hparams is not None:
        normalize_mri = {"per_scan_norm": "min_max"}
        quantile = float(mri_hparams.get("norm_percentile", 0.99))
    return normalize_pet, normalize_mri, quantile


def run_training(model, hparams: dict, trainset, valset,
                 experiment_name: str = "",
                 experiment_version: Optional[str] = None,
                 optimizer=None,
                 log_dir: str = "lightning_logs",
                 seed: int = 5,
                 num_workers: int = 8,
                 drop_last: bool = False,
                 variables_transform: Optional[Callable] = None,
                 log_confusion_images: bool = True,
                 device="cuda"):
    """Build loaders and a Trainer, fit; return (trainer, state, last val
    loss).

    ``variables_transform`` maps the model's initial ``state_dict`` to the
    one training starts from (a checkpoint, or weights carried over from the
    JAX package with ``models/convert.py``); it is loaded into ``model``
    before the first step. Build ``optimizer`` on ``model``'s parameters:
    loading and the move to ``device`` keep the parameter objects.
    ``log_confusion_images`` renders a confusion-matrix image per epoch for
    TensorBoard, which needs the plotting packages.
    """
    seed_everything(seed)

    train_loader = DataLoader(trainset, hparams["batch_size"], shuffle=True,
                              num_workers=num_workers, seed=seed,
                              drop_last=drop_last, device=device)
    val_loader = DataLoader(valset, hparams["batch_size"],
                            num_workers=num_workers, drop_last=drop_last,
                            device=device)

    criterion = make_criterion(hparams)
    if optimizer is None:
        optimizer = single_lr_optimizer(model, hparams["lr"],
                                        hparams.get("l2_reg", 0.0))
    if variables_transform is not None:
        model.load_state_dict(variables_transform(model.state_dict()))

    logger = ExperimentLogger(save_dir=log_dir, name=experiment_name,
                              version=experiment_version)
    logger.log_hparams(hparams)
    trainer = Trainer(
        model, hparams, optimizer, criterion,
        preprocess=trainset.get_device_preprocess(),
        logger=logger,
        checkpoint_dir=str(logger.log_dir / "checkpoints"),
        seed=seed, log_confusion_images=log_confusion_images, device=device)

    state = trainer.init_state()
    state, last_val_loss = trainer.fit(state, train_loader, val_loader,
                                       hparams.get("max_epochs"))
    return trainer, state, last_val_loss
