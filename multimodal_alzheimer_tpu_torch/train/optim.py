"""Optimizers: per-group Adam + ReduceLROnPlateau and early stopping.

Port of ``multimodal_alzheimer_tpu/train/optim.py``. The reference builds
torch Adam with one learning rate per parameter group, head at ``lr`` and
the pretrained backbone frozen or at ``lr_pretrained`` (reference:
mri_models/anat_cnn.py:111-128), with torch's ``weight_decay`` (L2 added to
the gradient before the Adam moments, not AdamW). The JAX package writes
that as the optax chain ``add_decayed_weights(l2) -> scale_by_adam() ->
scale(-lr)`` per group; here it is ``torch.optim.Adam`` itself. A frozen
group's parameters stay out of the optimizer: no update, no decay.

``PlateauScheduler`` reproduces ``ReduceLROnPlateau``'s defaults as a
host-side ``lr_scale`` multiplier that the train step applies to every
group's base learning rate (``train/state.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

FROZEN = "frozen"


def adam_group(params, lr: float, l2_reg: float = 0.0) -> torch.optim.Adam:
    """torch ``Adam(lr, weight_decay=l2_reg)`` over ``params`` (JAX's
    ``adam_group`` chain for one group, ``optim.py:28-35``): the K-trial
    trainer's optimizer for one trial. ``params`` may also be torch
    parameter-group dicts carrying their own ``lr`` (a group at lr 0.0 keeps
    its parameters exactly, with L2 still in its moments)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=l2_reg)


def build_optimizer(group_lrs: Dict[str, Optional[float]],
                    label_fn: Callable, model: torch.nn.Module,
                    l2_reg: float = 0.0) -> torch.optim.Adam:
    """Adam with one parameter group per label.

    ``label_fn`` maps a parameter's path (its name split on '.', e.g.
    ``('head', 'cls', 'weight')``) to a group name; ``group_lrs`` maps a
    group name to its lr, None for frozen. ``l2_reg`` is torch-style weight
    decay for every trained group.
    """
    groups: Dict[str, list] = {}
    for name, param in model.named_parameters():
        label = label_fn(tuple(name.split(".")))
        if label != FROZEN and group_lrs.get(label) is not None:
            groups.setdefault(label, []).append(param)
        elif label != FROZEN and label not in group_lrs:
            raise KeyError(f"parameter {name} has label {label!r}, which "
                           f"group_lrs does not name")
    if not groups:
        raise ValueError("every parameter is frozen: nothing to optimize")
    return torch.optim.Adam(
        [{"params": params, "lr": group_lrs[label], "name": label}
         for label, params in groups.items()],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=l2_reg)


def single_lr_optimizer(model: torch.nn.Module, lr: float,
                        l2_reg: float = 0.0) -> torch.optim.Adam:
    """Whole-model Adam (stage-1 training, e.g. pet_cnn.py:72-74)."""
    return build_optimizer({"all": lr}, lambda path: "all", model, l2_reg)


def head_pretrained_label_fn(head_prefixes: tuple,
                             pretrained_lr: Optional[float]):
    """Label fn for the reference's head/backbone split: params whose path
    starts with one of ``head_prefixes`` train at 'head' lr; everything
    else is 'pretrained' (or frozen when ``pretrained_lr`` is None) —
    mirroring anat_cnn.py:111-126."""

    def label(path: tuple) -> str:
        if any(path[0] == p or p in path for p in head_prefixes):
            return "head"
        return FROZEN if pretrained_lr is None else "pretrained"

    return label


class PlateauScheduler:
    """torch ReduceLROnPlateau parity (host-side, emits an lr multiplier)."""

    def __init__(self, factor: float, patience: int = 10,
                 threshold: float = 1e-4, mode: str = "min",
                 cooldown: int = 0, min_lr_scale: float = 0.0):
        if mode != "min":
            raise ValueError(f"mode must be 'min', got {mode!r}")
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr_scale = min_lr_scale
        self.best = float("inf")
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        self.lr_scale = 1.0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr_scale = max(self.lr_scale * self.factor,
                                    self.min_lr_scale)
                self.cooldown_counter = self.cooldown
                self.num_bad_epochs = 0
        return self.lr_scale


class EarlyStopping:
    """Lightning EarlyStopping(monitor, mode='min', patience) parity
    (reference: train_pet_cnn.py:185-188): stop after ``patience``
    consecutive epochs without improvement (min_delta 0)."""

    def __init__(self, patience: int, mode: str = "min"):
        if mode != "min":
            raise ValueError(f"mode must be 'min', got {mode!r}")
        self.patience = patience
        self.best = float("inf")
        self.wait = 0

    def step(self, metric: float) -> bool:
        """Returns True when training should stop."""
        if metric < self.best:
            self.best = metric
            self.wait = 0
            return False
        self.wait += 1
        return self.wait >= self.patience
