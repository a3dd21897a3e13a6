"""Checkpointing: ``torch.save`` of the state dict and top-k managers.

Port of ``multimodal_alzheimer_tpu/train/checkpoint.py:28-131``, with the
reference's behaviours (SURVEY.md §5):
  * two top-k managers per run, best-k by val_loss (min) and by val_f1
    (max), directories ``epoch={E}-val_loss={v:.3f}`` /
    ``epoch={E}-val_f1={v:.3f}`` (reference: train_pet_cnn.py:191-200);
  * hyperparameters beside every checkpoint, so a model rebuilds without
    outside config (``save_hyperparameters``, base_model.py:14).
A checkpoint directory holds ``state.pt`` (the model's ``state_dict``),
``hparams.json`` and, when given, ``metrics.json``.

``graft_params`` (``checkpoint.py:197``) loads stage-1 checkpoints into a
fusion model's towers by submodule prefix. ``sync_tower_duplicates`` and
``assert_tower_duplicates_equal`` (``checkpoint.py:240-330``) keep and check
the stage-3 fusion's duplicate tower copies. ``save_train_state`` /
``load_train_state`` (``checkpoint.py:132-195``) write and read a resumable
mid-run state: ``train_state.pt`` (the model's and the optimizer's
``state_dict``, ``step`` and ``lr_scale``) beside ``hparams.json`` and
``extra.json`` as JAX writes them.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


def save_checkpoint(path: str | Path, state_dict: dict, hparams: dict,
                    metrics: Optional[dict] = None) -> None:
    """Write ``state.pt`` + ``hparams.json`` (+ ``metrics.json``), replacing
    any checkpoint at ``path``."""
    path = Path(path).absolute()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               path / "state.pt")
    with open(path / "hparams.json", "w") as f:
        json.dump(_jsonable(hparams), f, indent=2)
    if metrics is not None:
        with open(path / "metrics.json", "w") as f:
            json.dump(_jsonable(metrics), f, indent=2)


def load_checkpoint(path: str | Path):
    """Returns (state_dict on the CPU, hparams, metrics or None)."""
    path = Path(path).absolute()
    state_dict = torch.load(path / "state.pt", map_location="cpu",
                            weights_only=True)
    with open(path / "hparams.json") as f:
        hparams = json.load(f)
    metrics = None
    metrics_file = path / "metrics.json"
    if metrics_file.exists():
        with open(metrics_file) as f:
            metrics = json.load(f)
    return state_dict, hparams, metrics


class TopKCheckpointManager:
    """Keep the k best checkpoints by one metric (min or max).

    The reference runs two Lightning ModelCheckpoint callbacks per training
    (train_pet_cnn.py:191-200); instantiate two of these.
    """

    def __init__(self, root: str | Path, metric: str, mode: str = "min",
                 top_k: int = 3, filename_metric: Optional[str] = None):
        self.root = Path(root)
        self.metric = metric
        self.mode = mode
        self.top_k = top_k
        self.filename_metric = filename_metric or metric
        self.entries: list[tuple[float, str]] = []  # (value, dir)
        self.root.mkdir(parents=True, exist_ok=True)

    def _better(self, a: float, b: float) -> bool:
        return a < b if self.mode == "min" else a > b

    def consider(self, epoch: int, metrics: dict, state_dict: dict,
                 hparams: dict) -> Optional[str]:
        """Save if within top-k; returns the checkpoint dir or None."""
        value = float(metrics[self.metric])
        if len(self.entries) >= self.top_k:
            worst = self.entries[-1][0]
            if not self._better(value, worst):
                return None
        name = f"epoch={epoch}-{self.filename_metric}={value:.3f}"
        path = self.root / name
        save_checkpoint(path, state_dict, hparams, metrics)
        self.entries.append((value, str(path)))
        self.entries.sort(key=lambda e: e[0],
                          reverse=(self.mode == "max"))
        while len(self.entries) > self.top_k:
            _, evict = self.entries.pop()
            if os.path.isdir(evict):
                shutil.rmtree(evict, ignore_errors=True)
        return str(path)

    @property
    def best_path(self) -> Optional[str]:
        return self.entries[0][1] if self.entries else None

    @property
    def best_value(self) -> Optional[float]:
        return self.entries[0][0] if self.entries else None


def save_train_state(path: str | Path, state, hparams: dict,
                     extra: Optional[dict] = None) -> None:
    """Full mid-run checkpoint of a ``TrainState``: parameters, BatchNorm
    statistics, the optimizer's moments and groups (with their base lr),
    ``step`` and ``lr_scale``; resumable training, which the reference's
    ModelCheckpoints lack (SURVEY §5). Replaces any checkpoint at
    ``path``."""
    path = Path(path).absolute()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    torch.save({
        "model": {k: v.detach().cpu()
                  for k, v in state.model.state_dict().items()},
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "lr_scale": float(state.lr_scale),
    }, path / "train_state.pt")
    with open(path / "hparams.json", "w") as f:
        json.dump(_jsonable(hparams), f, indent=2)
    if extra:
        with open(path / "extra.json", "w") as f:
            json.dump(_jsonable(extra), f, indent=2)


def load_train_state(path: str | Path, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer):
    """Restore a ``save_train_state`` checkpoint into ``model`` and
    ``optimizer``, built as the saved ones were (the same parameter groups);
    the moments move to the parameters' device. Returns ``(TrainState,
    hparams)``."""
    from multimodal_alzheimer_tpu_torch.train.state import TrainState

    path = Path(path).absolute()
    saved = torch.load(path / "train_state.pt", map_location="cpu",
                       weights_only=True)
    with open(path / "hparams.json") as f:
        hparams = json.load(f)
    model.load_state_dict(saved["model"])
    optimizer.load_state_dict(saved["optimizer"])
    state = TrainState(model=model, optimizer=optimizer,
                       step=int(saved["step"]),
                       lr_scale=float(saved["lr_scale"]))
    return state, hparams


def graft_params(target: dict, grafts: dict) -> dict:
    """Load pretrained submodule state dicts into a fusion model's.

    Args:
      target: the fusion model's ``state_dict``.
      grafts: submodule path (e.g. 'pet_model'; nested with '/' or '.', e.g.
        'model_anat_pet/pet_model') -> that submodule's ``state_dict`` from
        a stage-1 checkpoint.

    Returns a new state dict with those entries replaced. The entries under
    each prefix must match the graft's names and shapes exactly; a mismatch
    raises (the wiring faults the reference's ``load_state_dict`` would
    mis-map quietly).
    """
    out = dict(target)
    for sub_path, source in grafts.items():
        prefix = sub_path.replace("/", ".") + "."
        node = _subtree(out, sub_path)
        if not node:
            if _tree_size(source) == 0:
                continue
            raise ValueError(
                f"{sub_path} not in the target state dict (have: "
                f"{sorted({k.split('.')[0] for k in out})})")
        _check_same_structure(node, source, sub_path)
        for key, value in source.items():
            out[prefix + key] = value
    return out


# Stage-3 duplicate tower pairs (canonical, duplicate). The reference's
# All_Modalities_Fusion holds two private copies of each stage-1 tower
# (all_modalities_fusion.py:66-79: PET in anat_pet and pet_tab, MRI in
# anat_pet and anat_tab, tabular in anat_tab and pet_tab); the frozen
# grafting regime loads the same stage-1 checkpoint into both, so they are
# identical by construction. AllModalitiesFusion.share_towers reads only
# the canonical copy; these helpers keep and check the duplicates' parity
# at the checkpoint level, over parameters and BatchNorm buffers alike.
TOWER_DUPLICATES = (
    ("model_anat_pet.pet_model", "model_pet_tab.pet_model"),
    ("model_anat_pet.mri_model", "model_anat_tab.mri_model"),
    ("model_anat_tab.tab_model", "model_pet_tab.tab_model"),
)


def _subtree(state_dict: dict, path: str) -> dict:
    """The entries under submodule ``path`` ('/' or '.' separated), keyed
    by their names below it."""
    prefix = path.replace("/", ".") + "."
    return {k[len(prefix):]: v for k, v in state_dict.items()
            if k.startswith(prefix)}


def sync_tower_duplicates(state_dict: dict) -> dict:
    """A new state dict with each canonical tower copied over its duplicate.

    Used when training and saving with ``share_towers=True``: the shared
    forward only visits (and only updates the BatchNorm statistics of) the
    canonical copies, so saved checkpoints sync the duplicates to stay
    bit-identical to the reference's unshared regime, where both copies see
    the same batches and update identically. The copies are real copies
    (clones), not aliases of the canonical tensors. A pair absent from the
    state dict is passed over; a duplicate whose names or shapes differ
    from its canonical's raises.
    """
    out = dict(state_dict)
    for canonical, duplicate in TOWER_DUPLICATES:
        src = _subtree(out, canonical)
        dst = _subtree(out, duplicate)
        if not src or not dst:
            continue
        _check_same_structure(dst, src, duplicate)
        prefix = duplicate.replace("/", ".") + "."
        for key, value in src.items():
            out[prefix + key] = value.detach().clone()
    return out


def assert_tower_duplicates_equal(state_dict: dict) -> None:
    """Raise if any duplicate tower entry differs from its canonical.

    Guard before enabling ``share_towers`` on a restored checkpoint: a
    checkpoint whose stage-2 sub-models trained their towers unfrozen holds
    genuinely different duplicates, and sharing would silently change its
    predictions.
    """
    for canonical, duplicate in TOWER_DUPLICATES:
        src = _subtree(state_dict, canonical)
        dst = _subtree(state_dict, duplicate)
        if not src or not dst:
            continue
        _check_same_structure(dst, src, duplicate)
        for key in sorted(src):
            if not torch.equal(src[key].cpu(), dst[key].cpu()):
                raise ValueError(
                    f"tower duplicate mismatch: {duplicate}.{key} differs "
                    f"from its canonical {canonical} copy — this checkpoint "
                    "was not trained/grafted in the frozen regime; "
                    "share_towers would change its outputs")


def _tree_size(state_dict: dict) -> int:
    return len(state_dict)


def _check_same_structure(a: dict, b: dict, where: str) -> None:
    """Raise unless ``a`` and ``b`` have the same keys and shapes."""
    if set(a) != set(b):
        raise ValueError(
            f"graft structure mismatch at {where}:\n"
            f"  only in target: {sorted(set(a) - set(b))}\n"
            f"  only in source: {sorted(set(b) - set(a))}")
    for key in sorted(a):
        if tuple(a[key].shape) != tuple(b[key].shape):
            raise ValueError(
                f"graft shape mismatch at {where}.{key}: "
                f"{tuple(a[key].shape)} vs {tuple(b[key].shape)}")
