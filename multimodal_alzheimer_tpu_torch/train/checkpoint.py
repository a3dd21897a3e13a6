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
fusion model's towers by submodule prefix. The stage-3 tower-duplicate
helpers and the train-state resume wait for their slices.
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
        node = {k[len(prefix):]: v for k, v in out.items()
                if k.startswith(prefix)}
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
