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
