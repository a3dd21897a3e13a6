"""Experiment logging: TensorBoard (tensorboardX) + JSONL fallback.

Port of ``multimodal_alzheimer_tpu/train/logging.py``. The reference logs
scalars and confusion-matrix images to TensorBoard every epoch (reference:
base_model.py:99-111, train_pet_cnn.py:172-175 with
``lightning_logs/<experiment>/<version>`` layout). Same layout here; a
JSONL sidecar makes metrics machine-readable without TB. tensorboardX is
optional.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np

from multimodal_alzheimer_tpu_torch.train.checkpoint import _jsonable


class ExperimentLogger:
    def __init__(self, save_dir: str = "lightning_logs",
                 name: str = "default", version: Optional[str] = None):
        if version is None:
            root = Path(save_dir) / name
            existing = []
            if root.is_dir():
                for d in os.listdir(root):
                    if d.startswith("version_"):
                        try:
                            existing.append(int(d.split("_", 1)[1]))
                        except ValueError:
                            pass
            version = f"version_{max(existing) + 1 if existing else 0}"
        self.log_dir = Path(save_dir) / name / str(version)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(logdir=str(self.log_dir))
        except ImportError:
            self._tb = None

    def log_scalars(self, scalars: dict, step: int) -> None:
        record = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            if np.ndim(v) == 0:
                record[k] = float(v)
                if self._tb is not None:
                    self._tb.add_scalar(k, float(v), step)
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def log_image(self, tag: str, image_hwc: np.ndarray, step: int) -> None:
        if self._tb is not None:
            self._tb.add_image(tag, image_hwc, step, dataformats="HWC")

    def log_hparams(self, hparams: dict) -> None:
        with open(self.log_dir / "hparams.json", "w") as f:
            json.dump(_jsonable(hparams), f, indent=2, default=str)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
