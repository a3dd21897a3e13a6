"""The training loop (Lightning Trainer replacement).

Port of ``multimodal_alzheimer_tpu/train/loop.py`` for one device, after
the reference training template (train_pet_cnn.py:121-205): an epoch loop
with train and validation phases, per-epoch macro/per-class F1 and loss,
TensorBoard logging with confusion-matrix images, EarlyStopping on
``val_loss_epoch``, two top-k checkpoint managers (val_loss min, val_f1
max), ReduceLROnPlateau on ``val_loss_epoch``, and a ``val_loss`` history
whose last entry is the HPO objective (ValidationLossTracker,
train_pet_cnn.py:17-29). ``test`` adds bootstrap F1 and MCC with CIs and
saves the three confusion-matrix PNGs (base_model.py:135-217).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from multimodal_alzheimer_tpu_torch.metrics.bootstrap import bootstrap_metric
from multimodal_alzheimer_tpu_torch.metrics.classification import (
    confusion_matrix,
    epoch_metrics,
    f1_macro,
    matthews_corrcoef,
    predictions_from_logits,
)
from multimodal_alzheimer_tpu_torch.train.checkpoint import (
    TopKCheckpointManager,
)
from multimodal_alzheimer_tpu_torch.train.logging import ExperimentLogger
from multimodal_alzheimer_tpu_torch.train.optim import (
    EarlyStopping,
    PlateauScheduler,
)
from multimodal_alzheimer_tpu_torch.train.state import (
    TrainState,
    make_eval_step,
    make_train_step,
)
from multimodal_alzheimer_tpu_torch.utils.device import resolve_device
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

LABEL_NAMES = {2: {"CN": 0, "AD": 1}, 3: {"CN": 0, "MCI": 1, "AD": 2}}


class _HostAccumulator:
    """Bounded device->host offload of per-step outputs: at most ``window``
    step outputs stay on the device, and they cross to the host together,
    so the loop does not wait for the device after every step."""

    def __init__(self, window: int = 32):
        self.window = max(1, int(window))
        self._pending: list = []
        self._host: list[np.ndarray] = []

    def append(self, tensor: torch.Tensor) -> None:
        self._pending.append(tensor)
        if len(self._pending) >= self.window:
            self.flush()

    def flush(self) -> None:
        self._host.extend(t.cpu().numpy() for t in self._pending)
        self._pending.clear()

    def values(self) -> list:
        """Flat list of host copies (for scalars)."""
        self.flush()
        return self._host

    def concatenated(self) -> torch.Tensor:
        self.flush()
        return torch.from_numpy(np.concatenate(self._host))


class Trainer:
    def __init__(self,
                 model: torch.nn.Module,
                 hparams: dict,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 criterion: Callable = None,
                 preprocess: Optional[Callable] = None,
                 logger: Optional[ExperimentLogger] = None,
                 checkpoint_dir: Optional[str] = None,
                 seed: int = 5,
                 log_confusion_images: bool = True,
                 device="cuda"):
        """``model`` moves to ``device``; build ``optimizer`` on the moved
        model's parameters (``Module.to`` keeps the parameter objects)."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.hparams = dict(hparams)
        self.optimizer = optimizer
        self.criterion = criterion
        self.preprocess = preprocess
        self.logger = logger
        self.n_classes = hparams["n_classes"]
        self.label_ind_by_names = LABEL_NAMES[self.n_classes]
        self.log_confusion_images = log_confusion_images

        self.train_step = (make_train_step(self.model, criterion, optimizer,
                                           preprocess)
                           if optimizer is not None else None)
        self.eval_step = make_eval_step(self.model, criterion, preprocess)

        # bootstrap resampling runs on the host copies of the outputs
        self.generator = make_generator(seed)
        self.val_loss_history: list[float] = []
        self.ckpt_managers = []
        if checkpoint_dir is not None:
            k = int(hparams.get("best_k_checkpoints", 3))
            self.ckpt_managers = [
                TopKCheckpointManager(checkpoint_dir, "val_loss_epoch",
                                      "min", k, filename_metric="val_loss"),
                TopKCheckpointManager(checkpoint_dir, "val_f1_epoch",
                                      "max", k, filename_metric="val_f1"),
            ]

    def init_state(self) -> TrainState:
        """The train state over the model's current weights; load a
        ``state_dict`` into the model first to start from one."""
        return TrainState(self.model, self.optimizer)

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def fit(self, state: TrainState, train_loader, val_loader,
            max_epochs: Optional[int] = None) -> tuple[TrainState, float]:
        """Runs the epoch loop; returns (state, last val loss), the value
        the reference returns to optuna (train_pet_cnn.py:204-205)."""
        max_epochs = max_epochs or self.hparams.get("max_epochs", 20)
        patience = self.hparams.get("early_stopping_patience", 5)
        early_stopping = EarlyStopping(patience)
        plateau = None
        if self.hparams.get("reduce_factor_lr_schedule"):
            plateau = PlateauScheduler(
                factor=float(self.hparams["reduce_factor_lr_schedule"]))

        for epoch in range(max_epochs):
            t0 = time.time()
            state, train_metrics, n_train = self._run_train_epoch(
                state, train_loader)
            val_metrics = self._run_eval_epoch(val_loader, prefix="val")
            self.val_loss_history.append(val_metrics["val_loss_epoch"])

            scalars = {**train_metrics, **val_metrics,
                       "epoch_time_s": time.time() - t0,
                       "train_volumes_per_s":
                           n_train / max(time.time() - t0, 1e-9),
                       "lr_scale": float(state.lr_scale),
                       "step": float(epoch)}
            if self.logger is not None:
                self.logger.log_scalars(scalars, epoch)

            for manager in self.ckpt_managers:
                manager.consider(epoch, val_metrics, state.state_dict(),
                                 self.hparams)

            if plateau is not None:
                state.lr_scale = plateau.step(val_metrics["val_loss_epoch"])
            if early_stopping.step(val_metrics["val_loss_epoch"]):
                break

        return state, self.val_loss_history[-1]

    def _run_train_epoch(self, state, loader):
        window = int(self.hparams.get("host_offload_every", 32))
        losses = _HostAccumulator(window)
        all_logits = _HostAccumulator(window)
        all_labels = _HostAccumulator(window)
        n_samples = 0
        for batch in loader:
            state, aux = self.train_step(state, self._to_device(batch))
            losses.append(aux["loss"])
            all_logits.append(aux["logits"])
            all_labels.append(aux["labels"])
            n_samples += int(aux["labels"].shape[0])
        losses = [float(l) for l in losses.values()]
        logits = all_logits.concatenated()
        labels = all_labels.concatenated()
        m = epoch_metrics(logits, labels, self.n_classes)
        scalars = {
            "train_loss_epoch": float(np.mean(losses)),
            "train_f1_epoch": float(m["f1"]),
        }
        for i in range(self.n_classes):
            scalars[f"train_f1_epoch_class_{i}"] = float(m[f"f1_class_{i}"])
        self._log_confusion("train_confusion_matrix", logits, labels)
        return state, scalars, n_samples

    def _run_eval_epoch(self, loader, prefix: str = "val"):
        window = int(self.hparams.get("host_offload_every", 32))
        losses = _HostAccumulator(window)
        all_logits = _HostAccumulator(window)
        all_labels = _HostAccumulator(window)
        for batch in loader:
            aux = self.eval_step(self._to_device(batch))
            losses.append(aux["loss"])
            all_logits.append(aux["logits"])
            all_labels.append(aux["labels"])
        losses = [float(l) for l in losses.values()]
        logits = all_logits.concatenated()
        labels = all_labels.concatenated()
        m = epoch_metrics(logits, labels, self.n_classes)
        # Lightning averages the per-batch losses (unweighted mean over
        # batches, base_model.py:113-115)
        scalars = {
            f"{prefix}_loss_epoch": float(np.mean(losses)),
            f"{prefix}_f1_epoch": float(m["f1"]),
        }
        for i in range(self.n_classes):
            scalars[f"{prefix}_f1_epoch_class_{i}"] = \
                float(m[f"f1_class_{i}"])
        self._log_confusion(f"{prefix}_confusion_matrix", logits, labels)
        self._last_eval = {"logits": logits, "labels": labels}
        return scalars

    def test(self, test_loader, out_dir: Optional[str] = None,
             n_bootstrap: int = 1000) -> dict:
        """Full test protocol: epoch metrics + bootstrap F1/MCC CIs + the
        three confusion-matrix PNGs (base_model.py:135-217)."""
        scalars = self._run_eval_epoch(test_loader, prefix="test")
        logits = self._last_eval["logits"]
        labels = self._last_eval["labels"]
        f1_mean, f1_ci = bootstrap_metric(f1_macro, logits, labels,
                                          self.n_classes, self.generator,
                                          n_bootstrap)
        mcc_mean, mcc_ci = bootstrap_metric(matthews_corrcoef, logits,
                                            labels, self.n_classes,
                                            self.generator, n_bootstrap)
        scalars.update({
            "test_f1_epoch_boot": float(f1_mean),
            "test_f1_epoch_ci": float(f1_ci),
            "test_mcc_epoch_boot": float(mcc_mean),
            "test_mcc_epoch_ci": float(mcc_ci),
        })
        if out_dir is None and self.logger is not None:
            out_dir = str(self.logger.log_dir)
        if out_dir is not None:
            from multimodal_alzheimer_tpu_torch.metrics.confusion_plot import (
                save_confusion_matrix_pngs,
            )

            save_confusion_matrix_pngs(self._confusion(logits, labels),
                                       self.label_ind_by_names, out_dir)
        if self.logger is not None:
            self.logger.log_scalars(scalars, 0)
        return scalars

    def _confusion(self, logits, labels) -> np.ndarray:
        preds = predictions_from_logits(logits)
        return confusion_matrix(preds, labels, self.n_classes).numpy()

    def _log_confusion(self, tag: str, logits, labels) -> None:
        if self.logger is None or not self.log_confusion_images:
            return
        from multimodal_alzheimer_tpu_torch.metrics.confusion_plot import (
            confusion_matrix_image,
        )

        image = confusion_matrix_image(self._confusion(logits, labels),
                                       self.label_ind_by_names)
        self.logger.log_image(tag, image, 0)
