"""The training loop (Lightning Trainer replacement).

Port of ``multimodal_alzheimer_tpu/train/loop.py``, after the reference
training template (train_pet_cnn.py:121-205): an epoch loop with train and
validation phases, per-epoch macro/per-class F1 and loss,
TensorBoard logging with confusion-matrix images, EarlyStopping on
``val_loss_epoch``, two top-k checkpoint managers (val_loss min, val_f1
max), ReduceLROnPlateau on ``val_loss_epoch``, and a ``val_loss`` history
whose last entry is the HPO objective (ValidationLossTracker,
train_pet_cnn.py:17-29). A model with ``share_towers`` (the stage-3
fusion) has its duplicate towers synced in every checkpoint it saves.
``test`` adds bootstrap F1 and MCC with CIs,
writes the confusion counts to ``confusion_matrix.json`` and, when the
caller asks for them, the three confusion-matrix PNGs (base_model.py:135-217).

With ``mesh=`` (a ``parallel.Mesh``, one process per rank, every rank
running the same loop) the state is replicated from rank 0, each batch is
placed as the rank's rows (``_place``; a ragged tail whose rows do not
split evenly over the ranks runs whole on every rank), and the steps
return the global batch's outputs. The epoch metrics, F1, MCC and the
bootstrap are computed from them on rank 0 and broadcast, so early
stopping and the plateau scheduler decide alike on every rank; the logger,
the top-k checkpoints and the test files are written by rank 0 only.

Rendering images needs matplotlib, seaborn, pandas and PIL, which a machine
that only trains may not have: the PNGs of ``test`` (``confusion_pngs``) and
the per-epoch TensorBoard images (``log_confusion_images``) are each the
caller's explicit choice, on by default as in the JAX package. Neither
is skipped quietly when the packages are missing: the import fails.
"""

from __future__ import annotations

import json
import os
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
from multimodal_alzheimer_tpu_torch.parallel.mesh import (
    BatchShard,
    Mesh,
    batch_rows,
    replicate,
    shard_batch,
)
from multimodal_alzheimer_tpu_torch.train.checkpoint import (
    TopKCheckpointManager,
    sync_tower_duplicates,
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
                 device="cuda", mesh: Optional[Mesh] = None):
        """``model`` moves to ``device`` (the mesh's device with ``mesh``);
        build ``optimizer`` on the moved model's parameters (``Module.to``
        keeps the parameter objects). Under a mesh only rank 0 uses
        ``logger`` and ``checkpoint_dir``."""
        self.mesh = mesh
        self.lead = mesh is None or mesh.rank == 0
        self.device = mesh.device if mesh is not None else \
            resolve_device(device)
        self.model = model.to(self.device)
        self.hparams = dict(hparams)
        self.optimizer = optimizer
        self.criterion = criterion
        self.preprocess = preprocess
        self.logger = logger if self.lead else None
        self.n_classes = hparams["n_classes"]
        self.label_ind_by_names = LABEL_NAMES[self.n_classes]
        self.log_confusion_images = log_confusion_images

        # the dropout masks of the train steps (JAX splits a step key from
        # its root key, train/loop.py:226)
        self.dropout_generator = make_generator(seed, self.device)
        self.train_step = (make_train_step(self.model, criterion, optimizer,
                                           preprocess, self.dropout_generator,
                                           mesh)
                           if optimizer is not None else None)
        self.eval_step = make_eval_step(self.model, criterion, preprocess,
                                        mesh)

        # bootstrap resampling runs on the host copies of the outputs
        self.generator = make_generator(seed)
        self.val_loss_history: list[float] = []
        self.ckpt_managers = []
        if checkpoint_dir is not None and self.lead:
            k = int(hparams.get("best_k_checkpoints", 3))
            self.ckpt_managers = [
                TopKCheckpointManager(checkpoint_dir, "val_loss_epoch",
                                      "min", k, filename_metric="val_loss"),
                TopKCheckpointManager(checkpoint_dir, "val_f1_epoch",
                                      "max", k, filename_metric="val_f1"),
            ]

    def init_state(self) -> TrainState:
        """The train state over the model's current weights (rank 0's,
        replicated, under a mesh); load a ``state_dict`` into the model
        first to start from one."""
        state = TrainState(self.model, self.optimizer)
        if self.mesh is not None:
            replicate(state, self.mesh)
        return state

    def _place(self, batch: dict) -> dict:
        """The batch on the device: under a mesh the rank's rows, unless
        the loader placed them already or the rows do not split evenly over
        the ranks (then every rank runs the whole batch)."""
        if isinstance(batch, BatchShard):
            return batch
        if self.mesh is not None and \
                batch_rows(batch) % self.mesh.size == 0:
            return shard_batch(batch, self.mesh)
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _on_lead(self, fn):
        """``fn()``, computed on rank 0 and broadcast under a mesh."""
        if self.mesh is None:
            return fn()
        return self.mesh.broadcast_object(fn() if self.lead else None)

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

            if self.ckpt_managers:
                state_dict = state.state_dict()
                if getattr(self.model, "share_towers", False):
                    # the shared forward only updates the canonical towers'
                    # BatchNorm statistics; saved checkpoints mirror them to
                    # the duplicates, as the unshared (reference) regime
                    # would have updated both
                    state_dict = sync_tower_duplicates(state_dict)
                for manager in self.ckpt_managers:
                    manager.consider(epoch, val_metrics, state_dict,
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
            state, aux = self.train_step(state, self._place(batch))
            losses.append(aux["loss"])
            all_logits.append(aux["logits"])
            all_labels.append(aux["labels"])
            n_samples += int(aux["labels"].shape[0])
        losses = [float(l) for l in losses.values()]
        logits = all_logits.concatenated()
        labels = all_labels.concatenated()
        scalars = self._on_lead(lambda: self._epoch_scalars(
            "train", losses, logits, labels))
        self._log_confusion("train_confusion_matrix", logits, labels)
        return state, scalars, n_samples

    def _epoch_scalars(self, prefix: str, losses, logits, labels) -> dict:
        # Lightning averages the per-batch losses (unweighted mean over
        # batches, base_model.py:113-115)
        m = epoch_metrics(logits, labels, self.n_classes)
        scalars = {
            f"{prefix}_loss_epoch": float(np.mean(losses)),
            f"{prefix}_f1_epoch": float(m["f1"]),
        }
        for i in range(self.n_classes):
            scalars[f"{prefix}_f1_epoch_class_{i}"] = \
                float(m[f"f1_class_{i}"])
        return scalars

    def _run_eval_epoch(self, loader, prefix: str = "val"):
        window = int(self.hparams.get("host_offload_every", 32))
        losses = _HostAccumulator(window)
        all_logits = _HostAccumulator(window)
        all_labels = _HostAccumulator(window)
        for batch in loader:
            aux = self.eval_step(self._place(batch))
            losses.append(aux["loss"])
            all_logits.append(aux["logits"])
            all_labels.append(aux["labels"])
        losses = [float(l) for l in losses.values()]
        logits = all_logits.concatenated()
        labels = all_labels.concatenated()
        scalars = self._on_lead(lambda: self._epoch_scalars(
            prefix, losses, logits, labels))
        self._log_confusion(f"{prefix}_confusion_matrix", logits, labels)
        self._last_eval = {"logits": logits, "labels": labels}
        return scalars

    def test(self, test_loader, out_dir: Optional[str] = None,
             n_bootstrap: int = 1000, confusion_pngs: bool = True) -> dict:
        """Full test protocol: epoch metrics, bootstrap F1/MCC CIs, and in
        ``out_dir`` (the logger's directory by default) the confusion counts
        as ``confusion_matrix.json`` and, with ``confusion_pngs``, the three
        confusion-matrix PNGs (base_model.py:135-217)."""
        scalars = self._run_eval_epoch(test_loader, prefix="test")
        logits = self._last_eval["logits"]
        labels = self._last_eval["labels"]
        scalars.update(self._on_lead(
            lambda: self._bootstrap(logits, labels, n_bootstrap)))
        if out_dir is None and self.logger is not None:
            out_dir = str(self.logger.log_dir)
        if out_dir is not None and self.lead:
            cm = self._confusion(logits, labels)
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "confusion_matrix.json"),
                      "w") as f:
                json.dump({"labels": self.label_ind_by_names,
                           "counts": cm.astype(np.int64).tolist()}, f,
                          indent=2)
            if confusion_pngs:
                from multimodal_alzheimer_tpu_torch.metrics.confusion_plot \
                    import save_confusion_matrix_pngs

                save_confusion_matrix_pngs(cm, self.label_ind_by_names,
                                           out_dir)
        if self.logger is not None:
            self.logger.log_scalars(scalars, 0)
        return scalars

    def _bootstrap(self, logits, labels, n_bootstrap: int) -> dict:
        f1_mean, f1_ci = bootstrap_metric(f1_macro, logits, labels,
                                          self.n_classes, self.generator,
                                          n_bootstrap)
        mcc_mean, mcc_ci = bootstrap_metric(matthews_corrcoef, logits,
                                            labels, self.n_classes,
                                            self.generator, n_bootstrap)
        return {"test_f1_epoch_boot": float(f1_mean),
                "test_f1_epoch_ci": float(f1_ci),
                "test_mcc_epoch_boot": float(mcc_mean),
                "test_mcc_epoch_ci": float(mcc_ci)}

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
