"""Shared evaluation harness (reference pkg/utils/test.py parity).

Port of ``multimodal_alzheimer_tpu/inference/harness.py``. ``evaluate``
seeds, builds the test loader at the checkpoint's batch size, runs the full
test protocol (epoch metrics, bootstrap F1/MCC CIs, the confusion counts
and, with ``confusion_pngs``, the three confusion-matrix PNGs) and logs
under ``lightning_logs/<experiment_name>`` (reference: test.py:6-38,
base_model.py:135-217). ``evaluate_checkpoint`` does the same from a
checkpoint of the port (``train/checkpoint.py``: ``state.pt`` +
``hparams.json``). A JAX-package checkpoint is converted on a host that has
JAX, with ``models/convert.py``, and saved with ``save_checkpoint`` first.

Reference quirk kept: every test set is built with ALL THREE modalities
whatever the model (test_pet_cnn.py:17 etc.), so every model is scored on
the same fully paired test samples.
"""

from __future__ import annotations

from typing import Optional

from multimodal_alzheimer_tpu_torch.data.dataset import MultiModalDataset
from multimodal_alzheimer_tpu_torch.data.pipeline import DataLoader
from multimodal_alzheimer_tpu_torch.losses.classification import (
    make_criterion,
)
from multimodal_alzheimer_tpu_torch.train.checkpoint import load_checkpoint
from multimodal_alzheimer_tpu_torch.train.logging import ExperimentLogger
from multimodal_alzheimer_tpu_torch.train.loop import Trainer
from multimodal_alzheimer_tpu_torch.utils.path_config import load_path_config
from multimodal_alzheimer_tpu_torch.utils.seeding import seed_everything

ALL_MODALITIES = ["pet1451", "t1w", "tabular"]


def build_testset(hparams: dict, normalize_pet=None, normalize_mri=None,
                  quantile: float = 0.99,
                  test_csv: Optional[str] = None) -> MultiModalDataset:
    if test_csv is None:
        test_csv = str(load_path_config()["test_set_csv"])
    return MultiModalDataset(
        path=test_csv,
        modalities=list(ALL_MODALITIES),
        normalize_pet=normalize_pet,
        normalize_mri=normalize_mri,
        quantile=quantile,
        binary_classification=hparams["n_classes"] == 2)


def evaluate(model, state_dict: Optional[dict], hparams: dict,
             testset: MultiModalDataset, experiment_name: str,
             num_workers: int = 8, confusion_pngs: bool = True,
             device="cuda") -> dict:
    """The test protocol for ``model`` with ``state_dict`` loaded (None
    keeps its weights). ``confusion_pngs`` renders the confusion-matrix
    images, which needs the plotting packages; the counts are written to
    ``confusion_matrix.json`` in the log directory either way."""
    seed_everything(5)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    loader = DataLoader(testset, hparams["batch_size"],
                        num_workers=num_workers, device=device)
    logger = ExperimentLogger(save_dir="lightning_logs",
                              name=experiment_name)
    trainer = Trainer(model, hparams, criterion=make_criterion(hparams),
                      preprocess=testset.get_device_preprocess(),
                      logger=logger, seed=5,
                      log_confusion_images=confusion_pngs, device=device)
    metrics = trainer.test(loader, confusion_pngs=confusion_pngs)
    logger.close()
    return metrics


def evaluate_checkpoint(model_cls_from_hparams, checkpoint_path: str,
                        experiment_name: str,
                        normalization_from=None, confusion_pngs: bool = True,
                        device="cuda", **kwargs) -> dict:
    """Load a checkpoint, rebuild the model from its hparams, and run the
    test protocol. ``normalization_from`` maps the hparams to the (pet,
    mri, quantile) normalisation configs; ``test_csv`` in ``kwargs``
    overrides ``path_config.yaml``'s test set."""
    state_dict, hparams, _ = load_checkpoint(checkpoint_path)
    model = model_cls_from_hparams(hparams)
    normalize_pet = normalize_mri = None
    quantile = 0.99
    if normalization_from is not None:
        normalize_pet, normalize_mri, quantile = normalization_from(hparams)
    testset = build_testset(hparams, normalize_pet, normalize_mri, quantile,
                            kwargs.get("test_csv"))
    return evaluate(model, state_dict, hparams, testset, experiment_name,
                    confusion_pngs=confusion_pngs, device=device)
