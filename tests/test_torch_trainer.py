"""Two epochs of the port's ``Trainer.fit`` against the JAX ``Trainer`` (CPU).

A ResNet-10 ``AnatCNN`` with ``fused_bn="full"`` (the JAX BatchNorm kernels
in interpret mode, the port's plain versions) starts from the same
converted weights on both sides and trains on the same tiny
``ArrayDataset``: 8 training scans in shuffled batches of 4 (the same
shuffle from the same seed), 4 validation scans, with the min-max
preprocess inside the step. The validation-loss history must agree within
rtol 1e-4 and both top-k managers must keep checkpoints of the same names.
"""

import copy
import os

import jax
import numpy as np
import pytest

from multimodal_alzheimer_tpu.data.dataset import MultiModalDataset
from multimodal_alzheimer_tpu.data.pipeline import DataLoader as JaxLoader
from multimodal_alzheimer_tpu.data.synthetic import (
    ArrayDataset as JaxArrayDataset,
    make_labeled_volumes as jax_labeled_volumes,
)
from multimodal_alzheimer_tpu.losses import make_criterion as jax_criterion
from multimodal_alzheimer_tpu.models.mri_models.train_anat_cnn import (
    backbone_head_optimizer,
)
from multimodal_alzheimer_tpu.ops import pallas_bn
from multimodal_alzheimer_tpu.train.loop import Trainer as JaxTrainer
from multimodal_alzheimer_tpu_torch.data.pipeline import DataLoader
from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.data.synthetic import (
    ArrayDataset,
    make_labeled_volumes,
)
from multimodal_alzheimer_tpu_torch.losses.classification import (
    make_criterion,
)
from multimodal_alzheimer_tpu_torch.train.checkpoint import load_checkpoint
from multimodal_alzheimer_tpu_torch.train.loop import Trainer
from multimodal_alzheimer_tpu_torch.train.optim import (
    build_optimizer,
    head_pretrained_label_fn,
)
from multimodal_alzheimer_tpu_torch.train.state import make_eval_step
from torch_port_helpers import model_pair

SHAPE = (12, 14, 12)
HPARAMS = {"n_classes": 2, "resnet_depth": 10, "lr": 1e-4,
           "lr_pretrained": 1e-5, "l2_reg": 1e-2, "batch_size": 4,
           "max_epochs": 2, "best_k_checkpoints": 1}
MINMAX = {"per_scan_norm": "min_max"}
SEED = 3


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_bn, "INTERPRET", True)


def _split(data, lo, hi):
    return {k: v[lo:hi] for k, v in data.items()}


def _names(root):
    return sorted(os.listdir(root))


def test_fit_matches_the_jax_trainer(tmp_path):
    data = make_labeled_volumes(12, SHAPE, n_classes=2, seed=SEED)
    jax_data = jax_labeled_volumes(12, SHAPE, n_classes=2, seed=SEED)
    for key, value in data.items():
        np.testing.assert_array_equal(value, jax_data[key])
    jax_model, variables, port = model_pair(HPARAMS, SHAPE, seed=SEED,
                                            fused_bn="full")

    holder = type("Holder", (), {"normalize_pet": None,
                                 "normalize_mri": MINMAX,
                                 "quantile": 0.99})()
    jax_trainer = JaxTrainer(
        jax_model, HPARAMS, backbone_head_optimizer(HPARAMS, None),
        jax_criterion(HPARAMS),
        preprocess=MultiModalDataset.get_device_preprocess(holder),
        checkpoint_dir=str(tmp_path / "jax"), seed=SEED,
        log_confusion_images=False)
    state = jax_trainer.init_state(
        {k: v[:1] for k, v in _split(jax_data, 0, 1).items()},
        variables_transform=lambda _: jax.tree_util.tree_map(
            jax.numpy.asarray, variables))
    _, jax_last = jax_trainer.fit(
        state,
        JaxLoader(JaxArrayDataset(_split(jax_data, 0, 8)), 4, shuffle=True,
                  seed=SEED, num_workers=1),
        JaxLoader(JaxArrayDataset(_split(jax_data, 8, 12)), 4,
                  num_workers=1))

    optimizer = build_optimizer(
        {"head": HPARAMS["lr"], "pretrained": HPARAMS["lr_pretrained"]},
        head_pretrained_label_fn(("head",), HPARAMS["lr_pretrained"]), port,
        HPARAMS["l2_reg"])
    trainer = Trainer(
        port, HPARAMS, optimizer, make_criterion(HPARAMS),
        preprocess=make_device_preprocess(normalize_mri=MINMAX,
                                          quantile=0.99),
        checkpoint_dir=str(tmp_path / "port"), seed=SEED,
        log_confusion_images=False, device="cpu")
    state, last = trainer.fit(
        trainer.init_state(),
        DataLoader(ArrayDataset(_split(data, 0, 8)), 4, shuffle=True,
                   seed=SEED, num_workers=1, device="cpu"),
        DataLoader(ArrayDataset(_split(data, 8, 12)), 4, num_workers=1,
                   device="cpu"))

    assert state.step == 4
    assert len(trainer.val_loss_history) == 2
    np.testing.assert_allclose(trainer.val_loss_history,
                               jax_trainer.val_loss_history, rtol=1e-4)
    np.testing.assert_allclose(last, jax_last, rtol=1e-4)
    assert _names(tmp_path / "port") == _names(tmp_path / "jax")
    assert len(_names(tmp_path / "port")) == 2  # one per manager

    # the best checkpoint loads back and scores its recorded val loss
    state_dict, hparams, metrics = load_checkpoint(
        trainer.ckpt_managers[0].best_path)
    assert hparams["resnet_depth"] == 10
    assert metrics["val_loss_epoch"] == min(trainer.val_loss_history)
    restored = copy.deepcopy(port)
    restored.load_state_dict(state_dict)
    eval_step = make_eval_step(restored, make_criterion(HPARAMS),
                               trainer.preprocess)
    losses = [float(eval_step(b)["loss"]) for b in DataLoader(
        ArrayDataset(_split(data, 8, 12)), 4, num_workers=1, device="cpu")]
    np.testing.assert_allclose(np.mean(losses), metrics["val_loss_epoch"],
                               rtol=1e-6)
