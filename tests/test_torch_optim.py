"""The port's optimizer, schedulers and checkpoints against the JAX package.

``build_optimizer`` gives ``torch.optim.Adam`` one group per label; it must
move parameters as JAX's optax chain ``add_decayed_weights -> scale_by_adam
-> scale(-lr)`` does, with ``lr_scale`` applied as JAX scales the updates.
Tolerance: atol 1e-5 after three steps at lr 0.1. optax forms the bias
correction ``1 - 0.999^t`` in f32, where it cancels to a relative error of
up to about 6e-5, 3e-5 after the square root: up to 3e-6 per step of size
0.1 (torch forms it in double and lands within 1e-7 of a float64 Adam).
Schedulers and the top-k managers are host logic and must agree exactly.
"""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

import multimodal_alzheimer_tpu.train.checkpoint as jax_checkpoint
from multimodal_alzheimer_tpu.train import optim as jax_optim
from multimodal_alzheimer_tpu_torch.train import checkpoint, optim
from multimodal_alzheimer_tpu_torch.train.logging import ExperimentLogger
from multimodal_alzheimer_tpu_torch.train.state import (
    TrainState,
    _set_learning_rates,
)
from torch_threads import torch_threads  # noqa: F401 (autouse)


class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = torch.nn.Linear(5, 4)
        self.head = torch.nn.Linear(4, 3)


def _params_tree(model):
    return {name: p.detach().numpy().copy()
            for name, p in model.named_parameters()}


@pytest.mark.parametrize("lr_pretrained", [None, 1e-2])
@pytest.mark.parametrize("lr_scale", [1.0, 0.5])
def test_adam_groups_match_optax(lr_pretrained, lr_scale):
    torch.manual_seed(0)
    model = _Toy()
    label = optim.head_pretrained_label_fn(("head",), lr_pretrained)
    jax_label = jax_optim.head_pretrained_label_fn(("head",), lr_pretrained)
    group_lrs = {"head": 1e-1, "pretrained": lr_pretrained}
    opt = optim.build_optimizer(group_lrs, label, model, l2_reg=1e-2)
    jax_opt = jax_optim.build_optimizer(
        group_lrs, lambda path: jax_label(tuple(path[0].split("."))),
        l2_reg=1e-2)
    params = _params_tree(model)
    jax_state = jax_opt.init(params)
    state = TrainState(model, opt, lr_scale=lr_scale)
    rng = np.random.default_rng(1)
    for _ in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in params.items()}
        updates, jax_state = jax_opt.update(grads, jax_state, params)
        updates = jax.tree_util.tree_map(lambda u: u * lr_scale, updates)
        params = optax.apply_updates(params, updates)
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[name])
        _set_learning_rates(opt, state.lr_scale)
        opt.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[name]),
                                   rtol=0, atol=1e-5, err_msg=name)
    frozen = lr_pretrained is None
    assert len(opt.param_groups) == (1 if frozen else 2)
    assert all(g["lr"] == g["base_lr"] * lr_scale for g in opt.param_groups)


def test_build_optimizer_refuses_unnamed_labels_and_all_frozen():
    model = _Toy()
    with pytest.raises(KeyError, match="group_lrs"):
        optim.build_optimizer({"head": 1e-3}, lambda path: "other", model)
    with pytest.raises(ValueError, match="frozen"):
        optim.build_optimizer({"head": None}, lambda path: "head", model)


def test_single_lr_optimizer_trains_everything():
    model = _Toy()
    opt = optim.single_lr_optimizer(model, 1e-3, 1e-4)
    assert sum(len(g["params"]) for g in opt.param_groups) == 4
    assert opt.param_groups[0]["weight_decay"] == 1e-4


@pytest.mark.parametrize("factor,patience,cooldown", [(0.5, 2, 0),
                                                      (0.1, 1, 2)])
def test_plateau_scheduler_matches_jax(factor, patience, cooldown):
    metrics = [1.0, 0.9, 0.95, 0.97, 0.99, 0.8, 0.8, 0.81, 0.85, 0.7, 0.9]
    ours = optim.PlateauScheduler(factor, patience, cooldown=cooldown)
    theirs = jax_optim.PlateauScheduler(factor, patience, cooldown=cooldown)
    assert [ours.step(m) for m in metrics] == \
        [theirs.step(m) for m in metrics]


def test_early_stopping_matches_jax():
    metrics = [1.0, 0.9, 0.95, 0.97, 0.85, 0.9, 0.9, 0.9]
    ours, theirs = optim.EarlyStopping(3), jax_optim.EarlyStopping(3)
    assert [ours.step(m) for m in metrics] == \
        [theirs.step(m) for m in metrics]


@pytest.mark.parametrize("mode,metric", [("min", "val_loss_epoch"),
                                         ("max", "val_f1_epoch")])
def test_top_k_names_and_eviction_match_jax(tmp_path, monkeypatch, mode,
                                            metric):
    """Same directories kept for the same metric sequence (the JAX side's
    orbax writes are replaced by an empty directory)."""
    monkeypatch.setattr(jax_checkpoint, "save_checkpoint",
                        lambda path, *a, **k: os.makedirs(path))
    ours = checkpoint.TopKCheckpointManager(tmp_path / "port", metric, mode,
                                            2, "val")
    theirs = jax_checkpoint.TopKCheckpointManager(tmp_path / "jax", metric,
                                                  mode, 2, "val")
    sd = {"w": torch.ones(2)}
    for epoch, value in enumerate([0.5, 0.4, 0.6, 0.45, 0.3]):
        a = ours.consider(epoch, {metric: value}, sd, {"n_classes": 2})
        b = theirs.consider(epoch, {metric: value}, {}, {})
        assert (a is None) == (b is None)
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    assert ours.best_value == theirs.best_value
    assert os.path.basename(ours.best_path) == \
        os.path.basename(theirs.best_path)


def test_checkpoint_round_trip(tmp_path):
    model = _Toy()
    hparams = {"n_classes": 2, "weights": np.array([0.5, 0.5]),
               "lr": np.float32(1e-3)}
    checkpoint.save_checkpoint(tmp_path / "ckpt", model.state_dict(),
                               hparams, {"val_loss_epoch": torch.tensor(0.5)})
    sd, hp, metrics = checkpoint.load_checkpoint(tmp_path / "ckpt")
    assert hp == {"n_classes": 2, "weights": [0.5, 0.5],
                  "lr": pytest.approx(1e-3)}
    assert metrics == {"val_loss_epoch": 0.5}
    for key, value in model.state_dict().items():
        assert torch.equal(sd[key], value)
    checkpoint.save_checkpoint(tmp_path / "ckpt", model.state_dict(), {})
    assert not (tmp_path / "ckpt" / "metrics.json").exists()


def test_logger_writes_jsonl_and_versions(tmp_path):
    first = ExperimentLogger(str(tmp_path), "exp")
    first.log_scalars({"loss": torch.tensor(0.25), "vec": np.ones(2)}, 3)
    first.log_hparams({"lr": np.float32(0.5)})
    first.close()
    second = ExperimentLogger(str(tmp_path), "exp")
    second.close()
    assert first.log_dir.name == "version_0"
    assert second.log_dir.name == "version_1"
    record = json.loads((first.log_dir / "metrics.jsonl").read_text())
    assert record["step"] == 3 and record["loss"] == 0.25
    assert "vec" not in record
    assert json.loads((first.log_dir / "hparams.json").read_text()) == {
        "lr": 0.5}
