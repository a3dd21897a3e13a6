"""The port's tabular modality against the JAX package's (CPU).

``tabular_matrix`` over the dataset's rows against JAX's over a DataFrame
and against ``tabular_vector`` row by row: equal. ``compute_feature_stats``:
equal (both float64). ``TabularMLP`` from converted weights, with the
train split's standardisation: logits and the ``decoder`` tap in eval and
in train mode (dropout 0) within rtol 1e-5, atol 1e-6 in float32; in
bfloat16 within twice JAX's own bf16-vs-f32 distance of JAX's f32 result
(tests/test_torch_dtype.py). The 'tabular_embedding' pass-through and the
reference's (B, 1, 9) input the same way. ``train_tabular.train`` from the
JAX model's weights gives JAX's validation-loss history within rtol 1e-4
(tests/test_torch_driver.py), and ``test_tab.main`` evaluates its
checkpoint. The decision tree is held to JAX's (same sklearn calls) and
skips where sklearn is absent.
"""

import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.data import tabular as jax_tabular
from multimodal_alzheimer_tpu.models.tabular_models import (
    decision_tree as jax_decision_tree,
    tabular_mlp as jax_tabular_mlp,
    train_tabular as jax_train_tabular,
)
from multimodal_alzheimer_tpu.train import driver as jax_driver
from multimodal_alzheimer_tpu_torch.data.dataset import MultiModalDataset
from multimodal_alzheimer_tpu_torch.data.synthetic import (
    write_synthetic_split,
)
from multimodal_alzheimer_tpu_torch.data.tabular import (
    tabular_matrix,
    tabular_vector,
)
from multimodal_alzheimer_tpu_torch.inference import test_tab
from multimodal_alzheimer_tpu_torch.models.convert import state_dict_from_flax
from multimodal_alzheimer_tpu_torch.models.tabular_models import (
    decision_tree,
    train_tabular,
)
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp import (
    TabularMLP,
    compute_feature_stats,
)
from multimodal_alzheimer_tpu_torch.train.checkpoint import load_checkpoint
from torch_port_helpers import Trial, random_variables

F32_TOL = dict(rtol=1e-5, atol=1e-6)
SHAPE = (6, 7, 6)  # the test split's volumes: the harness reads them
HIDDEN = (16, 32)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("tabular_split")
    return write_synthetic_split(str(root / "data"), n_subjects=(16, 8, 8),
                                 seed=4, volume_shape=SHAPE)


@pytest.fixture(scope="module")
def rows(split):
    return MultiModalDataset(split["train"], modalities=["tabular"]).rows


@pytest.mark.parametrize("compat", [True, False])
def test_tabular_matrix_matches_jax(rows, compat):
    import pandas as pd

    got = tabular_matrix(rows, compat)
    assert got.shape == (len(rows), 9) and got.dtype == np.float32
    np.testing.assert_array_equal(
        got, jax_tabular.tabular_matrix(pd.DataFrame(rows), compat))
    np.testing.assert_array_equal(
        got, np.stack([tabular_vector(r, compat) for r in rows]))
    np.testing.assert_array_equal(
        got, np.stack([jax_tabular.tabular_vector(r, compat) for r in rows]))
    assert tabular_matrix([], compat).shape == (0, 9)


def test_compute_feature_stats_matches_jax(rows):
    x = tabular_matrix(rows)
    x[:, 3] = 7.0  # a constant feature: std 1
    mean, std = compute_feature_stats(x)
    want_mean, want_std = jax_tabular_mlp.compute_feature_stats(x)
    assert mean == want_mean and std == want_std and std[3] == 1.0


def _pair(rows, dtype=torch.float32, dropout_p=0.0, seed=0):
    """(JAX models by dtype, numpy variables, port model), standardised
    with the rows' statistics."""
    mean, std = compute_feature_stats(tabular_matrix(rows))
    hp = {"n_classes": 3, "hidden": HIDDEN, "dropout_p": dropout_p,
          "feature_mean": mean, "feature_std": std}
    jax_models = {dt: jax_tabular_mlp.TabularMLP.from_hparams(hp, dtype=dt)
                  for dt in (jnp.float32, jnp.bfloat16)}
    variables = random_variables(
        jax_models[jnp.float32], seed,
        {"tabular": jnp.zeros((1, 9), jnp.float32)}, train=False)
    port = TabularMLP.from_hparams(hp, dtype=dtype)
    port.load_state_dict(state_dict_from_flax(variables, port))
    return jax_models, variables, port


def _dist(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("key", ["tabular", "reference_3d",
                                 "tabular_embedding"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tabular_mlp_matches_jax(rows, dtype, key, train):
    """Logits and the decoder tap; in train mode with dropout 0."""
    torch_dtype = getattr(torch, dtype)
    jax_models, variables, port = _pair(rows, torch_dtype)
    x = tabular_matrix(rows)[:8]
    if key == "tabular":
        batch = {"tabular": x}
    elif key == "reference_3d":
        batch = {"tabular": x[:, None, :]}
    else:  # the trunk is skipped: the embedding is the decoder tap
        emb = np.random.default_rng(3).normal(size=(8, HIDDEN[-1]))
        batch = {"tabular": x, "tabular_embedding": emb.astype(np.float32)}
    want = {dt: m.apply(variables, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, train=train)
            for dt, m in jax_models.items()}
    port.train(train)
    got = port({k: torch.from_numpy(v) for k, v in batch.items()})
    assert got["logits"].dtype == torch.float32
    assert got["embeddings"]["decoder"].dtype == torch_dtype
    if key == "tabular_embedding":
        np.testing.assert_array_equal(
            got["embeddings"]["decoder"].float().numpy(),
            batch["tabular_embedding"].astype(
                np.float32 if dtype == "float32" else jnp.bfloat16))
    for name, g, w32, w16 in (
            ("logits", got["logits"], want[jnp.float32]["logits"],
             want[jnp.bfloat16]["logits"]),
            ("decoder", got["embeddings"]["decoder"],
             want[jnp.float32]["embeddings"]["decoder"],
             want[jnp.bfloat16]["embeddings"]["decoder"])):
        g = g.detach().float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, np.asarray(w32), **F32_TOL,
                                       err_msg=name)
        else:
            ref = _dist(np.asarray(w16, np.float32), w32)
            assert _dist(g, w32) <= 2 * ref, (name, _dist(g, w32), ref)


def test_dropout_follows_the_mode(rows):
    """dropout_p > 0: eval equals JAX's; train drops and rescales."""
    jax_models, variables, port = _pair(rows, dropout_p=0.5)
    assert [n for n, _ in port.named_children()] == [
        "dense_0", "dropout_0", "dense_1", "dropout_1", "cls"]
    x = tabular_matrix(rows)[:8]
    want = jax_models[jnp.float32].apply(variables,
                                         {"tabular": jnp.asarray(x)})
    got = port.eval()({"tabular": torch.from_numpy(x)})
    np.testing.assert_allclose(got["logits"].detach().numpy(),
                               np.asarray(want["logits"]), **F32_TOL)
    port.train()
    dec = port({"tabular": torch.from_numpy(x)})["embeddings"]["decoder"]
    assert 0 < (dec == 0).float().mean() < 1


def test_fusion_tap_and_from_hparams(rows):
    model = TabularMLP.from_hparams({"n_classes": 2})
    assert model.hidden == (256, 1024) and not model.standardize
    assert model.fusion_tap() == "decoder"
    assert "feature_mean" not in _pair(rows)[2].state_dict()


@pytest.mark.parametrize("seed", range(4))
def test_sample_hparams_matches_jax(seed):
    port_trial, jax_trial = Trial(seed), Trial(seed)
    assert train_tabular.sample_hparams(port_trial) == \
        jax_train_tabular.sample_hparams(jax_trial)
    assert port_trial.calls == jax_trial.calls
    for name in ("SEED", "LOG_DIRECTORY", "EXPERIMENT_NAME"):
        assert getattr(train_tabular, name) == getattr(jax_train_tabular,
                                                       name)


def _history(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["val_loss_epoch"] for line in f]


def test_train_tabular_matches_the_jax_entry_point(split, tmp_path,
                                                   monkeypatch):
    """Three epochs at batch 8 from the JAX model's weights, dropout 0;
    then test_tab.main() evaluates the best checkpoint."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MMALZ_DATA_DIR", os.path.dirname(split["train"]))
    hp = {"n_classes": 2, "lr": 1e-2, "batch_size": 8, "hidden": HIDDEN,
          "dropout_p": 0.0, "l2_reg": 1e-3, "fl_gamma": None,
          "max_epochs": 3, "early_stopping_patience": 5,
          "best_k_checkpoints": 1, "reduce_factor_lr_schedule": None}
    hp_jax = dict(hp)
    variables = random_variables(
        jax_tabular_mlp.TabularMLP.from_hparams(hp), 5,
        {"tabular": jnp.zeros((1, 9), jnp.float32)}, train=False)
    monkeypatch.setattr(jax_train_tabular, "run_training", partial(
        jax_driver.run_training, num_workers=1,
        variables_transform=lambda _: jax.tree.map(jnp.asarray, variables)))
    jax_last = jax_train_tabular.train(hp_jax, "jax")
    last = train_tabular.train(
        hp, "port", log_confusion_images=False, device="cpu", num_workers=1,
        variables_transform=lambda sd: state_dict_from_flax(
            variables, TabularMLP.from_hparams(hp)))
    # JAX's matrix is column-major (pandas), so numpy sums the float64
    # statistics in another order: equal to 1e-12.
    for key in ("feature_mean", "feature_std"):
        np.testing.assert_allclose(hp.pop(key), hp_jax.pop(key), rtol=1e-12)
    assert hp == hp_jax
    logs = tmp_path / train_tabular.LOG_DIRECTORY
    history = _history(logs / "port" / "version_0")
    assert len(history) == 3 and history[-1] == last
    np.testing.assert_allclose(history, _history(logs / "jax" / "version_0"),
                               rtol=1e-4)
    np.testing.assert_allclose(last, jax_last, rtol=1e-4)

    best = sorted((logs / "port" / "version_0" / "checkpoints").glob(
        "*val_loss=*"))[0]
    state_dict, hparams, _ = load_checkpoint(best)
    assert len(hparams["feature_std"]) == 9
    TabularMLP.from_hparams(hparams).load_state_dict(state_dict)
    (tmp_path / "path_config.yaml").write_text(
        "relative:\n"
        f"  test_set_csv: '{split['test']}'\n"
        f"tabular_mlp_2_class: '{best}'\n")
    results = test_tab.main(confusion_pngs=False, device="cpu")
    assert all(np.isfinite(v) for v in
               results["tabular_mlp_2_class"].values())


def test_decision_tree_matches_jax(rows):
    pytest.importorskip("sklearn")
    x = tabular_matrix(rows)
    y = np.asarray([r["label"] != "CN" for r in rows], np.int64)
    weights = {0: 0.4, 1: 0.6}
    clf = decision_tree.train_decision_tree(x, y, weights)
    ref = jax_decision_tree.train_decision_tree(x, y, weights)
    np.testing.assert_array_equal(clf.predict(x), ref.predict(x))
    np.testing.assert_array_equal(decision_tree.predict_mci(clf, x[:5]),
                                  jax_decision_tree.predict_mci(ref, x[:5]))
    assert clf.get_depth() <= 5
