"""The HPO entry points of the port's stage-1 trainers and the baselines.

* ``percentile_normalizer`` honours the searched q: the port's normalized
  split equals the JAX package's ``percentile_normalizer`` on the same files
  (quantiles exact, min-max within 1e-6 of max(1, |x|)), keeps one q
  resident and drops the memoised bounds.
* ``tabular._full_arrays`` equals JAX's.
* ``train_anat_fast``: the K-seed screen, then the checkpointed
  continuation, which starts from the screen winner's snapshot.
* ``optuna_optimization()`` with ``parallel`` left at 0 (one trial after
  another, each through the module's ``_objective`` and ``train``) of
  ``train_anat_cnn``, ``train_pet_cnn``, ``train_pet_resnet_cnn`` and
  ``train_tabular``: one trial, told a finite-or-inf value.
* ``optuna_optimization(parallel=2)`` of ``train_anat_cnn``,
  ``train_tabular``, ``train_pet_cnn``, ``train_pet_resnet_cnn`` and
  ``train_anat_pet_featuremapfusion`` on splits written by the port: every
  trial is told a finite-or-inf value. The studies are the port's TPE shim
  (no optuna), the ResNet ones seeded to draw ResNet-10s; each proposal's
  epoch budget is cut to one to keep the run short. The MRI and tabular
  runs use (12, 14, 12); the PET CNN and the feature-map fusion use
  (19, 23, 17), the smallest grid the deepest sampleable conv ladder
  survives (four pools), as in the JAX package's tests.
"""

import math
import os

import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.models.mri_models import (
    train_anat_cnn as jax_train_anat_cnn,
)
from multimodal_alzheimer_tpu.models.tabular_models import (
    train_tabular as jax_train_tabular,
)
from multimodal_alzheimer_tpu.train import fusion_hpo as jax_fusion_hpo
from multimodal_alzheimer_tpu.train.driver import (
    build_datasets as jax_build_datasets,
)
from multimodal_alzheimer_tpu_torch.data.synthetic import (
    write_synthetic_split,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models import (
    train_anat_pet_featuremapfusion,
)
from multimodal_alzheimer_tpu_torch.models.mri_models import train_anat_cnn
from multimodal_alzheimer_tpu_torch.models.pet_models import (
    train_pet_cnn,
    train_pet_resnet_cnn,
)
from multimodal_alzheimer_tpu_torch.models.tabular_models import train_tabular
from multimodal_alzheimer_tpu_torch.train import hpo, seed_screen
from multimodal_alzheimer_tpu_torch.train.driver import build_datasets
from multimodal_alzheimer_tpu_torch.train.fusion_hpo import full_arrays
from torch_threads import torch_threads  # noqa: F401 (autouse)

NORM_TOL = 1e-6


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """Two splits written by the port, and a workspace that is the CWD
    meanwhile."""
    root = tmp_path_factory.mktemp("hpo_entry")
    out = {}
    for name, shape in (("small", (12, 14, 12)), ("pet", (19, 23, 17))):
        write_synthetic_split(str(root / name), n_subjects=(12, 5, 5),
                              seed=3, volume_shape=shape)
        out[name] = str(root / name)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        yield out
    finally:
        os.chdir(cwd)
        os.environ.pop("MMALZ_DATA_DIR", None)


def test_percentile_normalizer_honours_q_like_jax(splits, monkeypatch):
    monkeypatch.setenv("MMALZ_DATA_DIR", splits["small"])
    kwargs = dict(normalize_mri={"per_scan_norm": "min_max"}, quantile=0.99)
    trainset, valset = build_datasets({"n_classes": 2}, ["t1w"], **kwargs)
    raw = (full_arrays(trainset), full_arrays(valset))
    assert "mri_qminmax" in raw[0]  # memoised bounds ride the split
    normalized = train_anat_cnn.percentile_normalizer(trainset, *raw,
                                                      device="cpu")
    jax_sets = jax_build_datasets({"n_classes": 2}, ["t1w"], **kwargs)
    jax_normalized = jax_train_anat_cnn.percentile_normalizer(
        jax_sets[0], *(jax_fusion_hpo.full_arrays(ds) for ds in jax_sets))
    low = normalized(0.95)
    assert normalized(0.95) is low  # cached, not renormalized
    for q in (0.95, 1.0):
        got, want = normalized(q), jax_normalized(q)
        for split_got, split_want in zip(got, want):
            assert "mri_qminmax" not in split_got
            ref = np.asarray(split_want["mri"])
            np.testing.assert_allclose(split_got["mri"].numpy(), ref,
                                       rtol=0, atol=NORM_TOL * max(
                                           1.0, np.abs(ref).max()))
            np.testing.assert_array_equal(split_got["label"].numpy(),
                                          np.asarray(split_want["label"]))
    assert not torch.equal(low[0]["mri"], normalized(1.0)[0]["mri"])


def test_tabular_full_arrays_equal_jax(splits, monkeypatch):
    monkeypatch.setenv("MMALZ_DATA_DIR", splits["small"])
    port = build_datasets({"n_classes": 3}, ["tabular"])[0]
    ref = jax_build_datasets({"n_classes": 3}, ["tabular"])[0]
    got = train_tabular._full_arrays(port)
    want = jax_train_tabular._full_arrays(ref)
    for key in ("tabular", "label"):
        np.testing.assert_array_equal(got[key], want[key])


def test_train_anat_fast_continues_from_the_screen_winner(splits,
                                                          monkeypatch):
    monkeypatch.setenv("MMALZ_DATA_DIR", splits["small"])
    screens, starts = [], []
    real_screen = seed_screen.screen_seeds
    real_run = train_anat_cnn.run_training

    def screen(*args, **kwargs):
        out = real_screen(*args, **kwargs)
        screens.append(dict(out))
        return out

    def run(model, hparams, *args, variables_transform, **kwargs):
        starts.append(variables_transform(model.state_dict()))
        return real_run(model, hparams, *args,
                        variables_transform=variables_transform, **kwargs)

    monkeypatch.setattr(seed_screen, "screen_seeds", screen)
    monkeypatch.setattr(train_anat_cnn, "run_training", run)
    hparams = {"n_classes": 2, "resnet_depth": 10, "linear_out": (),
               "batchnorm_begin": False, "lr": 1e-3, "lr_pretrained": None,
               "batch_size": 6, "max_epochs": 1,
               "early_stopping_patience": 2,
               "reduce_factor_lr_schedule": None, "norm_percentile": 0.99,
               "best_k_checkpoints": 1}
    last_val, screen_out = train_anat_cnn.train_anat_fast(
        hparams, experiment_name="fast_smoke", screen_k=2, screen_epochs=2,
        log_confusion_images=False, device="cpu")
    assert np.isfinite(last_val)
    assert screen_out["val_history"].shape == (2, 2)
    assert screen_out["winner_seed"] in screen_out["seeds"]
    assert "winner_variables" not in screen_out  # handed to the fit
    winner = screens[0]["winner_variables"]
    assert set(starts[0]) == set(winner)
    for name, value in winner.items():
        torch.testing.assert_close(starts[0][name], value, rtol=0, atol=0)


def _capped(module, monkeypatch):
    """Each sampled proposal gets a one-epoch budget."""
    real = module.sample_hparams

    def sample(trial, **kwargs):
        hparams = real(trial, **kwargs)
        hparams.update(max_epochs=1, early_stopping_patience=1)
        return hparams

    monkeypatch.setattr(module, "sample_hparams", sample)


def _resnet10_study(module):
    """A TPE study of the port whose first two proposals are ResNet-10s (the
    seed-0 study draws ResNet-50s, minutes on this CPU)."""
    for seed in range(200):
        study = hpo.TPEStudy(seed=seed)
        if all(module.sample_hparams(study.ask())["resnet_depth"] == 10
               for _ in range(2)):
            return hpo.TPEStudy(seed=seed)
    raise AssertionError("no seed below 200 draws two ResNet-10s")


ENTRIES = {
    "anat_cnn": (train_anat_cnn, "small", _resnet10_study),
    "tabular": (train_tabular, "small", None),
    "pet_cnn": (train_pet_cnn, "pet", None),
    "pet_resnet_cnn": (train_pet_resnet_cnn, "small", _resnet10_study),
    "featuremap": (train_anat_pet_featuremapfusion, "pet", None),
}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_optuna_optimization_parallel(name, splits, monkeypatch):
    module, split, make_study = ENTRIES[name]
    monkeypatch.setenv("MMALZ_DATA_DIR", splits[split])
    if make_study:
        study = make_study(module)
        monkeypatch.setattr(hpo, "create_study", lambda **_: study)
    _capped(module, monkeypatch)
    study = module.optuna_optimization(n_trials=2, parallel=2, device="cpu",
                                       log_confusion_images=False)
    assert len(study.trials) == 2
    values = [v for v, _ in study.trials]
    assert all(np.isfinite(v) or v == math.inf for v in values)
    assert np.isfinite(study.best_value)


@pytest.mark.parametrize("name", ["anat_cnn", "pet_cnn", "pet_resnet_cnn",
                                  "tabular"])
def test_optuna_optimization_sequential(name, splits, monkeypatch):
    """The default search, one trial after another, as each module's
    ``__main__`` runs it: every name its objective reads is defined."""
    module, split, make_study = ENTRIES[name]
    monkeypatch.setenv("MMALZ_DATA_DIR", splits[split])
    if make_study:
        study = make_study(module)
        monkeypatch.setattr(hpo, "create_study", lambda **_: study)
    _capped(module, monkeypatch)
    study = module.optuna_optimization(n_trials=1, device="cpu",
                                       log_confusion_images=False)
    assert len(study.trials) == 1
    value = study.trials[0][0]
    assert np.isfinite(value) or value == math.inf
