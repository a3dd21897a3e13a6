"""Stage 3 and the fusion baselines through the port's entry points on the
CPU, from NIfTI files the port writes to disk at (12, 14, 12).

A split of (16, 8, 8) subjects from seed 6 holds binary training rows of
both classes for every pairing: 7 training and 5 validation rows of all
three modalities. Stage 1 trains the PET CNN, a ResNet-10 MRI model and
the tabular MLP through their entry points; stage 2 the three fusions,
towers frozen; stage 3 ``train_all_modalities_fusion.train`` at
``lr_pretrained`` with L2 over those frozen stage-2 checkpoints, so the
model shares its towers. Its validation-loss history is held to the JAX
package's ``train`` from the same checkpoints and head within rtol 1e-4
(tests/test_torch_driver.py), and the ``Trainer``'s checkpoint holds
duplicate towers equal to their canonical copies, statistics included.
``train_early_fusion.train`` (both MRI normalisation styles) and
``train_anat_pet_featuremapfusion.train`` (maxout and concatenate) train
one epoch each; the early fusion under the all-scan z-score is held to
JAX's ``train`` from the same initial weights within rtol 1e-4, its train
step compiled without XLA's fusion pass (``torch_port_helpers.
run_unfused``: fused, on the CPU, the tower's ``s2d_pool`` lowering gives
early-layer gradients that finite differences refute). Then the registry
drives the four test mains; the stage-3 test loss and F1 equal JAX
``evaluate``'s on the same checkpoint within 1e-4, and ``load_fusion``
refuses a shared checkpoint whose duplicates differ. No plotting package
is imported.
"""

import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.inference import harness as jax_harness
from multimodal_alzheimer_tpu.models.fusion_models import (
    train_all_modalities_fusion as jax_train_stage3,
    train_early_fusion as jax_train_early,
)
from multimodal_alzheimer_tpu.models.fusion_models.all_modalities_fusion import (
    AllModalitiesFusion as JaxAllModalitiesFusion,
)
from multimodal_alzheimer_tpu.train import driver as jax_driver
from multimodal_alzheimer_tpu.train import loop as jax_loop
from multimodal_alzheimer_tpu_torch.data.synthetic import (
    write_synthetic_split,
)
from multimodal_alzheimer_tpu_torch.inference import (
    test_all_mod_fusion,
    test_early_fusion_differentnorm,
    test_early_fusion_samenorm,
    test_featuremap_fusion,
)
from multimodal_alzheimer_tpu_torch.models.convert import flax_from_state_dict
from multimodal_alzheimer_tpu_torch.models.fusion_models import (
    train_all_modalities_fusion,
    train_anat_pet_featuremapfusion,
    train_anat_pet_fusion,
    train_early_fusion,
    train_mrt_tabular_fusion,
    train_pet_tabular_fusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.all_modalities_fusion import (
    AllModalitiesFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.early_fusion import (
    PETMRIEarlyFusion,
)
from multimodal_alzheimer_tpu_torch.models.mri_models import train_anat_cnn
from multimodal_alzheimer_tpu_torch.models.pet_models import train_pet_cnn
from multimodal_alzheimer_tpu_torch.models.tabular_models import train_tabular
from multimodal_alzheimer_tpu_torch.train.checkpoint import (
    TOWER_DUPLICATES,
    assert_tower_duplicates_equal,
    load_checkpoint,
    save_checkpoint,
)
from multimodal_alzheimer_tpu_torch.train.driver import stage1_normalizations
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator
from torch_threads import torch_threads  # noqa: F401 (autouse)

SHAPE = (12, 14, 12)
SPLIT = {"n_subjects": (16, 8, 8), "seed": 6}
PLOTTING = ("matplotlib", "seaborn", "PIL", "pandas")
BASE = {"early_stopping_patience": 2, "max_epochs": 1,
        "reduce_factor_lr_schedule": None, "best_k_checkpoints": 1,
        "lr": 1e-3, "batch_size": 4, "fl_gamma": None, "n_classes": 2,
        "l2_reg": 1e-2}
RUN = dict(log_confusion_images=False, device="cpu", num_workers=1)
# PET and MRI of the baselines: the PET CNN's z-score constants, a small
# ladder; batch 24 holds the split's 21 training and 10 validation PET+T1w
# rows in one batch each, so JAX compiles one train and one eval step.
BASELINE = dict(BASE, norm_mean=0.5145, norm_std=0.5383, conv_out=(4, 8),
                filter_size=(5, 3), batch_size=24)
HISTORY_RTOL = 1e-4


def _ckpt(experiment):
    found = sorted(glob.glob(os.path.join(
        "lightning_logs", experiment, "version_0", "checkpoints",
        "*val_loss=*")))
    assert len(found) == 1, found
    return os.path.abspath(found[0])


def _history(experiment):
    with open(os.path.join("lightning_logs", experiment, "version_0",
                           "metrics.jsonl")) as f:
        return [json.loads(line)["val_loss_epoch"] for line in f]


def _jax_load(path):
    state_dict, hparams, metrics = load_checkpoint(path)
    return flax_from_state_dict(state_dict), hparams, metrics


def _unfused_train_steps(monkeypatch):
    """JAX Trainers built meanwhile compile their train step without XLA's
    fusion pass (``torch_port_helpers.run_unfused``)."""
    real = jax_loop.make_train_step

    def make(*args, **kwargs):
        jitted = real(*args, **kwargs)
        return lambda *a: jitted.lower(*a).compile(
            {"xla_disable_hlo_passes": "fusion"})(*a)

    monkeypatch.setattr(jax_loop, "make_train_step", make)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Stage-1 and frozen stage-2 checkpoints in a workspace that is the
    CWD meanwhile."""
    root = tmp_path_factory.mktemp("stage3_entry")
    csvs = write_synthetic_split(str(root / "data"), volume_shape=SHAPE,
                                 **SPLIT)
    cwd = os.getcwd()
    os.chdir(root)
    os.environ["MMALZ_DATA_DIR"] = str(root / "data")
    try:
        pet_hp = dict(BASE, norm_mean=0.5145, norm_std=0.5383,
                      conv_out=(4, 8), filter_size=(3, 3), batchnorm=True,
                      linear_out=16)
        mri_hp = dict(BASE, resnet_depth=10, linear_out=(),
                      norm_percentile=0.98, lr_pretrained=1e-5)
        tab_hp = dict(BASE, hidden=(16, 32), dropout_p=0.0)
        assert np.isfinite(train_pet_cnn.train(pet_hp, "s1_pet", **RUN))
        assert np.isfinite(train_anat_cnn.train_anat(mri_hp, "s1_mri",
                                                     **RUN))
        assert np.isfinite(train_tabular.train(tab_hp, "s1_tab", **RUN))
        out = {"root": root, "csvs": csvs, "path_pet": _ckpt("s1_pet"),
               "path_mri": _ckpt("s1_mri"),
               "path_tabular": _ckpt("s1_tab")}
        for name, module, keys in (
                ("anat_pet", train_anat_pet_fusion, ("path_pet",
                                                     "path_mri")),
                ("anat_tab", train_mrt_tabular_fusion, ("path_mri",
                                                        "path_tabular")),
                ("pet_tab", train_pet_tabular_fusion, ("path_pet",
                                                       "path_tabular"))):
            hp = dict(BASE, lr_pretrained=None, ensemble_size=4,
                      **{k: out[k] for k in keys})
            assert np.isfinite(module.train(hp, f"s2_{name}", **RUN))
            out[f"path_{name}"] = _ckpt(f"s2_{name}")
        yield out
    finally:
        os.chdir(cwd)
        os.environ.pop("MMALZ_DATA_DIR", None)


def _stage3_hparams(chain):
    """Batch 8: the split's 7 training and 5 validation rows of all three
    modalities make one batch each."""
    return dict(BASE, batch_size=8, lr_pretrained=1e-5, ensemble_size=4,
                **{k: v for k, v in chain.items() if k.startswith("path_")})


def _stage3(chain):
    if "s3" not in chain:
        last = train_all_modalities_fusion.train(_stage3_hparams(chain),
                                                 "s3", **RUN)
        assert np.isfinite(last)
        chain["s3"] = _ckpt("s3")
    return chain["s3"]


def test_stage3_train_matches_jax_and_saves_synced_towers(chain,
                                                          monkeypatch):
    checkpoint = _stage3(chain)
    state_dict, hparams, _ = load_checkpoint(checkpoint)
    sub_hp = [load_checkpoint(hparams[k])[1] for k in (
        "path_anat_pet", "path_anat_tab", "path_pet_tab", "path_pet",
        "path_mri", "path_tabular")]
    model = AllModalitiesFusion.from_hparams(hparams, *sub_hp)
    assert model.share_towers and not model.freeze_towers
    # the Trainer synced the duplicates: equal to their canonical copies,
    # whose statistics moved in training and whose parameters moved by L2
    assert_tower_duplicates_equal(state_dict)
    stage1 = {p: load_checkpoint(hparams[k])[0] for p, k in (
        ("pet_model", "path_pet"), ("mri_model", "path_mri"),
        ("tab_model", "path_tabular"))}
    for canonical, duplicate in TOWER_DUPLICATES:
        tower = stage1[canonical.split(".")[1]]
        moved = {k: not torch.equal(state_dict[f"{duplicate}.{k}"], v)
                 for k, v in tower.items()}
        assert all(moved.values()), (duplicate, moved)

    # JAX from the same checkpoints (converted) and the port's initial head
    head = flax_from_state_dict(AllModalitiesFusion.from_hparams(
        hparams, *sub_hp, generator=make_generator(
            train_all_modalities_fusion.SEED)).state_dict())["params"]

    def jax_run(*args, variables_transform, **kwargs):
        def transform(variables):
            variables = variables_transform(variables)
            for name in jax_train_stage3.HEAD_NAMES:
                variables["params"][name] = jax.tree.map(jnp.asarray,
                                                         head[name])
            return variables

        return jax_driver.run_training(*args, variables_transform=transform,
                                       num_workers=1, **kwargs)

    monkeypatch.setattr(jax_train_stage3, "load_checkpoint", _jax_load)
    monkeypatch.setattr(jax_train_stage3, "run_training", jax_run)
    jax_last = jax_train_stage3.train(_stage3_hparams(chain), "s3_jax")
    history = _history("s3")
    assert len(history) == 1
    np.testing.assert_allclose(history, _history("s3_jax"),
                               rtol=HISTORY_RTOL)
    np.testing.assert_allclose(history[-1], jax_last, rtol=HISTORY_RTOL)


def _baseline(chain, name, module, hparams) -> str:
    if name not in chain:
        assert np.isfinite(module.train(hparams, name, **RUN))
        chain[name] = _ckpt(name)
    return chain[name]


def _early_samenorm(chain):
    return _baseline(chain, "ef_samenorm", train_early_fusion,
                     dict(BASELINE, linear_out=16))


def test_early_fusion_train_matches_jax(chain, monkeypatch):
    _early_samenorm(chain)
    init = flax_from_state_dict(PETMRIEarlyFusion.from_hparams(
        dict(BASELINE, linear_out=16),
        generator=make_generator(train_early_fusion.SEED)).state_dict())

    def jax_run(*args, **kwargs):
        return jax_driver.run_training(
            *args, variables_transform=lambda _: jax.tree.map(jnp.asarray,
                                                              init),
            num_workers=1, **kwargs)

    _unfused_train_steps(monkeypatch)
    monkeypatch.setattr(jax_train_early, "run_training", jax_run)
    jax_last = jax_train_early.train(dict(BASELINE, linear_out=16),
                                     "ef_samenorm_jax")
    history = _history("ef_samenorm")
    assert len(history) == 1
    np.testing.assert_allclose(history, _history("ef_samenorm_jax"),
                               rtol=HISTORY_RTOL)
    np.testing.assert_allclose(history[-1], jax_last, rtol=HISTORY_RTOL)


def _checkpoints(chain) -> dict:
    """Every registry key of the four test mains -> a checkpoint."""
    return {
        "all_mod_2_class": _stage3(chain),
        "early_fusion_same_norm_2_class": _early_samenorm(chain),
        "early_fusion_different_norm_2_class": _baseline(
            chain, "ef_differentnorm", train_early_fusion,
            dict(BASELINE, mri_norm_style="per_scan",
                 norm_percentile=0.98, batchnorm=True)),
        "featuremap_fusion_maxout_2_class": _baseline(
            chain, "fmf_maxout", train_anat_pet_featuremapfusion,
            dict(BASELINE, fusion_mode="maxout", batchnorm=True,
                 batchnorm_fusion=True, n_out_fusion=8)),
        "featuremap_fusion_concat_2_class": _baseline(
            chain, "fmf_concat", train_anat_pet_featuremapfusion,
            dict(BASELINE, fusion_mode="concatenate", n_out_fusion=8,
                 bn_torch_stats=True)),
    }


def test_the_test_mains_read_the_registry(chain, monkeypatch):
    registry = _checkpoints(chain)
    with open("path_config.yaml", "w") as f:
        f.write("relative:\n"
                f"  test_set_csv: '{chain['csvs']['test']}'\n"
                + "".join(f"{k}: '{v}'\n" for k, v in registry.items()))
    results = {}
    with monkeypatch.context() as m:
        for name in PLOTTING:
            m.setitem(sys.modules, name, None)
        for module in (test_all_mod_fusion, test_early_fusion_samenorm,
                       test_early_fusion_differentnorm,
                       test_featuremap_fusion):
            results.update(module.main(confusion_pngs=False, device="cpu"))
    assert set(results) == set(registry)
    for key, metrics in results.items():
        assert all(np.isfinite(v) for v in metrics.values()), key
    with open(os.path.join("lightning_logs", "test_set_all_mod_2_class",
                           "version_0", "confusion_matrix.json")) as f:
        n_test = sum(map(sum, json.load(f)["counts"]))

    model, state_dict, hparams, pet_hp, mri_hp = \
        test_all_mod_fusion.load_fusion(registry["all_mod_2_class"])
    assert model.share_towers
    pet_n, mri_n, q = stage1_normalizations(pet_hp, mri_hp)
    testset = jax_harness.build_testset(hparams, pet_n, mri_n, q,
                                        test_csv=chain["csvs"]["test"])
    assert len(testset) == n_test > 0
    sub_hp = [load_checkpoint(hparams[k])[1] for k in (
        "path_anat_pet", "path_anat_tab", "path_pet_tab", "path_pet",
        "path_mri", "path_tabular")]
    want = jax_harness.evaluate(
        JaxAllModalitiesFusion.from_hparams(hparams, *sub_hp),
        jax.tree.map(jnp.asarray, flax_from_state_dict(state_dict)),
        hparams, testset, "test_set_all_mod_jax")
    got = results["all_mod_2_class"]
    for key in ("test_loss_epoch", "test_f1_epoch"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-6, err_msg=key)


def test_load_fusion_refuses_diverged_duplicates(chain, tmp_path):
    state_dict, hparams, metrics = load_checkpoint(_stage3(chain))
    key = "model_pet_tab.pet_model.cls.weight"
    state_dict[key] = state_dict[key] + 1.0
    save_checkpoint(tmp_path / "diverged", state_dict, hparams, metrics)
    with pytest.raises(ValueError, match="tower duplicate mismatch"):
        test_all_mod_fusion.load_fusion(str(tmp_path / "diverged"))
    # a model that does not share its towers serves such a checkpoint
    save_checkpoint(tmp_path / "unshared", state_dict,
                    dict(hparams, path_pet_tab=str(tmp_path / "s2")), None)
    pt_sd, pt_hp, _ = load_checkpoint(hparams["path_pet_tab"])
    save_checkpoint(tmp_path / "s2", pt_sd, dict(pt_hp, lr_pretrained=1e-5))
    model, loaded = test_all_mod_fusion.load_fusion(
        str(tmp_path / "unshared"))[:2]
    assert not model.share_towers
    model.load_state_dict(loaded)
