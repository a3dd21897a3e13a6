"""The stage-1 -> stage-2 -> test chain of the port's entry points on the CPU,
on a synthetic split the port writes to disk at (12, 14, 12).

Stage 1 trains the PET CNN, a ResNet-10 MRI model and the tabular MLP
through their entry points; stage 2 trains the three fusions from those
checkpoints through theirs, towers frozen (``lr_pretrained`` None), and
the PET+MRI one also unfrozen. A frozen fusion's checkpoint holds the
stage-1 tower parameters unchanged and tower running statistics that
moved. The MRI+tabular fusion's ``train`` is held to the JAX package's
``train`` from the same stage-1 weights and head: the validation-loss
history within rtol 1e-4 (tests/test_torch_driver.py). Then the registry
drives ``test_mri_tab_fusion``, ``test_pet_tab_fusion``,
``test_anat_pet_fusion`` and ``test_tab`` (the MLP checkpoint, and a
random-weight TabPFN checkpoint refit in context); the MRI+tabular test
loss and F1 equal JAX ``evaluate``'s on the same checkpoint within 1e-4.
No plotting package is imported.
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
    train_mrt_tabular_fusion as jax_train_mri_tab,
)
from multimodal_alzheimer_tpu.models.fusion_models.tabular_mri_fusion import (
    TabularMRIFusion as JaxTabularMRIFusion,
)
from multimodal_alzheimer_tpu.train import driver as jax_driver
from multimodal_alzheimer_tpu_torch.data.synthetic import (
    write_synthetic_split,
)
from multimodal_alzheimer_tpu_torch.inference import (
    test_anat_pet_fusion,
    test_mri_tab_fusion,
    test_pet_tab_fusion,
    test_tab,
)
from multimodal_alzheimer_tpu_torch.models.convert import flax_from_state_dict
from multimodal_alzheimer_tpu_torch.models.fusion_models import (
    train_anat_pet_fusion,
    train_mrt_tabular_fusion,
    train_pet_tabular_fusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.tabular_mri_fusion import (
    TabularMRIFusion,
)
from multimodal_alzheimer_tpu_torch.models.mri_models import train_anat_cnn
from multimodal_alzheimer_tpu_torch.models.pet_models import train_pet_cnn
from multimodal_alzheimer_tpu_torch.models.tabular_models import train_tabular
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabpfn import (
    TabPFNTransformer,
)
from multimodal_alzheimer_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from multimodal_alzheimer_tpu_torch.train.driver import stage1_normalizations
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator
from torch_threads import torch_threads  # noqa: F401 (autouse)

SHAPE = (12, 14, 12)
PLOTTING = ("matplotlib", "seaborn", "PIL", "pandas")
BASE = {"early_stopping_patience": 2, "max_epochs": 1,
        "reduce_factor_lr_schedule": None, "best_k_checkpoints": 1,
        "lr": 1e-3, "batch_size": 4, "fl_gamma": None, "n_classes": 3,
        "l2_reg": 1e-2}
RUN = dict(log_confusion_images=False, device="cpu", num_workers=1)


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


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Stage-1 checkpoints in a workspace that is the CWD meanwhile."""
    root = tmp_path_factory.mktemp("fusion_entry")
    csvs = write_synthetic_split(str(root / "data"), n_subjects=(10, 6, 6),
                                 seed=3, volume_shape=SHAPE)
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
        yield {"root": root, "csvs": csvs, "pet": _ckpt("s1_pet"),
               "mri": _ckpt("s1_mri"), "tab": _ckpt("s1_tab")}
    finally:
        os.chdir(cwd)
        os.environ.pop("MMALZ_DATA_DIR", None)


def _towers_kept(fusion_ckpt, towers: dict, frozen: bool) -> None:
    """Tower parameters equal the stage-1 checkpoint's iff frozen; the
    BatchNorm running statistics moved either way (train mode)."""
    fused, _, _ = load_checkpoint(fusion_ckpt)
    for prefix, path in towers.items():
        stage1, _, _ = load_checkpoint(path)
        same = {k: torch.equal(fused[f"{prefix}.{k}"], v)
                for k, v in stage1.items()}
        stats = [k for k in same if k.endswith(("running_mean",
                                                "running_var"))]
        params = [k for k in same if k not in stats]
        assert all(same[k] for k in params) == frozen, prefix
        assert not any(same[k] for k in stats), prefix


def _stage2(chain, name: str, module, hparams: dict) -> str:
    """Train a stage-2 fusion once per module (``name`` is its experiment);
    returns its checkpoint."""
    if name not in chain:
        assert np.isfinite(module.train(hparams, name, **RUN))
        chain[name] = _ckpt(name)
    return chain[name]


def _mri_tab_hparams(chain):
    """Batch 3: the split's 12 train and 9 validation MRI+tabular rows make
    whole batches, so JAX compiles one train and one eval step."""
    return dict(BASE, max_epochs=1, batch_size=3, lr_pretrained=None,
                ensemble_size=4, path_mri=chain["mri"],
                path_tabular=chain["tab"])


def _pet_tab(chain):
    return _stage2(chain, "s2_pet_tab", train_pet_tabular_fusion, dict(
        BASE, lr_pretrained=None, ensemble_size=4, simple_dim_red=True,
        path_pet=chain["pet"], path_tabular=chain["tab"]))


def _anat_pet(chain, frozen=True):
    return _stage2(
        chain, f"s2_anat_pet_{'frozen' if frozen else 'unfrozen'}",
        train_anat_pet_fusion, dict(BASE,
                                    lr_pretrained=None if frozen else 1e-5,
                                    path_pet=chain["pet"],
                                    path_mri=chain["mri"]))


def test_mri_tab_fusion_train_matches_jax(chain, monkeypatch):
    """One epoch, frozen towers, from the same stage-1 weights and head."""
    hp, hp_jax = _mri_tab_hparams(chain), _mri_tab_hparams(chain)
    last = train_mrt_tabular_fusion.train(hp, "s2_mri_tab", **RUN)
    chain["s2_mri_tab"] = _ckpt("s2_mri_tab")
    _towers_kept(chain["s2_mri_tab"], {"mri_model": chain["mri"],
                                       "tab_model": chain["tab"]}, True)

    # JAX from the port's checkpoints (converted) and the port's initial
    # head (seed SEED)
    def jax_load(path):
        state_dict, hparams, metrics = load_checkpoint(path)
        return flax_from_state_dict(state_dict), hparams, metrics

    _, mri_hp, _ = load_checkpoint(chain["mri"])
    _, tab_hp, _ = load_checkpoint(chain["tab"])
    head = flax_from_state_dict(TabularMRIFusion.from_hparams(
        hp, mri_hp, tab_hp, generator=make_generator(
            train_mrt_tabular_fusion.SEED)).state_dict())["params"]

    def jax_run(*args, variables_transform, **kwargs):
        def transform(variables):
            variables = variables_transform(variables)
            for name in jax_train_mri_tab.HEAD_NAMES:
                variables["params"][name] = jax.tree.map(jnp.asarray,
                                                         head[name])
            return variables

        return jax_driver.run_training(*args, variables_transform=transform,
                                       num_workers=1, **kwargs)

    monkeypatch.setattr(jax_train_mri_tab, "load_checkpoint", jax_load)
    monkeypatch.setattr(jax_train_mri_tab, "run_training", jax_run)
    jax_last = jax_train_mri_tab.train(hp_jax, "s2_mri_tab_jax")
    history = _history("s2_mri_tab")
    assert len(history) == 1 and history[-1] == last
    np.testing.assert_allclose(history, _history("s2_mri_tab_jax"),
                               rtol=1e-4)
    np.testing.assert_allclose(last, jax_last, rtol=1e-4)


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "unfrozen"])
def test_anat_pet_fusion_trains_from_stage1(chain, frozen):
    _towers_kept(_anat_pet(chain, frozen), {"pet_model": chain["pet"],
                                            "mri_model": chain["mri"]},
                 frozen)


def test_pet_tab_fusion_trains_from_stage1(chain):
    _towers_kept(_pet_tab(chain), {"pet_model": chain["pet"],
                                   "tab_model": chain["tab"]}, True)


def test_the_test_mains_read_the_registry(chain, monkeypatch):
    """Every stage-2 checkpoint and both tabular checkpoints through their
    test mains; the MRI+tabular one against JAX evaluate."""
    mri_tab = _stage2(chain, "s2_mri_tab", train_mrt_tabular_fusion,
                      _mri_tab_hparams(chain))
    tabpfn = os.path.abspath("tabpfn_ckpt")
    save_checkpoint(tabpfn, TabPFNTransformer(
        emsize=32, nhead=4, nhid=64, nlayers=2,
        generator=make_generator(0)).state_dict(), {})
    registry = {"mri_tab_3_class": mri_tab,
                "pet_tab_3_class": _pet_tab(chain),
                "pet_mri_3_class": _anat_pet(chain),
                "tabular_mlp_3_class": chain["tab"],
                "tabpfn_3_class": tabpfn}
    with open("path_config.yaml", "w") as f:
        f.write("relative:\n"
                f"  test_set_csv: '{chain['csvs']['test']}'\n"
                f"  train_set_csv: '{chain['csvs']['train']}'\n"
                + "".join(f"{k}: '{v}'\n" for k, v in registry.items()))
    results = {}
    with monkeypatch.context() as m:
        for name in PLOTTING:
            m.setitem(sys.modules, name, None)
        for module in (test_mri_tab_fusion, test_pet_tab_fusion,
                       test_anat_pet_fusion, test_tab):
            results.update(module.main(confusion_pngs=False, device="cpu"))
    assert set(results) == set(registry)
    for key, metrics in results.items():
        assert all(np.isfinite(v) for k, v in metrics.items()
                   if k != "tabular_baseline_F1"), key
    with open(os.path.join("lightning_logs", "test_set_mri_tab_3_class",
                           "version_0", "confusion_matrix.json")) as f:
        n_test = sum(map(sum, json.load(f)["counts"]))

    model, state_dict, hparams, mri_hp = test_mri_tab_fusion.load_fusion(
        registry["mri_tab_3_class"])
    _, tab_hp, _ = load_checkpoint(hparams["path_tabular"])
    _, mri_n, q = stage1_normalizations(None, mri_hp)
    testset = jax_harness.build_testset(hparams, None, mri_n, q,
                                        test_csv=chain["csvs"]["test"])
    assert len(testset) == n_test > 0
    want = jax_harness.evaluate(
        JaxTabularMRIFusion.from_hparams(hparams, mri_hp, tab_hp),
        jax.tree.map(jnp.asarray, flax_from_state_dict(state_dict)),
        hparams, testset, "test_set_mri_tab_jax")
    got = results["mri_tab_3_class"]
    for key in ("test_loss_epoch", "test_f1_epoch"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-6, err_msg=key)
