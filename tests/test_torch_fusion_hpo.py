"""Shared-tower fusion HPO of the port (``train/fusion_hpo.py``) and the
fusion entry points' ``optuna_optimization``.

* Against JAX: ``run_frozen_fusion_trials`` for ``PETTabularFusion`` (K = 2
  heads over a frozen SmallPETCNN and TabularMLP) from the same tower
  weights and the JAX heads' initial variables carried across: the val
  histories agree within rtol 1e-4 (float32 Adam written two ways).
* Port against port: K head trials over ONE shared tower forward per step
  trace the same val history as K full frozen fusion models each running
  its own towers (rtol 2e-5, JAX's own bound for this claim), in the three
  stage-2 fusions and in stage 3 (``make_stage3_shared_fn`` through
  ``fusion_inputs=``).
* Every fusion entry point's ``optuna_optimization(parallel=2)`` on a split
  written at (12, 14, 12) with random-weight checkpoints on disk: frozen
  proposals run as shared-tower trials, unfrozen ones (in the MRI+tabular
  and PET+tabular studies) through the sequential ``train``, and every
  trial is told a finite-or-inf value. The budget of each proposal is cut
  to one epoch to keep the run short.
"""

import copy
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.models.fusion_models.pet_tabular_fusion import (
    PETTabularFusion as JaxPETTabularFusion,
)
from multimodal_alzheimer_tpu.models.pet_models.pet_cnn import (
    SmallPETCNN as JaxSmallPETCNN,
)
from multimodal_alzheimer_tpu.models.tabular_models.tabular_mlp import (
    TabularMLP as JaxTabularMLP,
)
from multimodal_alzheimer_tpu.train import fusion_hpo as jax_fusion_hpo
from multimodal_alzheimer_tpu.train import vmap_hpo as jax_vmap_hpo
from multimodal_alzheimer_tpu_torch.data.synthetic import (
    write_synthetic_split,
)
from multimodal_alzheimer_tpu_torch.models.convert import (
    state_dict_from_flax,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models import (
    train_all_modalities_fusion,
    train_anat_pet_fusion,
    train_mrt_tabular_fusion,
    train_pet_tabular_fusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.all_modalities_fusion import (
    AllModalitiesFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.anat_pet_fusion import (
    AnatPETFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.pet_tabular_fusion import (
    PETTabularFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.tabular_mri_fusion import (
    TabularMRIFusion,
)
from multimodal_alzheimer_tpu_torch.models.layers import reset_parameters
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
    SmallPETCNN,
)
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp import (
    TabularMLP,
)
from multimodal_alzheimer_tpu_torch.train import fusion_hpo, hpo, vmap_hpo
from multimodal_alzheimer_tpu_torch.train.checkpoint import (
    graft_params,
    save_checkpoint,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator
from torch_port_helpers import random_variables
from torch_threads import torch_threads  # noqa: F401 (autouse)

SHAPE = (12, 14, 12)
PET_HP = {"n_classes": 3, "conv_out": (4,), "filter_size": (3,),
          "linear_out": 8, "batchnorm": True,
          "norm_mean": 0.5145, "norm_std": 0.5383}
MRI_HP = {"n_classes": 3, "resnet_depth": 10, "linear_out": (),
          "norm_percentile": 0.98}
TAB_HP = {"n_classes": 3, "hidden": (16, 32)}
CW = (0.55, 0.75, 0.7)
ROWS = [{"lr": 3e-3, "l2_reg": 0.0, "fl_gamma": None, "trial_seed": 11},
        {"lr": 1e-3, "l2_reg": 0.0, "fl_gamma": 2, "trial_seed": 22}]
COMMON = dict(batch_size=4, max_epochs=1, patience=10, class_weights=CW,
              seed=9, device="cpu")
SHARE_TOL = dict(rtol=2e-5, atol=1e-6)


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return {"pet1451": rng.normal(size=(n,) + SHAPE).astype(np.float32),
            "mri": rng.normal(size=(n,) + SHAPE).astype(np.float32),
            "tabular": rng.normal(size=(n, 9)).astype(np.float32),
            "label": rng.integers(0, 3, n).astype(np.int32)}


def _towers(names, seed=0):
    """Port towers with random weights, by name, and their state dicts."""
    build = {"pet": lambda g: SmallPETCNN.from_hparams(PET_HP, generator=g),
             "mri": lambda g: AnatCNN.from_hparams(
                 MRI_HP, freeze_backbone=False, generator=g),
             "tab": lambda g: TabularMLP.from_hparams(TAB_HP, generator=g)}
    models = {n: build[n](make_generator(seed + i))
              for i, n in enumerate(names)}
    return models, {n: m.state_dict() for n, m in models.items()}


def _full_init(grafts):
    """init_fn of a full frozen fusion model: the towers' weights grafted,
    the head children re-initialised in order from the trial's generator,
    the draws the head-only copy makes."""
    def init_fn(model, generator, example, shared_example):
        full = copy.deepcopy(model)
        full.load_state_dict(graft_params(full.state_dict(), grafts))
        for child in full.children():
            if not hasattr(child, "fusion_tap"):
                reset_parameters(child, generator)
        return full
    return init_fn


STAGE2 = {
    "anat_pet": (AnatPETFusion, ("pet", "mri"),
                 {"pet": "pet_model", "mri": "mri_model"}),
    "mri_tab": (TabularMRIFusion, ("mri", "tab"),
                {"mri": "mri_model", "tab": "tab_model"}),
    "pet_tab": (PETTabularFusion, ("pet", "tab"),
                {"pet": "pet_model", "tab": "tab_model"}),
}


@pytest.mark.parametrize("kind", sorted(STAGE2))
def test_shared_tower_trials_equal_full_frozen_fits(kind):
    cls, names, graft_keys = STAGE2[kind]
    models, weights = _towers(names)
    head = cls(3, *(copy.deepcopy(models[n]) for n in names),
               freeze_towers=True)
    hp = vmap_hpo.stack_trial_hparams(ROWS)
    train, val = _data(8, 3), _data(4, 4)
    _, full = vmap_hpo.run_parallel_trials(
        head, hp, train, val, apply_fn=vmap_hpo.plain_apply,
        init_fn=_full_init({graft_keys[n]: weights[n] for n in names}),
        return_state=True, **COMMON)
    for name, value in full["carry"][0].items():  # the towers stay frozen
        if name.split(".")[0] in graft_keys.values():
            tower = name.split(".")[0]
            key = name[len(tower) + 1:]
            n = next(k for k, v in graft_keys.items() if v == tower)
            torch.testing.assert_close(value[0], weights[n][key], rtol=0,
                                       atol=0)
    _, shared = fusion_hpo.run_frozen_fusion_trials(
        head, models, weights, hp, train, val, return_state=True, **COMMON)
    np.testing.assert_allclose(shared["val_history"], full["val_history"],
                               **SHARE_TOL)
    # the heads alone are trained; the towers' statistics moved in the
    # shared carry
    params, _, _ = shared["carry"]
    assert not any(k.split(".")[0] in graft_keys.values() for k in params)
    stats = shared["shared_carry"][1]
    moved = [not torch.equal(v, weights[n][k]) for n in stats
             for k, v in stats[n].items() if k.endswith("running_mean")]
    assert moved and any(moved)


def test_shared_tower_trials_match_jax():
    """PETTabularFusion heads over frozen PET and tabular towers, against
    JAX's ``run_frozen_fusion_trials`` on the same weights."""
    pet_hp = dict(PET_HP, batchnorm=False)
    example = {k: jnp.asarray(v[:2]) for k, v in _data(2, 0).items()}
    jax_towers = {"pet": JaxSmallPETCNN.from_hparams(pet_hp),
                  "tab": JaxTabularMLP.from_hparams(TAB_HP)}
    tower_vars = {n: random_variables(m, i + 1, example, train=False)
                  for i, (n, m) in enumerate(sorted(jax_towers.items()))}
    hparams = {"n_classes": 3, "lr_pretrained": None}
    jax_head = JaxPETTabularFusion.from_hparams(hparams, pet_hp, TAB_HP)
    hp_jax = jax_vmap_hpo.stack_trial_hparams(ROWS)
    train, val = _data(8, 3), _data(4, 4)
    common = dict({k: v for k, v in COMMON.items() if k != "device"},
                  max_epochs=2)
    _, ref = jax_fusion_hpo.run_frozen_fusion_trials(
        jax_head, jax_towers, tower_vars, hp_jax, train, val, **common)
    shared_fn, carry0 = jax_fusion_hpo.make_shared_towers_fn(jax_towers,
                                                             tower_vars)
    shared_example, _ = shared_fn(carry0, example, False)
    heads = {r["trial_seed"]: jax.device_get(jax_head.init(
        jax.random.fold_in(jax.random.PRNGKey(9), r["trial_seed"]),
        example, train=False, towers=shared_example)) for r in ROWS}
    by_seed = {vmap_hpo.trial_generator_seed(9, s, 0): v
               for s, v in heads.items()}
    _, hook_init = fusion_hpo.make_hook_fns("towers")

    def init_fn(model, generator, example, shared_example):
        trial = hook_init(model, generator, example, shared_example)
        trial.load_state_dict(state_dict_from_flax(
            by_seed[generator.initial_seed()], trial))
        return trial

    models = {"pet": SmallPETCNN.from_hparams(pet_hp),
              "tab": TabularMLP.from_hparams(TAB_HP)}
    weights = {n: state_dict_from_flax(v, models[n])
               for n, v in tower_vars.items()}
    head = PETTabularFusion.from_hparams(hparams, pet_hp, TAB_HP)
    shared_fn, carry0 = fusion_hpo.make_shared_towers_fn(models, weights,
                                                         device="cpu")
    _, got = vmap_hpo.run_parallel_trials(
        head, vmap_hpo.stack_trial_hparams(ROWS), train, val,
        apply_fn=fusion_hpo.towers_apply_fn, init_fn=init_fn,
        shared_fn=shared_fn, shared_carry0=carry0,
        **dict(COMMON, max_epochs=2))
    np.testing.assert_allclose(got["val_history"],
                               np.asarray(ref["val_history"]),
                               rtol=1e-4, atol=1e-6)


def test_stage3_shared_trials_equal_full_frozen_fits():
    towers, _ = _towers(("pet", "mri", "tab"))

    def tower(name):
        return copy.deepcopy(towers[name])

    kw = dict(freeze_towers=True)
    subs = {"anat_pet": AnatPETFusion(3, tower("pet"), tower("mri"),
                                      generator=make_generator(4), **kw),
            "anat_tab": TabularMRIFusion(3, tower("mri"), tower("tab"),
                                         generator=make_generator(5), **kw),
            "pet_tab": PETTabularFusion(3, tower("pet"), tower("tab"),
                                        generator=make_generator(6), **kw)}
    variables = {n: m.state_dict() for n, m in subs.items()}
    head = AllModalitiesFusion(3, *(copy.deepcopy(subs[n]) for n in (
        "anat_pet", "anat_tab", "pet_tab")), share_towers=True, **kw)
    hparams = vmap_hpo.stack_trial_hparams(ROWS)
    train, val = _data(8, 3), _data(4, 4)
    grafts = {f"model_{n}": v for n, v in variables.items()}
    _, full = vmap_hpo.run_parallel_trials(
        head, hparams, train, val, apply_fn=vmap_hpo.plain_apply,
        init_fn=_full_init(grafts), **COMMON)
    shared_fn, carry0 = fusion_hpo.make_stage3_shared_fn(
        subs, variables, device="cpu")
    _, shared = fusion_hpo.run_shared_trials(
        head, shared_fn, carry0, hparams, train, val,
        hook_kwarg="fusion_inputs", return_state=True, **COMMON)
    np.testing.assert_allclose(shared["val_history"], full["val_history"],
                               **SHARE_TOL)
    assert set(shared["carry"][0]) == {"stage3out.weight", "stage3out.bias",
                                       "cls3.weight", "cls3.bias"}


def _capped(module, monkeypatch):
    """Each sampled proposal gets a one-epoch budget."""
    real = module.sample_hparams

    def sample(trial, **kwargs):
        hparams = real(trial, **kwargs)
        hparams.update(max_epochs=1, early_stopping_patience=1)
        return hparams

    monkeypatch.setattr(module, "sample_hparams", sample)


def _study(module, n_classes, unfrozen: int, **paths):
    """A TPE study whose first two proposals hold ``unfrozen`` unfrozen ones,
    at batch 8 (the sequential PET+tabular loaders drop the last partial
    batch; the split has 21 such training and 11 validation rows). The
    seed is searched; the sampler is the port's."""
    for seed in range(200):
        study = hpo.TPEStudy(seed=seed)
        rows = [module.sample_hparams(study.ask(), n_classes=n_classes,
                                      **paths) for _ in range(2)]
        rows = [r for r in rows if r["lr_pretrained"] is not None]
        if len(rows) == unfrozen and all(r["batch_size"] == 8
                                         for r in rows):
            return hpo.TPEStudy(seed=seed)
    raise AssertionError(f"no seed below 200 gives {unfrozen} unfrozen")


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    """A split at (12, 14, 12) and random-weight stage-1 and stage-2
    checkpoints named in a path_config.yaml, in a workspace that is the
    CWD meanwhile."""
    root = tmp_path_factory.mktemp("fusion_hpo")
    write_synthetic_split(str(root / "data"), n_subjects=(16, 8, 8), seed=3,
                          volume_shape=SHAPE)
    entries, stage1 = {}, {}
    for n_classes in (2, 3):
        for name, hp in (("pet_cnn", PET_HP), ("mri_cnn", MRI_HP),
                         ("tabular_mlp", dict(TAB_HP, feature_mean=[0.0] * 9,
                                              feature_std=[1.0] * 9))):
            hp = dict(hp, n_classes=n_classes)
            cls = {"pet_cnn": SmallPETCNN, "mri_cnn": AnatCNN,
                   "tabular_mlp": TabularMLP}[name]
            key = f"{name}_{n_classes}_class"
            stage1[key] = cls.from_hparams(
                hp, generator=make_generator(n_classes))
            save_checkpoint(root / key, stage1[key].state_dict(), hp)
            entries[key] = root / key
    hp2 = {"n_classes": 3, "lr_pretrained": None}
    for key, cls, parts in (
            ("pet_mri_3_class", AnatPETFusion, ("pet_cnn", "mri_cnn")),
            ("mri_tab_3_class", TabularMRIFusion, ("mri_cnn", "tabular_mlp")),
            ("pet_tab_3_class", PETTabularFusion, ("pet_cnn",
                                                   "tabular_mlp"))):
        model = cls(3, *(copy.deepcopy(stage1[f"{p}_3_class"])
                         for p in parts),
                    freeze_towers=True, generator=make_generator(7))
        save_checkpoint(root / key, model.state_dict(), hp2)
        entries[key] = root / key
    with open(root / "path_config.yaml", "w") as f:
        f.write("".join(f"{k}: '{p}'\n" for k, p in entries.items()))
    cwd = os.getcwd()
    os.chdir(root)
    os.environ["MMALZ_DATA_DIR"] = str(root / "data")
    try:
        yield {k: str(p) for k, p in entries.items()}
    finally:
        os.chdir(cwd)
        os.environ.pop("MMALZ_DATA_DIR", None)


# name: (module, n_classes, registry keys, unfrozen proposals). The
# MRI+tabular and PET+tabular studies route one unfrozen proposal through
# the sequential train; the PET+MRI and stage-3 studies run frozen ones
# only (their sequential train is held in test_torch_fusion_entry.py and
# test_torch_stage3_entry.py).
ENTRIES = {
    "anat_pet": (train_anat_pet_fusion, 3, {
        "path_pet": "pet_cnn_3_class", "path_mri": "mri_cnn_3_class"}, 0),
    "mri_tab": (train_mrt_tabular_fusion, 2, {
        "path_mri": "mri_cnn_2_class", "path_tabular": "tabular_mlp_2_class"},
        1),
    "pet_tab": (train_pet_tabular_fusion, 2, {
        "path_pet": "pet_cnn_2_class", "path_tabular": "tabular_mlp_2_class"},
        1),
    "stage3": (train_all_modalities_fusion, 3, {
        "path_pet": "pet_cnn_3_class", "path_mri": "mri_cnn_3_class",
        "path_tabular": "tabular_mlp_3_class",
        "path_anat_pet": "pet_mri_3_class",
        "path_anat_tab": "mri_tab_3_class",
        "path_pet_tab": "pet_tab_3_class"}, 0),
}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_fusion_optuna_optimization_parallel(name, registry, monkeypatch):
    module, n_classes, keys, unfrozen = ENTRIES[name]
    paths = {k: registry[v] for k, v in keys.items()}
    study = _study(module, n_classes, unfrozen, **paths)
    monkeypatch.setattr(hpo, "create_study", lambda **_: study)
    _capped(module, monkeypatch)
    calls = []
    real_train = module.train

    def train(hparams, *args, **kwargs):
        calls.append(hparams)
        return real_train(hparams, *args, **kwargs)

    monkeypatch.setattr(module, "train", train)
    study = module.optuna_optimization(
        n_trials=2, parallel=2, device="cpu", log_confusion_images=False)
    values = [v for v, _ in study.trials]
    assert len(values) == 2
    assert all(np.isfinite(v) or v == math.inf for v in values)
    # the unfrozen proposals, and they alone, went through the sequential
    # train
    assert len(calls) == unfrozen
    assert all(c["lr_pretrained"] is not None for c in calls)
