"""The port's stage-2 fusions against the JAX package's (CPU).

``AnatPETFusion`` (2- and 3-class PET taps), ``TabularMRIFusion`` and
``PETTabularFusion`` (both ``reduce_tab`` shapes) from one converted weight
tree: logits and the ``fusion`` tap in eval mode within rtol 1e-3, atol
1e-4 in float32 (the ResNet tower's model-parity tolerance,
tests/test_torch_anat_cnn.py); in bfloat16 within twice JAX's own
bf16-vs-f32 distance of JAX's f32 result (tests/test_torch_dtype.py).

One train step with Adam from the fusion optimizer groups, frozen
(``lr_pretrained`` None) and unfrozen, raw scans through the min-max (and
PET z-score) preprocess inside the step, against JAX's
``train/state.make_train_step`` compiled without XLA's fusion pass
(``torch_port_helpers.run_unfused``; SmallPETCNN's ``s2d_pool`` lowering
needs it): loss rtol 1e-4, logits as above, Adam's first moments rtol 2e-3
with atol 1e-3 of the leaf's largest, updated parameters atol 1e-7 where
the gradient exceeds 1e-4, every tower's BatchNorm running statistics rtol
2e-4, atol 2e-5 (tests/test_torch_train.py). Frozen: the towers'
parameters do not move and get no gradient, while their running statistics
move as JAX's; with ``fused_bn="full"`` no BatchNorm backward runs at all.

Also ``graft_params`` (against JAX's on the same trees, nested paths, and
the mismatches it refuses), the ``fusion_optimizer`` groups against JAX's
labels, ``stage1_normalizations``, the freeze derivation and tower reuse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.data.dataset import (
    MultiModalDataset as JaxDataset,
)
from multimodal_alzheimer_tpu.losses import make_criterion as jax_criterion
from multimodal_alzheimer_tpu.models.fusion_models import (
    anat_pet_fusion as jax_anat_pet,
    pet_tabular_fusion as jax_pet_tab,
    tabular_mri_fusion as jax_mri_tab,
    train_anat_pet_fusion as jax_train_anat_pet,
    train_mrt_tabular_fusion as jax_train_mri_tab,
    train_pet_tabular_fusion as jax_train_pet_tab,
)
from multimodal_alzheimer_tpu.train import checkpoint as jax_checkpoint
from multimodal_alzheimer_tpu.train import driver as jax_driver
from multimodal_alzheimer_tpu.train.state import (
    TrainState as JaxTrainState,
    make_train_step as jax_train_step,
)
from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.data.synthetic import make_labeled_volumes
from multimodal_alzheimer_tpu_torch.losses.classification import (
    make_criterion,
)
from multimodal_alzheimer_tpu_torch.models.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models import (
    train_anat_pet_fusion,
    train_mrt_tabular_fusion,
    train_pet_tabular_fusion,
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
from multimodal_alzheimer_tpu_torch.models.layers import FusedBatchNorm
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp import (
    TabularMLP,
)
from multimodal_alzheimer_tpu_torch.ops import hopper_bn
from multimodal_alzheimer_tpu_torch.train import driver
from multimodal_alzheimer_tpu_torch.train.checkpoint import graft_params
from multimodal_alzheimer_tpu_torch.train.state import (
    TrainState,
    make_train_step,
)
from torch_port_helpers import (
    Trial,
    adam_mu,
    dist,
    flat,
    random_variables,
    run_unfused,
)
from torch_threads import torch_threads  # noqa: F401 (autouse)

SHAPE = (12, 14, 12)
MODEL_TOL = dict(rtol=1e-3, atol=1e-4)
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-3
STATS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_ATOL = 1e-7
GRAD_FLOOR = 1e-4
MINMAX = {"per_scan_norm": "min_max"}
PET_NORM = {"mean": 0.5, "std": 0.25}

MRI_HP = {"n_classes": 3, "resnet_depth": 10, "linear_out": (),
          "lr_pretrained": None}  # the tower's own freeze is forced off
PET_HP = {"n_classes": 3, "conv_out": (4, 8), "filter_size": (3, 3),
          "batchnorm": True, "linear_out": 16}
TAB_HP = {"n_classes": 3, "hidden": (16, 32), "feature_mean": [0.5] * 9,
          "feature_std": [1.5] * 9}
# name -> (JAX class, port class, tower hparams, JAX train module, port
# train module, fusion hparams, the batch's modalities)
FUSIONS = {
    "anat_pet-2": (jax_anat_pet.AnatPETFusion, AnatPETFusion,
                   (PET_HP, MRI_HP), jax_train_anat_pet,
                   train_anat_pet_fusion, {"n_classes": 2},
                   ("mri", "pet1451")),
    "anat_pet-3": (jax_anat_pet.AnatPETFusion, AnatPETFusion,
                   (PET_HP, MRI_HP), jax_train_anat_pet,
                   train_anat_pet_fusion, {"n_classes": 3},
                   ("mri", "pet1451")),
    "mri_tab": (jax_mri_tab.TabularMRIFusion, TabularMRIFusion,
                (MRI_HP, TAB_HP), jax_train_mri_tab,
                train_mrt_tabular_fusion, {"n_classes": 2},
                ("mri", "tabular")),
    "pet_tab": (jax_pet_tab.PETTabularFusion, PETTabularFusion,
                (PET_HP, TAB_HP), jax_train_pet_tab,
                train_pet_tabular_fusion, {"n_classes": 3},
                ("pet1451", "tabular")),
    "pet_tab-simple": (jax_pet_tab.PETTabularFusion, PETTabularFusion,
                       (PET_HP, TAB_HP), jax_train_pet_tab,
                       train_pet_tabular_fusion,
                       {"n_classes": 2, "simple_dim_red": True},
                       ("pet1451", "tabular")),
}


def _example(modalities, n=1):
    shapes = {"mri": SHAPE, "pet1451": SHAPE, "tabular": (9,)}
    return {k: jnp.zeros((n,) + shapes[k], jnp.float32) for k in modalities}


def _setup(name, hparams=None, seed=0, dtype=torch.float32):
    """(JAX models by dtype, numpy variables, port model, modalities)."""
    jax_cls, port_cls, towers, _, _, hp, modalities = FUSIONS[name]
    hp = dict(hp, **(hparams or {}))
    jax_models = {dt: jax_cls.from_hparams(hp, *towers, dtype=dt)
                  for dt in (jnp.float32, jnp.bfloat16)}
    variables = random_variables(jax_models[jnp.float32], seed,
                                 _example(modalities), train=False)
    port = port_cls.from_hparams(hp, *towers, dtype=dtype)
    port.load_state_dict(state_dict_from_flax(variables, port))
    return jax_models, variables, port, modalities


@pytest.fixture(scope="module")
def setups():
    """``_setup(name, dtype=...)`` at seed 0, built once per module."""
    cache = {}

    def get(name, dtype=torch.float32):
        if (name, dtype) not in cache:
            cache[name, dtype] = _setup(name, dtype=dtype)
        return cache[name, dtype]

    return get


def _inputs(modalities, seed, n=4):
    """Normalised inputs for the eval comparison."""
    rng = np.random.default_rng(seed)
    out = {"mri": rng.normal(size=(n,) + SHAPE),
           "pet1451": rng.normal(0.5, 0.5, (n,) + SHAPE),
           "tabular": rng.normal(0.5, 1.5, (n, 9))}
    return {k: out[k].astype(np.float32) for k in modalities}


EVAL_CASES = [(name, "float32") for name in sorted(FUSIONS)] + [
    (name, "bfloat16") for name in ("anat_pet-3", "mri_tab",
                                    "pet_tab-simple")]


@pytest.mark.parametrize("name,dtype", EVAL_CASES)
def test_fusion_matches_jax(setups, name, dtype):
    torch_dtype = getattr(torch, dtype)
    jax_models, variables, port, modalities = setups(name, torch_dtype)
    x = _inputs(modalities, 1)
    want = {dt: jax.jit(lambda v, b, m=m: m.apply(v, b, train=False))(
        variables, {k: jnp.asarray(v) for k, v in x.items()})
        for dt, m in jax_models.items()}
    with torch.inference_mode():
        got = port.eval()({k: torch.from_numpy(v) for k, v in x.items()})
    assert set(got["embeddings"]) == {"fusion"} and port.fusion_tap() == \
        jax_models[jnp.float32].fusion_tap() == "fusion"
    assert got["logits"].dtype == torch.float32
    assert got["embeddings"]["fusion"].dtype == torch_dtype
    for what, g, w32, w16 in (
            ("logits", got["logits"], want[jnp.float32]["logits"],
             want[jnp.bfloat16]["logits"]),
            ("fusion", got["embeddings"]["fusion"],
             want[jnp.float32]["embeddings"]["fusion"],
             want[jnp.bfloat16]["embeddings"]["fusion"])):
        g = g.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, np.asarray(w32), **MODEL_TOL,
                                       err_msg=what)
        else:
            ref = dist(np.asarray(w16, np.float32), w32)
            assert dist(g, w32) <= 2 * ref, (what, dist(g, w32), ref)


def _port_params(model, values: dict) -> dict:
    sd = dict(model.state_dict())
    sd.update(values)
    return flat(flax_from_state_dict(sd)["params"])


def _train_batch(modalities, n_classes, seed=0):
    data = make_labeled_volumes(4, SHAPE, n_classes=n_classes, seed=seed,
                                modalities=modalities)
    data["label"] = (np.arange(4) % n_classes).astype(np.int32)
    return data


def _norms(modalities):
    return (PET_NORM if "pet1451" in modalities else None,
            MINMAX if "mri" in modalities else None)


STEP_CASES = [("mri_tab", True), ("mri_tab", False), ("pet_tab", True),
              ("pet_tab", False), ("anat_pet-3", False)]


@pytest.mark.parametrize("name,frozen", STEP_CASES,
                         ids=[f"{n}-{'frozen' if f else 'unfrozen'}"
                              for n, f in STEP_CASES])
def test_train_step_matches_jax(name, frozen):
    _, _, _, jax_train, port_train, _, _ = FUSIONS[name]
    hp = {"lr": 1e-3, "lr_pretrained": None if frozen else 1e-4,
          "l2_reg": 1e-2}
    jax_models, variables, port, modalities = _setup(name, hp, seed=2)
    n_classes = port.n_classes
    hp = dict(FUSIONS[name][5], **hp,
              loss_class_weights=[0.4, 0.3, 0.3][:n_classes])
    assert port.freeze_towers == jax_models[jnp.float32].freeze_towers \
        == frozen
    batch = _train_batch(modalities, n_classes)
    pet_norm, mri_norm = _norms(modalities)

    holder = type("Holder", (), {"normalize_pet": pet_norm,
                                 "normalize_mri": mri_norm,
                                 "quantile": 0.99})()
    optimizer = jax_driver.fusion_optimizer(hp, jax_train.HEAD_NAMES)
    step = jax_train_step(jax_models[jnp.float32], jax_criterion(hp),
                          optimizer, JaxDataset.get_device_preprocess(holder))
    state, aux = run_unfused(
        step, JaxTrainState.create(variables, optimizer),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    want_params, want_mu = flat(state.params), adam_mu(state.opt_state)

    port_opt = driver.fusion_optimizer(hp, port_train.HEAD_NAMES, port)
    port_step = make_train_step(port, make_criterion(hp), port_opt,
                                make_device_preprocess(pet_norm, mri_norm))
    _, paux = port_step(TrainState(port, port_opt),
                        {k: torch.from_numpy(v) for k, v in batch.items()})

    np.testing.assert_allclose(float(paux["loss"]), float(aux["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(paux["logits"].numpy(),
                               np.asarray(aux["logits"]), **MODEL_TOL)
    stats = flat(flax_from_state_dict(port.state_dict())["batch_stats"])
    before_stats = flat(variables["batch_stats"])
    assert set(stats) == set(flat(state.batch_stats)) and stats
    for key, value in flat(state.batch_stats).items():
        np.testing.assert_allclose(stats[key], value, err_msg=str(key),
                                   **STATS_TOL)
        assert not np.array_equal(value, before_stats[key]), key

    mu = {n: port_opt.state[p]["exp_avg"]
          for n, p in port.named_parameters() if p in port_opt.state}
    got_mu = _port_params(port, mu)
    got_params = _port_params(port, {})
    heads = set(jax_train.HEAD_NAMES)
    assert {k[0] for k in want_mu} == (heads & {k[0] for k in want_params}
                                       if frozen else {k[0] for k in
                                                       want_params})
    for key, m in want_mu.items():
        np.testing.assert_allclose(got_mu[key], m, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * float(np.abs(m).max()),
                                   err_msg=str(key))
        moved = np.abs(m / 0.1) > GRAD_FLOOR
        np.testing.assert_allclose(got_params[key][moved],
                                   want_params[key][moved], rtol=0,
                                   atol=PARAM_ATOL, err_msg=str(key))
    before = flat(variables["params"])
    for key, value in want_params.items():
        if key not in want_mu:  # frozen towers: no move on either side
            np.testing.assert_array_equal(value, before[key])
            np.testing.assert_array_equal(got_params[key], before[key])
    tower_grads = [p.grad for n, p in port.named_parameters()
                   if n.split(".")[0] not in heads]
    assert tower_grads and all(g is None for g in tower_grads) == frozen


def test_frozen_towers_launch_no_batch_norm_backward(monkeypatch):
    """TabularMRIFusion over a fused_bn="full" ResNet tower: a frozen step
    runs the statistics and apply of every backbone BatchNorm and none of
    their backward (K6/K7 on the card); unfrozen, each BatchNorm once."""
    calls = {"bn_stats": 0, "bn_apply": 0, "bn_grad_sum": 0, "bn_dx": 0}
    for name in calls:
        real = getattr(hopper_bn, name)

        def counted(*args, _real=real, _name=name):
            calls[_name] += 1
            return _real(*args)

        monkeypatch.setattr(hopper_bn, name, counted)
    batch = {k: torch.from_numpy(v) for k, v in
             _train_batch(("mri", "tabular"), 2, seed=3).items()}
    for frozen in (True, False):
        hp = {"n_classes": 2, "lr": 1e-3, "lr_pretrained": None if frozen
              else 1e-4, "loss_class_weights": [0.5, 0.5]}
        model = TabularMRIFusion(
            2, AnatCNN.from_hparams(MRI_HP, freeze_backbone=False,
                                    fused_bn="full"),
            TabularMLP.from_hparams(TAB_HP), freeze_towers=frozen)
        n_bn = sum(isinstance(m, FusedBatchNorm) for m in model.modules())
        before = {k: v.clone() for k, v in model.state_dict().items()}
        optimizer = driver.fusion_optimizer(
            hp, train_mrt_tabular_fusion.HEAD_NAMES, model)
        step = make_train_step(model, make_criterion(hp), optimizer,
                               make_device_preprocess(normalize_mri=MINMAX))
        for name in calls:
            calls[name] = 0
        step(TrainState(model, optimizer), batch)
        assert n_bn == 12
        assert calls == {"bn_stats": n_bn, "bn_apply": n_bn,
                         "bn_grad_sum": 0 if frozen else n_bn,
                         "bn_dx": 0 if frozen else n_bn}, (frozen, calls)
        after = model.state_dict()
        for key, value in before.items():
            if not key.startswith("mri_model.backbone."):
                continue
            moved = not torch.equal(after[key], value)
            if key.endswith(("running_mean", "running_var")):
                assert moved, key
            else:
                assert moved != frozen, key


@pytest.fixture(scope="module")
def stage1():
    """Stage-1 port state dicts of the MRI and tabular towers."""
    gen = torch.Generator().manual_seed(0)
    mri = AnatCNN.from_hparams(MRI_HP, generator=gen)
    tab = TabularMLP.from_hparams(TAB_HP, generator=gen)
    return mri.state_dict(), tab.state_dict()


def test_graft_params_matches_jax(stage1):
    mri_sd, tab_sd = stage1
    fusion = TabularMRIFusion.from_hparams({"n_classes": 2}, MRI_HP, TAB_HP)
    initial = dict(fusion.state_dict())
    grafted = graft_params(initial, {"mri_model": mri_sd,
                                     "tab_model": tab_sd})
    fusion.load_state_dict(grafted)
    for key, value in mri_sd.items():
        assert torch.equal(fusion.state_dict()["mri_model." + key], value)
    for key in ("cls2.weight", "reduce_tab.bias"):
        assert torch.equal(grafted[key], initial[key])
    # JAX's graft of the same trees gives the same weights
    want = flat(jax_checkpoint.graft_params(
        flax_from_state_dict(initial),
        {"mri_model": flax_from_state_dict(mri_sd),
         "tab_model": flax_from_state_dict(tab_sd)}))
    got = flat(flax_from_state_dict(grafted))
    assert set(want) == set(got)
    for key, value in want.items():
        np.testing.assert_array_equal(value, got[key], err_msg=str(key))


def test_graft_params_nested_path_and_mismatches(stage1):
    mri_sd, tab_sd = stage1
    parent = torch.nn.ModuleDict({"model_anat_tab": TabularMRIFusion
                                  .from_hparams({"n_classes": 2}, MRI_HP,
                                                TAB_HP)})
    grafted = graft_params(parent.state_dict(),
                           {"model_anat_tab/tab_model": tab_sd})
    assert torch.equal(grafted["model_anat_tab.tab_model.cls.weight"],
                       tab_sd["cls.weight"])
    target = parent["model_anat_tab"].state_dict()
    deeper = AnatCNN.from_hparams(dict(MRI_HP, linear_out=(8,))).state_dict()
    wider = TabularMLP.from_hparams(dict(TAB_HP, hidden=(16, 64))
                                    ).state_dict()
    for grafts, match in (({"mri_model": deeper}, "structure mismatch"),
                          ({"tab_model": wider}, "shape mismatch"),
                          ({"pet_model": tab_sd}, "not in the target")):
        with pytest.raises(ValueError, match=match):
            graft_params(target, grafts)
        with pytest.raises((ValueError, KeyError)):
            jax_checkpoint.graft_params(
                flax_from_state_dict(target),
                {k: flax_from_state_dict(v) for k, v in grafts.items()})
    assert graft_params(target, {"pet_model": {}}) == target


def _group_lrs(optimizer):
    return {id(p): g["lr"] for g in optimizer.param_groups
            for p in g["params"]}


@pytest.mark.parametrize("lr_pretrained", [None, 1e-5],
                         ids=["frozen", "pretrained"])
@pytest.mark.parametrize("name", ["anat_pet-3", "mri_tab", "pet_tab-simple"])
def test_fusion_optimizer_groups_match_jax(setups, monkeypatch, name,
                                           lr_pretrained):
    hp = {"lr": 1e-3, "lr_pretrained": lr_pretrained, "l2_reg": 1e-2}
    jax_models, variables, port, _ = setups(name)
    jax_train, port_train = FUSIONS[name][3], FUSIONS[name][4]
    assert port_train.HEAD_NAMES == jax_train.HEAD_NAMES
    captured = {}
    monkeypatch.setattr(
        jax_driver, "build_optimizer",
        lambda group_lrs, label, params, l2_reg: captured.update(
            group_lrs=group_lrs, label=label, l2_reg=l2_reg))
    jax_driver.fusion_optimizer(hp, jax_train.HEAD_NAMES)
    optimizer = driver.fusion_optimizer(hp, port_train.HEAD_NAMES, port)
    lrs = _group_lrs(optimizer)
    assert all(g["weight_decay"] == captured["l2_reg"] == 1e-2
               for g in optimizer.param_groups)
    jax_lr = {}
    for path in flat(variables["params"]):
        jax_lr[path[:-1]] = captured["group_lrs"].get(captured["label"](path))
    for n, param in port.named_parameters():
        assert lrs.get(id(param)) == jax_lr[tuple(n.split(".")[:-1])], n
    assert (len(lrs) < len(list(port.parameters()))) == (not lr_pretrained)


@pytest.mark.parametrize("pet,mri", [(None, None), ({"norm_mean": 0.5,
                                                     "norm_std": 0.2}, None),
                                     (None, {"norm_percentile": 0.98}),
                                     ({"norm_mean": 1, "norm_std": 2}, {})])
def test_stage1_normalizations_match_jax(pet, mri):
    assert driver.stage1_normalizations(pet, mri) == \
        jax_driver.stage1_normalizations(pet, mri)


@pytest.mark.parametrize("name", sorted(FUSIONS))
def test_freeze_derivation_and_tower_reuse(setups, monkeypatch, name):
    """lr_pretrained decides freeze_towers as in JAX, and the MRI tower's
    own freeze is off; towers returned once feed the same logits again
    without running a tower."""
    jax_cls, port_cls, towers, _, _, hp, modalities = FUSIONS[name]
    for extra, frozen in (({}, False), ({"lr_pretrained": None}, True),
                          ({"lr_pretrained": 1e-6}, False)):
        model = port_cls.from_hparams(dict(hp, **extra), *towers,
                                      device="meta")
        assert model.freeze_towers == frozen == jax_cls.from_hparams(
            dict(hp, **extra), *towers).freeze_towers
        if hasattr(model, "mri_model"):
            assert not model.mri_model.freeze_backbone
    model = setups(name)[2].eval()
    x = {k: torch.from_numpy(v) for k, v in _inputs(modalities, 4).items()}

    def boom(*args, **kwargs):
        raise AssertionError("a tower ran")

    with torch.inference_mode():
        out = model(x, return_towers=True)
        assert set(out["towers"]) == {"anat_pet": {"pet", "mri"},
                                      "mri_tab": {"mri", "tab"},
                                      "pet_tab": {"pet", "tab"}}[
            name.split("-")[0]]
        for tower in out["towers"]:
            monkeypatch.setattr(getattr(model, f"{tower}_model"), "forward",
                                boom)
        again = model(x, towers=out["towers"])
    torch.testing.assert_close(again["logits"], out["logits"], rtol=0,
                               atol=0)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("name", ["anat_pet-3", "mri_tab", "pet_tab"])
def test_sample_hparams_match_jax(name, seed):
    jax_train, port_train = FUSIONS[name][3], FUSIONS[name][4]
    port_trial, jax_trial = Trial(seed), Trial(seed)
    assert port_train.sample_hparams(port_trial) == \
        jax_train.sample_hparams(jax_trial)
    assert port_trial.calls == jax_trial.calls
    for attr in ("SEED", "LOG_DIRECTORY", "EXPERIMENT_NAME", "HEAD_NAMES"):
        assert getattr(port_train, attr) == getattr(jax_train, attr)
