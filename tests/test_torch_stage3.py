"""The port's stage-3 ``AllModalitiesFusion`` against the JAX package's (CPU).

One converted weight tree (``models/convert.py``, duplicate towers synced
as the frozen grafting regime leaves them) drives both packages at
(12, 14, 12): ResNet-10 MRI towers, ``SmallPETCNN`` (4, 8) towers with
BatchNorm, ``TabularMLP`` (16, 32), three 3-class stage-2 heads (PET+tabular
with ``simple_dim_red``).

- Eval forward, shared and unshared, logits and the ``fusion`` tap: float32
  within rtol 1e-3, atol 1e-4 (the ResNet tower's model-parity tolerance,
  tests/test_torch_anat_cnn.py); bfloat16 within twice JAX's own
  bf16-vs-f32 distance of JAX's f32 result (tests/test_torch_dtype.py).
- ``from_hparams``: ``freeze_towers`` and ``share_towers`` derived as JAX
  derives them over the regimes, overrides winning.
- Shared against unshared on the same synced weights: logits bit for bit on
  the CPU, in eval and train mode; the shared forward runs fewer ``Conv3d``
  calls and never a duplicate tower.
- ``towers=`` and ``fusion_inputs=`` skip what they replace and give the
  same logits; their misuse raises JAX's ``ValueError``s.
- One Adam step from ``fusion_optimizer``, raw scans through the min-max
  and PET z-score preprocess in the step, against JAX's step compiled
  without XLA's fusion pass (``torch_port_helpers.run_unfused``; the
  ``SmallPETCNN`` towers' ``s2d_pool`` lowering needs it): stage 3 frozen;
  stage 3 at ``lr_pretrained`` over frozen (shared) stage-2 models; and
  towers trained (stage-2 ``lr_pretrained``, unshared); ``l2_reg`` 1e-2
  throughout. Loss rtol 1e-4, logits as above, Adam's first moments rtol
  2e-3 with atol 1e-3 of the leaf's largest, updated parameters within
  1e-7 plus one float32 ulp where the gradient exceeds 1e-4, running
  statistics rtol 2e-4, atol 2e-5 (tests/test_torch_fusion.py).
- Three shared steps, then ``sync_tower_duplicates``, equal three unshared
  steps bit for bit (parameters, statistics, loss), frozen and at
  ``lr_pretrained`` with L2: the unread duplicate towers get a zero
  gradient, as in JAX (tests/test_share_towers.py is the JAX oracle).
- ``sync_tower_duplicates`` and ``assert_tower_duplicates_equal`` against
  JAX's on converted trees, their copies, and the mismatches they refuse.
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
    all_modalities_fusion as jax_stage3,
    train_all_modalities_fusion as jax_train_stage3,
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
    train_all_modalities_fusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.all_modalities_fusion import (
    AllModalitiesFusion,
)
from multimodal_alzheimer_tpu_torch.train import driver
from multimodal_alzheimer_tpu_torch.train.checkpoint import (
    TOWER_DUPLICATES,
    assert_tower_duplicates_equal,
    sync_tower_duplicates,
)
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
# one Adam update of about lr rounds onto each side's parameter once: the
# two stay within 1e-7 plus one float32 ulp of the parameter
PARAM_TOL = dict(rtol=2.0 ** -23, atol=1e-7)
GRAD_FLOOR = 1e-4
MINMAX = {"per_scan_norm": "min_max"}
PET_NORM = {"mean": 0.5, "std": 0.25}

PET_HP = {"n_classes": 3, "conv_out": (4, 8), "filter_size": (3, 3),
          "batchnorm": True, "linear_out": 16}
MRI_HP = {"n_classes": 3, "resnet_depth": 10, "linear_out": ()}
TAB_HP = {"n_classes": 3, "hidden": (16, 32), "feature_mean": [0.5] * 9,
          "feature_std": [1.5] * 9}
TOWERS = (PET_HP, MRI_HP, TAB_HP)
HEADS = set(train_all_modalities_fusion.HEAD_NAMES)
TOWER_PREFIXES = [p for pair in TOWER_DUPLICATES for p in pair]


def _stage2(trained: bool = False) -> tuple:
    """(anat_pet, anat_tab, pet_tab) hparams; ``trained`` sets their
    ``lr_pretrained``, which unfreezes their towers."""
    extra = {"lr_pretrained": 1e-5} if trained else {}
    return ({"n_classes": 3, **extra}, {"n_classes": 3, **extra},
            {"n_classes": 3, "simple_dim_red": True, **extra})


def _example(n=1):
    return {"mri": jnp.zeros((n,) + SHAPE, jnp.float32),
            "pet1451": jnp.zeros((n,) + SHAPE, jnp.float32),
            "tabular": jnp.zeros((n, 9), jnp.float32)}


@pytest.fixture(scope="module")
def variables():
    """numpy variables of the stage-3 tree at seed 0, duplicate towers
    synced (the frozen grafting regime)."""
    model = jax_stage3.AllModalitiesFusion.from_hparams(
        {"n_classes": 3}, *_stage2(), *TOWERS)
    return jax_checkpoint.sync_tower_duplicates(
        random_variables(model, 0, _example(), train=False))


def _port(variables, hp=None, stage2=None, **overrides):
    model = AllModalitiesFusion.from_hparams(
        hp or {"n_classes": 3}, *(stage2 or _stage2()), *TOWERS,
        **overrides)
    model.load_state_dict(state_dict_from_flax(variables, model))
    return model


def _jax(hp=None, stage2=None, **overrides):
    return jax_stage3.AllModalitiesFusion.from_hparams(
        hp or {"n_classes": 3}, *(stage2 or _stage2()), *TOWERS, **overrides)


def _inputs(seed, n=2):
    """Normalised inputs for the eval comparison."""
    rng = np.random.default_rng(seed)
    return {"mri": rng.normal(size=(n,) + SHAPE).astype(np.float32),
            "pet1451": rng.normal(0.5, 0.5, (n,) + SHAPE).astype(np.float32),
            "tabular": rng.normal(0.5, 1.5, (n, 9)).astype(np.float32)}


def _torch(x: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in x.items()}


FORWARD_CASES = [("shared", "float32"), ("unshared", "float32"),
                 ("shared", "bfloat16")]


@pytest.mark.parametrize("share,dtype", FORWARD_CASES)
def test_forward_matches_jax(variables, share, dtype):
    shared = share == "shared"
    torch_dtype = getattr(torch, dtype)
    dtypes = [jnp.float32] + ([jnp.bfloat16] if dtype == "bfloat16" else [])
    x = _inputs(1)
    want = {dt: jax.jit(lambda v, b, m=_jax(share_towers=shared, dtype=dt):
                        m.apply(v, b, train=False))(
        variables, {k: jnp.asarray(v) for k, v in x.items()})
        for dt in dtypes}
    port = _port(variables, share_towers=shared, dtype=torch_dtype).eval()
    assert port.share_towers == shared
    with torch.inference_mode():
        got = port(_torch(x))
    assert got["logits"].dtype == torch.float32
    assert got["embeddings"]["fusion"].dtype == torch_dtype
    for what in ("logits", "fusion"):
        g = (got["logits"] if what == "logits"
             else got["embeddings"]["fusion"]).float().numpy()
        w32 = (want[jnp.float32]["logits"] if what == "logits"
               else want[jnp.float32]["embeddings"]["fusion"])
        if dtype == "float32":
            np.testing.assert_allclose(g, np.asarray(w32), **MODEL_TOL,
                                       err_msg=what)
        else:
            w16 = (want[jnp.bfloat16]["logits"] if what == "logits"
                   else want[jnp.bfloat16]["embeddings"]["fusion"])
            ref = dist(np.asarray(w16, np.float32), w32)
            assert dist(g, w32) <= 2 * ref, (what, dist(g, w32), ref)


REGIMES = [
    # (stage-3 hparams extra, stage-2 trained by name, overrides)
    ({}, (), {}),
    ({"lr_pretrained": None}, (), {}),
    ({"lr_pretrained": 1e-5}, (), {}),
    ({"lr_pretrained": 1e-5}, ("anat_pet",), {}),
    ({"lr_pretrained": None}, ("pet_tab",), {}),
    ({"lr_pretrained": 1e-5}, ("anat_pet", "anat_tab", "pet_tab"), {}),
    ({"lr_pretrained": None}, (), {"share_towers": False}),
    ({"lr_pretrained": 1e-5}, (), {"freeze_towers": True}),
]


@pytest.mark.parametrize("extra,trained,overrides", REGIMES)
def test_from_hparams_derives_freeze_and_share_as_jax(extra, trained,
                                                      overrides):
    hp = {"n_classes": 3, **extra}
    stage2 = [dict(h, lr_pretrained=1e-6) if name in trained else h
              for name, h in zip(("anat_pet", "anat_tab", "pet_tab"),
                                 _stage2())]
    port = AllModalitiesFusion.from_hparams(hp, *stage2, *TOWERS,
                                            device="meta", **overrides)
    ref = _jax(hp, stage2, **overrides)
    assert port.freeze_towers == ref.freeze_towers
    assert port.share_towers == ref.share_towers
    for name in ("model_anat_pet", "model_anat_tab", "model_pet_tab"):
        assert getattr(port, name).freeze_towers == \
            getattr(ref, name).freeze_towers
    assert port.share_towers == (not trained
                                 and "share_towers" not in overrides)


def _conv_calls(model, batch) -> dict:
    """{Conv3d module name: calls} over one forward."""
    calls = {}
    hooks = [m.register_forward_hook(
        lambda *_, n=name: calls.__setitem__(n, calls.get(n, 0) + 1))
        for name, m in model.named_modules()
        if isinstance(m, torch.nn.Conv3d)]
    with torch.inference_mode():
        out = model(batch)
    for h in hooks:
        h.remove()
    return calls, out


def test_shared_logits_bit_identical_and_forward_smaller(variables):
    shared = _port(variables)
    unshared = _port(variables, share_towers=False)
    assert shared.share_towers and not unshared.share_towers
    x = _torch(_inputs(2))
    calls_s, out_s = _conv_calls(shared.eval(), x)
    calls_u, out_u = _conv_calls(unshared.eval(), x)
    torch.testing.assert_close(out_s["logits"], out_u["logits"], rtol=0,
                               atol=0)
    torch.testing.assert_close(out_s["embeddings"]["fusion"],
                               out_u["embeddings"]["fusion"], rtol=0, atol=0)
    # the unshared forward runs the PET and MRI towers twice each, the
    # shared one once, and never a duplicate copy
    assert sum(calls_s.values()) < sum(calls_u.values())
    duplicates = [d for _, d in TOWER_DUPLICATES]
    assert calls_u and all(calls_u[n] == 1 for n in calls_u)
    assert not [n for n in calls_s if n.startswith(tuple(duplicates))]
    assert set(calls_s) == {n for n in calls_u
                            if not n.startswith(tuple(duplicates))}
    # train mode too (batch statistics)
    with torch.no_grad():
        train_s = shared.train()(x)["logits"]
        train_u = unshared.train()(x)["logits"]
    torch.testing.assert_close(train_s, train_u, rtol=0, atol=0)


def test_external_towers_and_fusion_inputs(variables, monkeypatch):
    model = _port(variables, {"n_classes": 3, "lr_pretrained": None}).eval()
    assert model.freeze_towers and model.share_towers
    x = _torch(_inputs(3))
    with torch.inference_mode():
        want = model(x)
        towers = {"pet": model.model_anat_pet.pet_model(x),
                  "mri": model.model_anat_pet.mri_model(x),
                  "tab": model.model_anat_tab.tab_model(x)}
        taps = {name: getattr(model, f"model_{name}")(x)["embeddings"][
            "fusion"] for name in ("anat_pet", "anat_tab", "pet_tab")}

    def boom(*args, **kwargs):
        raise AssertionError("a replaced module ran")

    with monkeypatch.context() as m:
        for prefix in TOWER_PREFIXES:
            m.setattr(model.get_submodule(prefix), "forward", boom)
        with torch.inference_mode():
            got = model(x, towers=towers)
    torch.testing.assert_close(got["logits"], want["logits"], rtol=0,
                               atol=0)
    with monkeypatch.context() as m:
        for name in ("anat_pet", "anat_tab", "pet_tab"):
            m.setattr(getattr(model, f"model_{name}"), "forward", boom)
        with torch.inference_mode():
            got = model(x, fusion_inputs=taps)
    torch.testing.assert_close(got["logits"], want["logits"], rtol=0,
                               atol=0)

    # misuse raises JAX's errors
    jx = {k: jnp.asarray(v) for k, v in _inputs(3).items()}
    cases = [
        (dict(share_towers=False), dict(towers={"pet": towers["pet"]}),
         dict(towers={"pet": {}}), "external towers require"),
        (dict(hp={"n_classes": 3, "lr_pretrained": 1e-5}),
         dict(fusion_inputs=taps), dict(fusion_inputs={}),
         "fusion_inputs requires freeze_towers"),
        (dict(stage2=_stage2(trained=True), share_towers=True), {}, {},
         "share_towers=True requires freeze_towers=True"),
    ]
    for build, port_kwargs, jax_kwargs, match in cases:
        port = _port(variables, **build).eval()
        with pytest.raises(ValueError, match=match):
            with torch.inference_mode():
                port(x, **port_kwargs)
        with pytest.raises(ValueError, match=match):
            _jax(**build).apply(variables, jx, train=False, **jax_kwargs)


def _train_batch(seed=0):
    data = make_labeled_volumes(4, SHAPE, n_classes=3, seed=seed,
                                modalities=("mri", "pet1451", "tabular"))
    data["label"] = (np.arange(4) % 3).astype(np.int32)
    return data


STEP_CASES = {
    # stage-3 lr_pretrained, stage-2 towers trained
    "frozen": (None, False),
    "pretrained-shared": (1e-4, False),
    "towers-trained": (1e-4, True),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_adam_step_matches_jax(variables, case):
    lr_pretrained, trained = STEP_CASES[case]
    hp = {"n_classes": 3, "lr": 1e-3, "lr_pretrained": lr_pretrained,
          "l2_reg": 1e-2, "loss_class_weights": [0.4, 0.3, 0.3]}
    stage2 = _stage2(trained)
    ref = _jax(hp, stage2)
    port = _port(variables, hp, stage2)
    assert (port.freeze_towers, port.share_towers) == \
        (ref.freeze_towers, ref.share_towers) == \
        (lr_pretrained is None, not trained)
    batch = _train_batch()
    holder = type("Holder", (), {"normalize_pet": PET_NORM,
                                 "normalize_mri": MINMAX,
                                 "quantile": 0.99})()
    optimizer = jax_driver.fusion_optimizer(hp, jax_train_stage3.HEAD_NAMES)
    step = jax_train_step(ref, jax_criterion(hp), optimizer,
                          JaxDataset.get_device_preprocess(holder))
    state, aux = run_unfused(
        step, JaxTrainState.create(variables, optimizer),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    want_params, want_mu = flat(state.params), adam_mu(state.opt_state)

    port_opt = driver.fusion_optimizer(
        hp, train_all_modalities_fusion.HEAD_NAMES, port)
    port_step = make_train_step(port, make_criterion(hp), port_opt,
                                make_device_preprocess(PET_NORM, MINMAX))
    _, paux = port_step(TrainState(port, port_opt), _torch(batch))

    np.testing.assert_allclose(float(paux["loss"]), float(aux["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(paux["logits"].numpy(),
                               np.asarray(aux["logits"]), **MODEL_TOL)
    stats = flat(flax_from_state_dict(port.state_dict())["batch_stats"])
    before_stats = flat(variables["batch_stats"])
    duplicates = {tuple(d.split(".")) for _, d in TOWER_DUPLICATES}
    assert set(stats) == set(flat(state.batch_stats)) and stats
    for key, value in flat(state.batch_stats).items():
        np.testing.assert_allclose(stats[key], value, err_msg=str(key),
                                   **STATS_TOL)
        # the shared forward leaves the duplicates' statistics alone
        unread = port.share_towers and key[:2] in duplicates
        assert np.array_equal(value, before_stats[key]) == unread, key

    sd = dict(port.state_dict())
    sd.update({n: port_opt.state[p]["exp_avg"]
               for n, p in port.named_parameters() if p in port_opt.state})
    got_mu = flat(flax_from_state_dict(sd)["params"])
    got_params = flat(flax_from_state_dict(port.state_dict())["params"])
    assert {k[0] for k in want_mu} == (
        HEADS if lr_pretrained is None else {k[0] for k in want_params})
    for key, m in want_mu.items():
        np.testing.assert_allclose(got_mu[key], m, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * float(np.abs(m).max()),
                                   err_msg=str(key))
        moved = np.abs(m / 0.1) > GRAD_FLOOR
        np.testing.assert_allclose(got_params[key][moved],
                                   want_params[key][moved], **PARAM_TOL,
                                   err_msg=str(key))
    before = flat(variables["params"])
    for key, value in want_params.items():
        if key not in want_mu:  # frozen: no move on either side
            np.testing.assert_array_equal(value, before[key])
            np.testing.assert_array_equal(got_params[key], before[key])
    # a tower backward runs only where the stage-2 models train theirs
    tower_grads = [p.grad for n, p in port.named_parameters()
                   if n.startswith(tuple(TOWER_PREFIXES))]
    assert tower_grads and any(g is not None and bool(g.abs().sum())
                               for g in tower_grads) == trained


@pytest.mark.parametrize("lr_pretrained", [None, 1e-4],
                         ids=["frozen", "pretrained-l2"])
def test_shared_trajectory_equals_unshared(variables, lr_pretrained):
    """Three steps shared and unshared from the same synced weights: equal
    parameters and losses, and equal statistics once the shared run's are
    mirrored to the duplicates (what the Trainer does when it saves)."""
    hp = {"n_classes": 3, "lr": 1e-3, "lr_pretrained": lr_pretrained,
          "l2_reg": 1e-2, "loss_class_weights": [0.4, 0.3, 0.3]}
    batch = _torch(_train_batch(1))
    runs = {}
    for share in (True, False):
        model = _port(variables, hp, share_towers=share)
        optimizer = driver.fusion_optimizer(
            hp, train_all_modalities_fusion.HEAD_NAMES, model)
        step = make_train_step(model, make_criterion(hp), optimizer,
                               make_device_preprocess(PET_NORM, MINMAX))
        state = TrainState(model, optimizer)
        losses = []
        for _ in range(3):
            state, aux = step(state, batch)
            losses.append(float(aux["loss"]))
        runs[share] = (model.state_dict(), losses)
    (sd_s, loss_s), (sd_u, loss_u) = runs[True], runs[False]
    assert loss_s == loss_u
    synced = sync_tower_duplicates(sd_s)
    assert synced.keys() == sd_u.keys()
    for key, value in sd_u.items():
        assert torch.equal(synced[key], value), key
        if "running" not in key:
            assert torch.equal(sd_s[key], value), key
    start = state_dict_from_flax(variables, model)
    moved = [k for k in sd_u if not torch.equal(sd_u[k], start[k])]
    dup = tuple(d + "." for _, d in TOWER_DUPLICATES)
    # with L2 the unread duplicate towers still move (zero gradient + L2)
    assert any(k.startswith(dup) and "running" not in k
               for k in moved) == (lr_pretrained is not None)


def _port_sd(seed=0):
    """A port stage-3 state dict whose duplicates differ (independent
    initialisations)."""
    torch.manual_seed(seed)
    return AllModalitiesFusion.from_hparams(
        {"n_classes": 3}, *_stage2(), *TOWERS).state_dict()


def test_sync_and_assert_match_jax():
    sd = _port_sd()
    with pytest.raises(ValueError, match="duplicate mismatch"):
        assert_tower_duplicates_equal(sd)
    with pytest.raises(ValueError, match="duplicate mismatch"):
        jax_checkpoint.assert_tower_duplicates_equal(flax_from_state_dict(sd))
    synced = sync_tower_duplicates(sd)
    assert_tower_duplicates_equal(synced)
    want = flat(jax_checkpoint.sync_tower_duplicates(
        flax_from_state_dict(sd)))
    got = flat(flax_from_state_dict(synced))
    assert set(want) == set(got)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=str(key))
    # real copies, and the input state dict is left as it was
    for canonical, duplicate in TOWER_DUPLICATES:
        for key in [k for k in sd if k.startswith(canonical + ".")]:
            dup = duplicate + key[len(canonical):]
            assert synced[dup].data_ptr() != synced[key].data_ptr()
            assert synced[dup] is not sd[key]
            assert sd[dup] is not synced[dup]
    assert not all(torch.equal(sd[k], synced[k]) for k in sd)
    # a duplicate that differs by a name or a shape is refused
    key = "model_pet_tab.pet_model.cls.weight"
    for mutate, match in (
            (lambda d: d.__setitem__(key, torch.zeros(5, 5)),
             "shape mismatch"),
            (lambda d: d.pop(key), "structure mismatch")):
        bad = dict(synced)
        mutate(bad)
        for fn in (sync_tower_duplicates, assert_tower_duplicates_equal):
            with pytest.raises(ValueError, match=match):
                fn(bad)
        with pytest.raises(ValueError, match=match):
            jax_checkpoint.sync_tower_duplicates(flax_from_state_dict(bad))
    # trees of other models pass through
    other = {"cls.weight": torch.ones(2, 2)}
    assert_tower_duplicates_equal(other)
    assert sync_tower_duplicates(other) == other


@pytest.mark.parametrize("seed", range(2))
def test_sample_hparams_and_constants_match_jax(seed):
    paths = {"path_pet": "p", "path_mri": "m", "path_tabular": "t",
             "path_anat_pet": "ap", "path_anat_tab": "at",
             "path_pet_tab": "pt"}
    port_trial, jax_trial = Trial(seed), Trial(seed)
    assert train_all_modalities_fusion.sample_hparams(port_trial, **paths) \
        == jax_train_stage3.sample_hparams(jax_trial, **paths)
    assert port_trial.calls == jax_trial.calls
    for attr in ("SEED", "LOG_DIRECTORY", "EXPERIMENT_NAME", "HEAD_NAMES"):
        assert getattr(train_all_modalities_fusion, attr) == \
            getattr(jax_train_stage3, attr)
    assert TOWER_DUPLICATES == tuple(
        tuple(p.replace("/", ".") for p in pair)
        for pair in jax_checkpoint.TOWER_DUPLICATES)
