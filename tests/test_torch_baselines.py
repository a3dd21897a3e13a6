"""The port's fusion baselines, ``PETMRIEarlyFusion`` and
``PETMRIFeatureMapFusion``, against the JAX package's (CPU).

One converted weight tree (``models/convert.py``) drives both packages at
(12, 14, 12), with PET and MRI inputs drawn from different distributions
(so a swapped channel order shows):

- eval forward, logits and every embedding tap: float32 within rtol 1e-4,
  atol 1e-5 (the small CNN's model-parity tolerance,
  tests/test_torch_pet.py); bfloat16 within twice JAX's own bf16-vs-f32
  distance of JAX's f32 result (tests/test_torch_dtype.py). Early fusion
  with and without BatchNorm and hidden Linear; feature-map fusion in
  maxout and concatenate, BatchNorm on and off, ``bn_torch_stats``, and two
  fusion layers (the channel chaining JAX chose over the reference's
  ``n_in_fusion *= 2``);
- one Adam train step each, raw scans through the preprocess in the step
  (early fusion under the per-scan min-max, feature-map fusion under the
  all-scan z-score), against JAX's step compiled without XLA's fusion pass
  (``torch_port_helpers.run_unfused``: fused, on the CPU, the towers'
  ``s2d_pool`` lowering gives early-layer gradients that finite
  differences refute): loss rtol 1e-4, logits rtol 1e-4 / atol 1e-5,
  Adam's first moments rtol 2e-3 with atol 1e-3 of the leaf's largest,
  updated parameters within 1e-7 plus one float32 ulp where the gradient
  exceeds 1e-4, running statistics rtol 2e-4, atol 2e-5
  (tests/test_torch_fusion.py);
- the max-pool guard: a tower too deep for the volume raises, in both;
- ``compute_split_stats`` within rtol 1e-6 of JAX's (float32 sums in
  another order); the constants; ``sample_hparams`` with the duck-typed
  ``Trial``; ``from_hparams``.
"""

import dataclasses

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
    early_fusion as jax_early,
    featuremap_fusion as jax_fmf,
    train_anat_pet_featuremapfusion as jax_train_fmf,
    train_early_fusion as jax_train_early,
)
from multimodal_alzheimer_tpu.ops import normalization as jax_normalization
from multimodal_alzheimer_tpu.train import optim as jax_optim
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
    train_anat_pet_featuremapfusion as train_fmf,
    train_early_fusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.early_fusion import (
    PETMRIEarlyFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.featuremap_fusion import (
    PETMRIFeatureMapFusion,
)
from multimodal_alzheimer_tpu_torch.ops.normalization import (
    compute_split_stats,
)
from multimodal_alzheimer_tpu_torch.train.optim import single_lr_optimizer
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
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-3
STATS_TOL = dict(rtol=2e-4, atol=2e-5)
# one Adam update of about lr rounds onto each side's parameter once: the
# two stay within 1e-7 plus one float32 ulp of the parameter
PARAM_TOL = dict(rtol=2.0 ** -23, atol=1e-7)
GRAD_FLOOR = 1e-4
SPLIT_RTOL = 1e-6
PET_NORM = {"mean": 0.5, "std": 0.25}

EARLY = {"n_classes": 2, "conv_out": (4, 8), "filter_size": (5, 3),
         "linear_out": 16}
FMF = {"n_classes": 2, "conv_out": (4, 8), "filter_size": (5, 3),
       "n_out_fusion": 8, "filter_size_fusion": 3}
# name -> (JAX class, port class, hparams)
MODELS = {
    "early": (jax_early.PETMRIEarlyFusion, PETMRIEarlyFusion, EARLY),
    "early-bn-nohidden": (jax_early.PETMRIEarlyFusion, PETMRIEarlyFusion,
                          dict(EARLY, batchnorm=True, linear_out=0,
                               n_classes=3)),
    "fmf-maxout-bn": (jax_fmf.PETMRIFeatureMapFusion, PETMRIFeatureMapFusion,
                      dict(FMF, fusion_mode="maxout", batchnorm=True,
                           batchnorm_fusion=True)),
    "fmf-concat": (jax_fmf.PETMRIFeatureMapFusion, PETMRIFeatureMapFusion,
                   dict(FMF, fusion_mode="concatenate")),
    "fmf-concat-torchstats-2layers": (
        jax_fmf.PETMRIFeatureMapFusion, PETMRIFeatureMapFusion,
        dict(FMF, fusion_mode="concatenate", batchnorm=True,
             batchnorm_fusion=True, bn_torch_stats=True, n_layers_fusion=2,
             conv_out=(4,), filter_size=(3,))),
}


def _example(n=1):
    return {k: jnp.zeros((n,) + SHAPE, jnp.float32)
            for k in ("pet1451", "mri")}


def _setup(name, seed=0, dtype=torch.float32, **extra):
    """(JAX models by dtype, numpy variables, port model)."""
    jax_cls, port_cls, hp = MODELS[name]
    hp = dict(hp, **extra)
    jax_models = {dt: jax_cls.from_hparams(hp, dtype=dt)
                  for dt in (jnp.float32, jnp.bfloat16)}
    variables = random_variables(jax_models[jnp.float32], seed, _example(),
                                 train=False)
    port = port_cls.from_hparams(hp, dtype=dtype)
    port.load_state_dict(state_dict_from_flax(variables, port))
    return jax_models, variables, port


def _inputs(seed, n=3):
    """PET around its z-scored range, MRI wider and shifted: the two
    channels differ."""
    rng = np.random.default_rng(seed)
    return {"pet1451": rng.normal(0.5, 0.5, (n,) + SHAPE).astype(np.float32),
            "mri": rng.normal(-1.0, 2.0, (n,) + SHAPE).astype(np.float32)}


def _torch(x):
    return {k: torch.from_numpy(v) for k, v in x.items()}


FORWARD_CASES = [(name, "float32") for name in MODELS] + [
    (name, "bfloat16") for name in ("early-bn-nohidden", "fmf-maxout-bn",
                                    "fmf-concat-torchstats-2layers")]


@pytest.mark.parametrize("name,dtype", FORWARD_CASES)
def test_forward_matches_jax(name, dtype):
    torch_dtype = getattr(torch, dtype)
    jax_models, variables, port = _setup(name, dtype=torch_dtype)
    x = _inputs(1)
    dtypes = [jnp.float32] + ([jnp.bfloat16] if dtype == "bfloat16" else [])
    want = {dt: jax.jit(lambda v, b, m=jax_models[dt]: m.apply(
        v, b, train=False))(variables, {k: jnp.asarray(v)
                                        for k, v in x.items()})
        for dt in dtypes}
    with torch.inference_mode():
        got = port.eval()(_torch(x))
        swapped = port({"pet1451": _torch(x)["mri"],
                        "mri": _torch(x)["pet1451"]})
    assert got["logits"].dtype == torch.float32
    assert set(got["embeddings"]) == set(want[jnp.float32]["embeddings"])
    # a swapped channel order would show
    assert dist(swapped["logits"].float(), got["logits"].float()) > 1e-3
    pairs = [("logits", got["logits"], want[jnp.float32]["logits"],
              want.get(jnp.bfloat16, {}).get("logits"))]
    for tap, value in got["embeddings"].items():
        assert value.dtype == torch_dtype, tap
        pairs.append((tap, value, want[jnp.float32]["embeddings"][tap],
                      want.get(jnp.bfloat16, {}).get("embeddings",
                                                     {}).get(tap)))
    for what, g, w32, w16 in pairs:
        g = g.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, np.asarray(w32), **MODEL_TOL,
                                       err_msg=what)
        else:
            ref = dist(np.asarray(w16, np.float32), w32)
            assert dist(g, w32) <= 2 * ref, (what, dist(g, w32), ref)


STEP_CASES = {
    # name -> (model, MRI normalisation)
    "early-differentnorm": ("early-bn-nohidden", {"per_scan_norm":
                                                  "min_max"}),
    "early-samenorm": ("early", {"all_scan_norm": {"mean": 0.3,
                                                   "std": 1.5}}),
    "fmf-maxout": ("fmf-maxout-bn", {"all_scan_norm": {"mean": 0.3,
                                                       "std": 1.5}}),
    "fmf-concat": ("fmf-concat-torchstats-2layers",
                   {"all_scan_norm": {"mean": 0.3, "std": 1.5}}),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case):
    name, mri_norm = STEP_CASES[case]
    jax_models, variables, port = _setup(name, seed=2)
    n_classes = port.n_classes
    hp = {"lr": 1e-3, "l2_reg": 1e-2,
          "loss_class_weights": [0.4, 0.3, 0.3][:n_classes]}
    data = make_labeled_volumes(4, SHAPE, n_classes=n_classes, seed=0,
                                modalities=("mri", "pet1451"))
    data["label"] = (np.arange(4) % n_classes).astype(np.int32)

    holder = type("Holder", (), {"normalize_pet": PET_NORM,
                                 "normalize_mri": mri_norm,
                                 "quantile": 0.99})()
    optimizer = jax_optim.single_lr_optimizer(hp["lr"], hp["l2_reg"])
    step = jax_train_step(jax_models[jnp.float32], jax_criterion(hp),
                          optimizer, JaxDataset.get_device_preprocess(holder))
    state, aux = run_unfused(
        step, JaxTrainState.create(variables, optimizer),
        {k: jnp.asarray(v) for k, v in data.items()}, jax.random.PRNGKey(0))

    port_opt = single_lr_optimizer(port, hp["lr"], hp["l2_reg"])
    port_step = make_train_step(port, make_criterion(hp), port_opt,
                                make_device_preprocess(PET_NORM, mri_norm))
    _, paux = port_step(TrainState(port, port_opt), _torch(data))

    np.testing.assert_allclose(float(paux["loss"]), float(aux["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(paux["logits"].numpy(),
                               np.asarray(aux["logits"]), **MODEL_TOL)
    want_stats = flat(state.batch_stats)
    stats = flat(flax_from_state_dict(port.state_dict())["batch_stats"])
    assert set(stats) == set(want_stats)
    for key, value in want_stats.items():
        np.testing.assert_allclose(stats[key], value, err_msg=str(key),
                                   **STATS_TOL)
    sd = dict(port.state_dict())
    sd.update({n: port_opt.state[p]["exp_avg"]
               for n, p in port.named_parameters()})
    got_mu = flat(flax_from_state_dict(sd)["params"])
    got_params = flat(flax_from_state_dict(port.state_dict())["params"])
    want_params, want_mu = flat(state.params), adam_mu(state.opt_state)
    assert set(want_mu) == set(got_mu) == set(want_params)
    for key, m in want_mu.items():
        np.testing.assert_allclose(got_mu[key], m, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * float(np.abs(m).max()),
                                   err_msg=str(key))
        moved = np.abs(m / 0.1) > GRAD_FLOOR
        assert moved.any(), key
        np.testing.assert_allclose(got_params[key][moved],
                                   want_params[key][moved], **PARAM_TOL,
                                   err_msg=str(key))


@pytest.mark.parametrize("name,hp", [
    ("early", dict(EARLY, conv_out=(4, 4, 4, 4), filter_size=(3,) * 4)),
    ("fmf", dict(FMF, fusion_mode="maxout", conv_out=(4, 4, 4),
                 filter_size=(3,) * 3)),
])
def test_a_tower_too_deep_for_the_volume_raises(name, hp):
    """12 -> 6 -> 3 -> 1: the next window-2 pool has no output. torch's
    MaxPool3d and JAX's max_pool3d raise there rather than pool to an empty
    tensor whose GAP is NaN."""
    jax_cls, port_cls = {
        "early": (jax_early.PETMRIEarlyFusion, PETMRIEarlyFusion),
        "fmf": (jax_fmf.PETMRIFeatureMapFusion, PETMRIFeatureMapFusion),
    }[name]
    port = port_cls.from_hparams(hp)
    with pytest.raises(ValueError, match="too deep"):
        port(_torch(_inputs(0, n=1)))
    model = jax_cls.from_hparams(hp)
    with pytest.raises(ValueError, match="too deep"):
        jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), _example()))


def test_unknown_fusion_mode_raises():
    with pytest.raises(ValueError, match="fusion_mode"):
        PETMRIFeatureMapFusion(2, fusion_mode="sum")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_from_hparams_matches_jax(name):
    jax_cls, port_cls, hp = MODELS[name]
    ref = jax_cls.from_hparams(hp)
    port = port_cls.from_hparams(hp, device="meta")
    fields = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)
              if f.name not in ("parent", "name", "dtype")}
    assert port.n_classes == fields["n_classes"]
    if port_cls is PETMRIFeatureMapFusion:
        assert port.fusion_mode == fields["fusion_mode"]
        assert port.n_layers_fusion == fields["n_layers_fusion"]
        assert port.batchnorm_fusion == fields["batchnorm_fusion"]
        assert port.fusion_conv_0.in_channels == \
            (2 if fields["fusion_mode"] == "concatenate" else 1) * \
            fields["conv_out"][-1]
    else:
        assert (port.hidden is not None) == bool(fields["linear_out"])
        assert port.convs.block_0.conv.in_channels == 2


def test_compute_split_stats_matches_jax():
    rng = np.random.default_rng(4)
    volumes = [rng.normal(400.0, 900.0, SHAPE).astype(np.float32)
               for _ in range(5)]
    volumes.append(np.abs(volumes[0]))
    got = compute_split_stats(iter(volumes))
    want = jax_normalization.compute_split_stats(iter(volumes))
    np.testing.assert_allclose(got, want, rtol=SPLIT_RTOL)
    # torch tensors and float64 arrays are taken as float32, as JAX takes
    # them with 64-bit mode off
    assert compute_split_stats(torch.from_numpy(v) for v in volumes) == got
    np.testing.assert_allclose(
        compute_split_stats(v.astype(np.float64) for v in volumes), got,
        rtol=0)


def test_constants_match_jax():
    assert train_early_fusion.MRI_ALL_SCAN_STATS == \
        jax_train_early.MRI_ALL_SCAN_STATS
    assert train_early_fusion.BEST_HPARAMS == jax_train_early.BEST_HPARAMS
    assert train_fmf.BEST_MAXOUT_HPARAMS == jax_train_fmf.BEST_MAXOUT_HPARAMS
    assert train_fmf.MRI_ALL_SCAN_STATS is \
        train_early_fusion.MRI_ALL_SCAN_STATS
    for port_mod, jax_mod in ((train_early_fusion, jax_train_early),
                              (train_fmf, jax_train_fmf)):
        for attr in ("SEED", "LOG_DIRECTORY", "EXPERIMENT_NAME",
                     "EXPERIMENT_VERSION"):
            assert getattr(port_mod, attr) == getattr(jax_mod, attr)


@pytest.mark.parametrize("seed", range(4))
def test_sample_hparams_matches_jax(seed):
    port_trial, jax_trial = Trial(seed), Trial(seed)
    assert train_fmf.sample_hparams(port_trial) == \
        jax_train_fmf.sample_hparams(jax_trial)
    assert port_trial.calls == jax_trial.calls
