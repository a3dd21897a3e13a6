"""The port in bfloat16 compute against the JAX package's bfloat16 models
(CPU).

Both packages keep float32 parameters and BatchNorm statistics and compute
in ``dtype``; one converted weight tree (``models/convert.py``) drives the
float32 and the bfloat16 model of each. The two frameworks round bf16 at
other places (XLA fuses elementwise chains in float32, torch rounds after
every operation), so the port cannot match JAX's bf16 bit for bit, and each
side's bf16 error is its own. The tolerance calibrates itself against the
float32 result both approximate: for every compared quantity, the port's
bf16 result must lie within twice the distance (largest absolute
difference) between JAX's own bf16 and float32 results of the float32
result, measured in the same test. A scalar (the loss) has one value of that
distance, which can be small by chance; its distance is taken as at least
one bf16 rounding of the f32 value (2^-8 of it). Argmax must agree wherever
the float32 logit margin exceeds the distance.

Covered: ``AnatCNN`` with every ``fused_bn`` mode, ``PETResNetCNN`` with the
"wf" stem pool and ``SmallPETCNN``, in eval mode (logits and embeddings)
and in train mode (logits, embeddings and the updated running statistics);
one full train step (loss, gradient norms, parameters after Adam); the
plain versions of the BatchNorm kernels K4-K7 on bf16 activations against
``pallas_bn``'s kernels run in interpret mode: sums within 1e-6 of the sum
of magnitudes, y and dx within one bf16 ulp (the same float32 arithmetic,
each side rounding its result once; XLA may contract to FMA, so the float32
values can straddle a rounding boundary). Widths are the models' own;
volumes are 12x14x12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.losses import make_criterion as jax_criterion
from multimodal_alzheimer_tpu.models.mri_models.anat_cnn import (
    AnatCNN as JaxAnatCNN,
)
from multimodal_alzheimer_tpu.models.pet_models.pet_cnn import (
    SmallPETCNN as JaxSmallPETCNN,
)
from multimodal_alzheimer_tpu.models.pet_models.pet_resnet_cnn import (
    PETResNetCNN as JaxPETResNetCNN,
)
from multimodal_alzheimer_tpu.ops import pallas_bn
from multimodal_alzheimer_tpu_torch.losses.classification import (
    make_criterion,
)
from multimodal_alzheimer_tpu_torch.models.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
    SmallPETCNN,
)
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_resnet_cnn import (
    PETResNetCNN,
)
from multimodal_alzheimer_tpu_torch.ops import hopper_bn
from torch_port_helpers import dist, random_flax_variables
from torch_threads import torch_threads  # noqa: F401 (autouse)

SHAPE = (12, 14, 12)
BF16_ULP = 2.0 ** -8
EPS = 1e-5

ANAT_HP = {"n_classes": 3, "resnet_depth": 10, "linear_out": (16,),
           "batchnorm_dense": True}
PET_RESNET_HP = {"n_classes": 2, "resnet_depth": 10, "linear_out": ()}
SMALL_PET_HP = {"n_classes": 3, "conv_out": (4, 8, 8), "filter_size": (5, 3, 3),
                "batchnorm": True, "linear_out": 32}
# (JAX class, port class, hparams, model overrides, batch key)
MODELS = {
    **{f"anat-{mode}": (JaxAnatCNN, AnatCNN, ANAT_HP, {"fused_bn": mode},
                        "mri")
       for mode in (False, "full", "hybrid", "torch_stats")},
    "pet_resnet-wf": (JaxPETResNetCNN, PETResNetCNN, PET_RESNET_HP,
                      {"maxpool_impl": "wf"}, "pet1451"),
    "small_pet": (JaxSmallPETCNN, SmallPETCNN, SMALL_PET_HP, {}, "pet1451"),
}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_bn, "INTERPRET", True)


def _within(port, jax_bf16, jax_f32, what, scalar=False):
    """|port bf16 - JAX f32| <= 2 |JAX bf16 - JAX f32| (largest entries)."""
    ref = dist(jax_bf16, jax_f32)
    if scalar:
        ref = max(ref, BF16_ULP * abs(float(jax_f32)))
    got = dist(port, jax_f32)
    assert got <= 2 * ref, f"{what}: {got:.3g} from JAX f32, JAX bf16 " \
                           f"{ref:.3g}"
    return ref


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _setup(name, seed=0):
    jax_cls, port_cls, hp, overrides, key = MODELS[name]
    jax_models = {dt: jax_cls.from_hparams(hp, dtype=dt, **overrides)
                  for dt in (jnp.bfloat16, jnp.float32)}
    variables = random_flax_variables(jax_models[jnp.float32], SHAPE, seed,
                                      key)
    port = port_cls.from_hparams(hp, dtype=torch.bfloat16, **overrides)
    port.load_state_dict(state_dict_from_flax(variables, port))
    x = np.random.default_rng(seed + 1).normal(
        0.5, 0.5, (8,) + SHAPE).astype(np.float32)
    return jax_models, variables, port, key, x


def _check_outputs(port_out, jax_outs, what):
    """Logits (float32 on both sides) and every embedding (bf16 on both
    sides); argmax where the f32 margin is clear."""
    got, bf16, f32 = port_out, jax_outs[jnp.bfloat16], jax_outs[jnp.float32]
    assert got["logits"].dtype == torch.float32
    ref = _within(got["logits"].detach().float().numpy(), _f32(bf16["logits"]),
                  _f32(f32["logits"]), f"{what} logits")
    for tap, value in f32["embeddings"].items():
        assert got["embeddings"][tap].dtype == torch.bfloat16, tap
        assert bf16["embeddings"][tap].dtype == jnp.bfloat16, tap
        _within(got["embeddings"][tap].detach().float().numpy(),
                _f32(bf16["embeddings"][tap]), _f32(value),
                f"{what} {tap}")
    logits = np.asarray(f32["logits"])
    top2 = np.sort(logits, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > ref
    np.testing.assert_array_equal(
        got["logits"].detach().float().numpy().argmax(1)[clear],
        logits.argmax(1)[clear])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_eval_matches_jax(name):
    jax_models, variables, port, key, x = _setup(name)
    outs = {dt: jax.jit(lambda v, b, m=m: m.apply(v, b, train=False))(
        variables, {key: jnp.asarray(x)}) for dt, m in jax_models.items()}
    port.eval()
    with torch.inference_mode():
        got = port({key: torch.from_numpy(x)})
    _check_outputs(got, outs, f"{name} eval")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_train_mode_matches_jax(name):
    """Train-mode forward: outputs and the running statistics it leaves."""
    jax_models, variables, port, key, x = _setup(name, seed=3)

    def forward(model):
        return jax.jit(lambda v, b: model.apply(
            v, b, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)}))(
            variables, {key: jnp.asarray(x)})

    outs = {dt: forward(m) for dt, m in jax_models.items()}
    port.train()
    got = port({key: torch.from_numpy(x)})
    _check_outputs(got, {dt: o[0] for dt, o in outs.items()},
                   f"{name} train")
    stats = flax_from_state_dict(port.state_dict())["batch_stats"]
    want = {dt: o[1]["batch_stats"] for dt, o in outs.items()}
    assert jax.tree.structure(stats) == jax.tree.structure(
        want[jnp.float32])
    for kind in ("mean", "var"):  # every BatchNorm's, as one vector
        def flat(tree):
            return np.concatenate([
                np.asarray(leaf, np.float32).ravel() for path, leaf in
                jax.tree_util.tree_leaves_with_path(tree)
                if path[-1].key == kind])
        assert flat(stats).dtype == np.float32
        _within(flat(stats), flat(want[jnp.bfloat16]),
                flat(want[jnp.float32]), f"{name} running {kind}")


@pytest.mark.parametrize("mode", [False, "full", "hybrid", "torch_stats"])
def test_bf16_train_step_matches_jax(mode):
    """One Adam step of the bf16 AnatCNN from the same weights and batch:
    loss, every gradient's norm and the parameters after the update."""
    import optax

    hp = dict(ANAT_HP, loss_class_weights=[0.2, 0.5, 0.3])
    jax_models, variables, port, key, x = _setup(f"anat-{mode}", seed=5)
    labels = np.array([0, 2, 1, 2, 1, 0, 0, 2], np.int32)
    lr = 1e-3
    criterion = jax_criterion(hp)

    def jax_step(model):
        def loss_fn(params):
            out, _ = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                {key: jnp.asarray(x)}, train=True, mutable=["batch_stats"])
            return criterion(out["logits"], jnp.asarray(labels))

        params = jax.tree.map(jnp.asarray, variables["params"])
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        opt = optax.adam(lr)
        updates, _ = opt.update(grads, opt.init(params), params)
        return float(loss), grads, optax.apply_updates(params, updates)

    want = {dt: jax_step(m) for dt, m in jax_models.items()}
    port.train()
    optimizer = torch.optim.Adam(port.parameters(), lr=lr)
    loss = make_criterion(hp)(port({key: torch.from_numpy(x)})["logits"],
                              torch.from_numpy(labels).long())
    loss.backward()
    assert all(p.dtype == torch.float32 for p in port.parameters())
    params = dict(port.named_parameters())
    grads = flax_from_state_dict(
        {k: params[k].grad if k in params else v
         for k, v in port.state_dict().items()})["params"]
    optimizer.step()
    (l_b, g_b, p_b), (l_f, g_f, p_f) = want[jnp.bfloat16], want[jnp.float32]
    _within(loss.item(), l_b, l_f, "loss", scalar=True)

    def norms(tree):
        return np.array([np.linalg.norm(np.asarray(a, np.float64))
                         for a in jax.tree.leaves(tree)])

    def flat(tree):
        return np.concatenate([np.asarray(a, np.float32).ravel()
                               for a in jax.tree.leaves(tree)])

    assert jax.tree.structure(grads) == jax.tree.structure(g_f)
    _within(norms(grads), norms(g_b), norms(g_f),
            f"gradient norms of {len(norms(g_f))} parameters")
    port_params = flax_from_state_dict(
        {k: v.detach() for k, v in port.state_dict().items()})["params"]
    _within(flat(port_params), flat(p_b), flat(p_f), "parameters after Adam")


# ------------------------------------------------ K4-K7 in bf16, plain --

def _bf16_inputs(c, shape=(2, 4, 4, 4), seed=0):
    """NCDHW x and gy rounded to bf16 (as float32 numpy), float32 scale and
    bias."""
    rng = np.random.default_rng(seed)
    full = (shape[0], c) + shape[1:]
    x = (rng.normal(size=full) * 2 + 1).astype(np.float32)
    gy = rng.normal(size=full).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    gy = np.asarray(jnp.asarray(gy, jnp.bfloat16), np.float32)
    scale = (rng.normal(size=c) * 0.5 + 1).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    return x, gy, scale, bias


def _last(a):
    a = np.moveaxis(np.asarray(a), 1, -1)
    return a.reshape(-1, a.shape[-1])


def _first(a2, like):
    shape = (like.shape[0],) + like.shape[2:] + (like.shape[1],)
    return np.moveaxis(np.asarray(a2, np.float32).reshape(shape), -1, 1)


def _bf(a):
    return torch.from_numpy(np.array(a)).to(torch.bfloat16)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _one_rounding(got, want):
    """Equal up to one bf16 rounding of nearly the same float32 value: at
    most one bf16 ulp apart, 2^-7 of the value at most."""
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("c", [64, 256])
def test_bf16_kernel_plain_versions_match_pallas(c):
    """K4 sums, K5 y, K6 sums and K7 dx of bf16 activations against
    ``pallas_bn``'s forward and backward on the same bf16 rows."""
    x, gy, scale, bias = _bf16_inputs(c, seed=c)
    x2 = jnp.asarray(_last(x), jnp.bfloat16)
    g2 = jnp.asarray(_last(gy), jnp.bfloat16)
    y2, mean, var = pallas_bn._bn_fwd_impl(x2, jnp.asarray(scale),
                                           jnp.asarray(bias), EPS)
    assert y2.dtype == jnp.bfloat16
    dx2, dscale, dbias = pallas_bn._bn_bwd(
        EPS, (x2, jnp.asarray(scale), mean, var), (g2, None, None))
    assert dx2.dtype == jnp.bfloat16
    mean, var = np.asarray(mean), np.asarray(var)
    inv = np.asarray(jax.lax.rsqrt(jnp.asarray(var) + EPS))
    axes = (0, 2, 3, 4)
    t = _t

    sums = hopper_bn.bn_stats(_bf(x))
    assert sums.dtype == torch.float32
    n = x.size // c
    assert (np.abs(sums[0].numpy() / n - mean)
            <= 1e-6 * np.abs(x).mean(axes)).all()
    y = hopper_bn.bn_apply(_bf(x), t(mean), t(inv), t(scale), t(bias))
    assert y.dtype == torch.bfloat16
    _one_rounding(y.float().numpy(), _first(y2, x))
    red = hopper_bn.bn_grad_sum(_bf(gy), _bf(x), t(mean), t(inv))
    xhat = (x - mean[:, None, None, None]) * inv[:, None, None, None]
    err = np.abs(red.numpy() - np.stack([np.asarray(dbias),
                                         np.asarray(dscale)]))
    assert (err <= 1e-6 * np.stack([np.abs(gy).sum(axes),
                                    np.abs(gy * xhat).sum(axes)])).all()
    dx = hopper_bn.bn_dx(_bf(gy), _bf(x), t(mean), t(inv), t(scale),
                         red / n)
    assert dx.dtype == torch.bfloat16
    _one_rounding(dx.float().numpy(), _first(dx2, x))
