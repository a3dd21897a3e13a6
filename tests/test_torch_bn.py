"""The port's training-mode BatchNorm against the JAX package (CPU).

The JAX side runs ``ops/pallas_bn.py``'s kernels in interpret mode, as
tests/test_pallas_bn.py does; the port runs the plain PyTorch versions of
its four Hopper kernels (the wrappers take them for CPU tensors). Inputs are
drawn with numpy; the port takes them NCDHW, JAX as (N, C) channels-last.

Tolerances are JAX's own (tests/test_pallas_bn.py): y rtol/atol 2e-4; dx
rtol 2e-3, atol 2e-4; dscale/dbias rtol 2e-3, atol 1e-3; running statistics
rtol 2e-4, atol 2e-5. The kernel-level checks are tighter: both sides do the
same f32 arithmetic and differ only in summation order (sums, relative to
the sum of magnitudes) or in FMA contraction (elementwise passes).
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.models import layers as jax_layers
from multimodal_alzheimer_tpu.ops import pallas_bn
from multimodal_alzheimer_tpu_torch.models import layers
from multimodal_alzheimer_tpu_torch.ops import hopper_bn
from torch_threads import torch_threads  # noqa: F401 (autouse)

EPS = 1e-5
Y_TOL = dict(rtol=2e-4, atol=2e-4)
DX_TOL = dict(rtol=2e-3, atol=2e-4)
PARAM_TOL = dict(rtol=2e-3, atol=1e-3)
STATS_TOL = dict(rtol=2e-4, atol=2e-5)
SUM_TOL = 1e-6  # |sum error| / sum |terms|
ELEMENTWISE_TOL = dict(rtol=1e-6, atol=1e-6)
CHANNELS = [64, 128, 256]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pallas_bn, "INTERPRET", True)


def _inputs(c, shape=(2, 4, 4, 4), seed=None):
    """NCDHW x and gy, and (C,) scale and bias, as float32 numpy."""
    rng = np.random.default_rng(c if seed is None else seed)
    full = (shape[0], c) + shape[1:]
    x = (rng.normal(size=full) * 2 + 1).astype(np.float32)
    gy = rng.normal(size=full).astype(np.float32)
    scale = (rng.normal(size=c) * 0.5 + 1).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    return x, gy, scale, bias


def _last(a):
    """NC... -> (N, C) channels-last rows, as the JAX kernels take them."""
    a = np.moveaxis(np.asarray(a), 1, -1)
    return a.reshape(-1, a.shape[-1])


def _first(a2, like):
    """(N, C) rows -> the NC... layout of ``like``."""
    shape = (like.shape[0],) + like.shape[2:] + (like.shape[1],)
    return np.moveaxis(np.asarray(a2).reshape(shape), -1, 1)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _assert_sum_close(got, want, terms):
    """Per-channel sums equal up to reordering: error within SUM_TOL of the
    sum of the magnitudes of what was added."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= SUM_TOL * np.asarray(terms, np.float64) + 1e-30).all(), \
        err.max()


def _jax_stats(x2):
    n, c = x2.shape
    rows, lanes, fold = pallas_bn._pack_geometry(n, c)
    sums = pallas_bn._lane_stats(jnp.asarray(x2).reshape(rows, lanes), rows,
                                 lanes, fold, n)
    return (np.asarray(pallas_bn._fold_lanes(sums[0], c, fold)),
            np.asarray(pallas_bn._fold_lanes(sums[1], c, fold)))


@pytest.mark.parametrize("c", CHANNELS)
def test_stats_plain_matches_sum_kernel(c):
    """K4: per-channel [sum x; sum x^2]."""
    x, _, _, _ = _inputs(c)
    want_sum, want_sq = _jax_stats(_last(x))
    got = hopper_bn.bn_stats(_t(x)).numpy()
    assert got.shape == (2, c) and got.dtype == np.float32
    axes = (0, 2, 3, 4)
    _assert_sum_close(got[0], want_sum, np.abs(x).sum(axes))
    _assert_sum_close(got[1], want_sq, (x * x).sum(axes))


def _jax_forward(x2, scale, bias):
    y, mean, var = pallas_bn._bn_fwd_impl(jnp.asarray(x2), jnp.asarray(scale),
                                          jnp.asarray(bias), EPS)
    return np.asarray(y), np.asarray(mean), np.asarray(var)


@pytest.mark.parametrize("c", CHANNELS)
def test_apply_plain_matches_apply_kernel(c):
    """K5 on JAX's own statistics."""
    x, _, scale, bias = _inputs(c)
    y2, mean, var = _jax_forward(_last(x), scale, bias)
    inv = np.asarray(jax.lax.rsqrt(jnp.asarray(var) + EPS))
    got = hopper_bn.bn_apply(_t(x), _t(mean), _t(inv), _t(scale), _t(bias))
    np.testing.assert_allclose(got.numpy(), _first(y2, x), **ELEMENTWISE_TOL)


@pytest.mark.parametrize("c", CHANNELS)
def test_grad_sum_and_dx_plain_match_backward_kernels(c):
    """K6 and K7 on JAX's statistics: ``_bn_bwd`` returns K7's dx and K6's
    sums as (dscale, dbias)."""
    x, gy, scale, bias = _inputs(c)
    x2, g2 = _last(x), _last(gy)
    _, mean, var = _jax_forward(x2, scale, bias)
    dx2, dscale, dbias = pallas_bn._bn_bwd(
        EPS, (jnp.asarray(x2), jnp.asarray(scale), jnp.asarray(mean),
              jnp.asarray(var)), (jnp.asarray(g2), None, None))
    inv = np.asarray(jax.lax.rsqrt(jnp.asarray(var) + EPS))
    sums = hopper_bn.bn_grad_sum(_t(gy), _t(x), _t(mean), _t(inv)).numpy()
    xhat = (x - mean[:, None, None, None]) * inv[:, None, None, None]
    axes = (0, 2, 3, 4)
    _assert_sum_close(sums[0], dbias, np.abs(gy).sum(axes))
    _assert_sum_close(sums[1], dscale, np.abs(gy * xhat).sum(axes))

    n = x2.shape[0]
    red = np.stack([np.asarray(dbias) / np.float32(n),
                    np.asarray(dscale) / np.float32(n)]).astype(np.float32)
    got = hopper_bn.bn_dx(_t(gy), _t(x), _t(mean), _t(inv), _t(scale),
                          _t(red))
    np.testing.assert_allclose(got.numpy(), _first(dx2, x),
                               **ELEMENTWISE_TOL)


def _port_train(fn, x, gy, *params):
    """Run ``fn(x, *params)`` with autograd; returns its outputs and the
    gradients of sum(y * gy) for x and the params."""
    xt = _t(x).requires_grad_(True)
    pt = [_t(p).requires_grad_(True) for p in params]
    out = fn(xt, *pt)
    y = out[0] if isinstance(out, tuple) else out
    (y * _t(gy)).sum().backward()
    return out, xt.grad.numpy(), [p.grad.numpy() for p in pt]


@pytest.mark.parametrize("c", CHANNELS)
def test_batch_norm_train_forward_and_backward(c):
    """K4-K7 through ``batch_norm_train`` against the JAX custom VJP."""
    x, gy, scale, bias = _inputs(c)
    x2, g2 = _last(x), _last(gy)

    def f(x2_, s, b):
        y, mean, var = pallas_bn.batch_norm_train(x2_, s, b, EPS)
        return jnp.sum(y * g2), (y, mean, var)

    (_, (y2, mean, var)), (dx2, dscale, dbias) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x2), jnp.asarray(scale), jnp.asarray(bias))

    (y, got_mean, got_var), dx, (gscale, gbias) = _port_train(
        lambda xt, s, b: hopper_bn.batch_norm_train(xt, s, b, EPS),
        x, gy, scale, bias)
    np.testing.assert_allclose(y.detach().numpy(), _first(y2, x), **Y_TOL)
    np.testing.assert_allclose(got_mean.numpy(), mean, **STATS_TOL)
    np.testing.assert_allclose(got_var.numpy(), var, **STATS_TOL)
    assert not got_mean.requires_grad and not got_var.requires_grad
    np.testing.assert_allclose(dx, _first(dx2, x), **DX_TOL)
    np.testing.assert_allclose(gscale, dscale, **PARAM_TOL)
    np.testing.assert_allclose(gbias, dbias, **PARAM_TOL)


@pytest.mark.parametrize("c", CHANNELS)
def test_lane_packed_stats_forward_and_vjp(c):
    """K4 with the closed-form statistics VJP."""
    x, gy, _, _ = _inputs(c)
    rng = np.random.default_rng(c + 1)
    gmean = rng.normal(size=c).astype(np.float32)
    gvar = rng.normal(size=c).astype(np.float32)

    def f(x2_):
        mean, var = pallas_bn.lane_packed_stats(x2_)
        return jnp.sum(mean * gmean) + jnp.sum(var * gvar), (mean, var)

    (_, (mean, var)), dx2 = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(_last(x)))

    xt = _t(x).requires_grad_(True)
    got_mean, got_var = hopper_bn.lane_packed_stats(xt)
    ((got_mean * _t(gmean)).sum() + (got_var * _t(gvar)).sum()).backward()
    np.testing.assert_allclose(got_mean.detach().numpy(), mean, **STATS_TOL)
    np.testing.assert_allclose(got_var.detach().numpy(), var, **STATS_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), _first(dx2, x), **DX_TOL)


# ------------------------------------------------------------- modules --

JAX_MODULES = {
    "full": pallas_bn.FusedBatchNorm,
    "hybrid": pallas_bn.HybridBatchNorm,
    "flax": lambda **kw: flax_nn.BatchNorm(momentum=0.9, epsilon=EPS, **kw),
    "torch_stats": lambda **kw: jax_layers.TorchStatsBatchNorm(
        momentum=0.9, epsilon=EPS, **kw),
}
PORT_MODULES = {
    "full": layers.FusedBatchNorm,
    "hybrid": layers.HybridBatchNorm,
    "flax": layers.FlaxBatchNorm,
    "torch_stats": layers.TorchStatsBatchNorm,
}
# (kind, spatial shape): the head's BatchNorm1d sees (B, C) activations.
MODULE_CASES = [(k, (2, 4, 4, 4)) for k in JAX_MODULES] + [
    ("flax", (6,)), ("torch_stats", (6,))]


def _module_pair(kind, c, spatial, seed):
    """JAX module, its variables and the port module with the same
    non-trivial scale, bias and running statistics."""
    rng = np.random.default_rng(seed)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, c),
                    "bias": rng.normal(size=c) * 0.1},
         "batch_stats": {"mean": rng.uniform(-0.5, 0.5, c),
                         "var": rng.uniform(0.5, 1.5, c)}}
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), v)
    port = PORT_MODULES[kind](c)
    port.load_state_dict({
        "weight": _t(v["params"]["scale"]), "bias": _t(v["params"]["bias"]),
        "running_mean": _t(v["batch_stats"]["mean"]),
        "running_var": _t(v["batch_stats"]["var"])})
    return v, port


@pytest.mark.parametrize("kind,spatial", MODULE_CASES,
                         ids=[f"{k}-{len(s)}d" for k, s in MODULE_CASES])
def test_module_train_step_matches_jax(kind, spatial):
    """Train mode: output, gradients and the running statistics after one
    forward."""
    c = 64
    x, gy, _, _ = _inputs(c, spatial, seed=3)
    v, port = _module_pair(kind, c, spatial, seed=4)
    module = JAX_MODULES[kind](use_running_average=False)
    xl = np.moveaxis(x, 1, -1)
    gl = np.moveaxis(gy, 1, -1)

    def f(xl_, params):
        y, mutated = module.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, xl_,
            mutable=["batch_stats"])
        return jnp.sum(y * gl), (y, mutated["batch_stats"])

    (_, (yl, stats)), (dxl, dparams) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(xl), v["params"])

    port.train()
    xt = _t(x).requires_grad_(True)
    y = port(xt)
    (y * _t(gy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(),
                               np.moveaxis(np.asarray(yl), -1, 1), **Y_TOL)
    np.testing.assert_allclose(port.running_mean.numpy(), stats["mean"],
                               **STATS_TOL)
    np.testing.assert_allclose(port.running_var.numpy(), stats["var"],
                               **STATS_TOL)
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.moveaxis(np.asarray(dxl), -1, 1), **DX_TOL)
    np.testing.assert_allclose(port.weight.grad.numpy(), dparams["scale"],
                               **PARAM_TOL)
    np.testing.assert_allclose(port.bias.grad.numpy(), dparams["bias"],
                               **PARAM_TOL)


@pytest.mark.parametrize("kind", sorted(JAX_MODULES))
def test_module_eval_matches_jax(kind):
    """Eval mode normalises with the running statistics, which stay put."""
    c = 64
    x, _, _, _ = _inputs(c, seed=5)
    v, port = _module_pair(kind, c, (2, 4, 4, 4), seed=6)
    want = JAX_MODULES[kind](use_running_average=True).apply(
        v, jnp.asarray(np.moveaxis(x, 1, -1)))
    port.eval()
    with torch.no_grad():
        got = port(_t(x))
    np.testing.assert_allclose(got.numpy(),
                               np.moveaxis(np.asarray(want), -1, 1), **Y_TOL)
    np.testing.assert_array_equal(port.running_mean.numpy(),
                                  v["batch_stats"]["mean"])


def test_default_batch_norm_tracks_flax_statistics():
    """The factory's default is flax's BatchNorm: momentum 0.9 and the
    biased batch variance, not torch's momentum 0.1 and unbiased one."""
    c = 8
    x, _, _, _ = _inputs(c, (3, 5, 4, 2), seed=7)
    bn = layers.batch_norm(c)
    assert type(bn) is layers.FlaxBatchNorm
    bn.train()
    bn(_t(x))
    xl = jnp.asarray(np.moveaxis(x, 1, -1))
    module = flax_nn.BatchNorm(use_running_average=False, momentum=0.9,
                               epsilon=EPS)
    variables = module.init(jax.random.PRNGKey(0), xl)
    _, mutated = module.apply(variables, xl, mutable=["batch_stats"])
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               mutated["batch_stats"]["mean"], **STATS_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               mutated["batch_stats"]["var"], **STATS_TOL)
    unbiased = torch.nn.BatchNorm3d(c, eps=EPS).train()
    unbiased(_t(x))
    assert not np.allclose(bn.running_var.numpy(),
                           unbiased.running_var.numpy(), **STATS_TOL)


def test_torch_stats_batch_norm_is_torchs_ema():
    c = 8
    x, _, _, _ = _inputs(c, (3, 5, 4, 2), seed=8)
    ours = layers.TorchStatsBatchNorm(c).train()
    ref = torch.nn.BatchNorm3d(c, eps=EPS, momentum=0.1).train()
    for _ in range(3):
        y, want = ours(_t(x)), ref(_t(x))
    np.testing.assert_allclose(y.detach().numpy(), want.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours.running_var.numpy(),
                               ref.running_var.numpy(), rtol=1e-6)


@pytest.mark.parametrize("fused,kind", [
    (False, layers.FlaxBatchNorm), ("full", layers.FusedBatchNorm),
    (True, layers.FusedBatchNorm), ("hybrid", layers.HybridBatchNorm),
    ("torch_stats", layers.TorchStatsBatchNorm)])
def test_factory_picks_the_module(fused, kind):
    bn = layers.batch_norm(16, fused, device="meta")
    assert type(bn) is kind
    assert set(bn.state_dict()) == {"weight", "bias", "running_mean",
                                    "running_var"}


def test_factory_rejects_unknown_kinds():
    with pytest.raises(ValueError, match="fused_bn"):
        layers.batch_norm(16, "triton")


def test_plain_versions_leave_the_launch_counts_alone():
    x, gy, scale, bias = _inputs(64)
    before = dict(hopper_bn.LAUNCHES)
    _port_train(lambda xt, s, b: hopper_bn.batch_norm_train(xt, s, b, EPS),
                x, gy, scale, bias)
    assert hopper_bn.LAUNCHES == before


def test_wrappers_refuse_other_devices():
    x = torch.empty((2, 4, 3), device="meta")
    with pytest.raises(ValueError, match="device"):
        hopper_bn.bn_stats(x)
