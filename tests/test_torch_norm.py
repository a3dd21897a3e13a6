"""The port's normalisation ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. On CPU
tensors the port's wrappers take their plain versions, which is what the
Hopper kernels are held against on the card (tests/test_torch_kernels_cuda.py).
"""

import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from multimodal_alzheimer_tpu.data.dataset import MultiModalDataset
from multimodal_alzheimer_tpu.ops import pallas_norm
from multimodal_alzheimer_tpu.ops import quantile as jax_quantile
from multimodal_alzheimer_tpu.ops import normalization as jax_norm
from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.ops import hopper_norm
from multimodal_alzheimer_tpu_torch.ops import normalization as port_norm
from multimodal_alzheimer_tpu_torch.ops import quantile as port_quantile
from torch_threads import torch_threads  # noqa: F401 (autouse)

SHAPE = (19, 23, 17)  # as tests/test_normalization.py


def _scans(seed, batch=3):
    rng = np.random.default_rng(seed)
    vol = (rng.normal(size=(batch,) + SHAPE) * 400 + 900).astype(np.float32)
    mask = (rng.random(vol.shape) > 0.4).astype(np.float32)
    return vol, mask


def _duplicates_and_negatives(seed, batch=2):
    """Integer-valued floats (heavy duplicates) with negatives, as
    tests/test_normalization.py's duplicates recipe."""
    rng = np.random.default_rng(seed)
    vol = np.round(rng.normal(size=(batch,) + SHAPE) * 4).astype(np.float32)
    return vol, np.ones_like(vol)


RECIPES = {"normal": lambda: _scans(12),
           "duplicates": lambda: _duplicates_and_negatives(15)}


def _sorted_oracle(vol, mask, qs):
    """numpy sorted[lo], sorted[min(lo+1, n-1)] with f32 rank arithmetic."""
    lo_hi = []
    for v, m in zip(vol, mask):
        vals = np.sort((v * m).ravel())
        vals = vals[vals != 0]
        n = vals.size
        los = [int(np.floor(np.float32(q) * np.float32(n - 1))) for q in qs]
        lo_hi.append(([vals[lo] for lo in los],
                      [vals[min(lo + 1, n - 1)] for lo in los]))
    lo = np.array([x[0] for x in lo_hi], np.float32)
    hi = np.array([x[1] for x in lo_hi], np.float32)
    return lo, hi


@pytest.mark.parametrize("recipe", sorted(RECIPES))
@pytest.mark.parametrize("qs", [(0.99, 0.01), (1.0, 0.0), (0.5,)])
def test_quantile_order_stats_bit_equal(recipe, qs):
    """Selected order statistics bit-equal to a sort oracle; quantiles
    within rtol 2e-7 of JAX's sort oracle and of the Pallas radix select in
    interpret mode (1-ulp FMA-contraction freedom in XLA's interpolation,
    tests/test_normalization.py)."""
    vol, mask = RECIPES[recipe]()
    want_lo, want_hi = _sorted_oracle(vol, mask, qs)

    n, v_lo, v_hi = hopper_norm.order_stats(torch.from_numpy(vol),
                                            torch.from_numpy(mask), qs)
    np.testing.assert_array_equal(n.numpy(), (vol * mask != 0).reshape(
        len(vol), -1).sum(1))
    np.testing.assert_array_equal(v_lo.numpy().view(np.int32),
                                  want_lo.view(np.int32))
    np.testing.assert_array_equal(v_hi.numpy().view(np.int32),
                                  want_hi.view(np.int32))

    got = hopper_norm.batched_masked_quantiles(
        torch.from_numpy(vol), torch.from_numpy(mask), qs).numpy()
    single = [port_quantile.masked_nonzero_quantile(
        torch.from_numpy(v), torch.from_numpy(m), qs) for v, m in
        zip(vol, mask)]
    np.testing.assert_array_equal(np.stack([s[0].numpy() for s in single]),
                                  got)
    np.testing.assert_array_equal(np.stack([s[1].numpy() for s in single]),
                                  want_lo)
    jax_sort = np.stack([np.asarray(jax_quantile.masked_nonzero_quantile(
        jnp.asarray(v), jnp.asarray(m), qs)) for v, m in zip(vol, mask)])
    np.testing.assert_allclose(got, jax_sort, rtol=2e-7, atol=0)
    pallas = pallas_norm.batched_masked_quantiles(
        jnp.asarray(vol), jnp.asarray(mask), qs, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-7, atol=0)


def test_per_scan_minmax_matches_pallas():
    """Select + apply against the Pallas pair in interpret mode; the
    tolerance covers the 1-ulp interpolation freedom."""
    vol, mask = _scans(16, batch=2)
    got = hopper_norm.per_scan_minmax(torch.from_numpy(vol),
                                      torch.from_numpy(mask), 0.99)
    want = pallas_norm.per_scan_minmax(jnp.asarray(vol), jnp.asarray(mask),
                                       0.99, interpret=True)
    assert got.shape == vol.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-9)


def test_minmax_apply_matches_pallas():
    vol, mask = _scans(9, batch=2)
    rng = np.random.default_rng(9)
    qmin = rng.uniform(100, 300, 2).astype(np.float32)
    qmax = rng.uniform(1500, 1800, 2).astype(np.float32)
    got = hopper_norm.minmax_apply(*map(torch.from_numpy,
                                        (vol, mask, qmin, qmax)))
    want = pallas_norm.minmax_apply(*map(jnp.asarray, (vol, mask, qmin, qmax)),
                                    interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_preprocess(cfg, quantile=0.99):
    holder = types.SimpleNamespace(normalize_pet=None, normalize_mri=cfg,
                                   quantile=quantile)
    return MultiModalDataset.get_device_preprocess(holder)


MODES = {
    "normalize": {"per_scan_norm": "normalize"},
    "min_max": {"per_scan_norm": "min_max"},
    "min_max_memoised": {"per_scan_norm": "min_max"},
    "all_scan_norm": {"all_scan_norm": {"mean": 426.9336, "std": 1018.783}},
    "none": None,
}


@pytest.mark.parametrize("half", [False, True], ids=["f32", "f16"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_batched_normalize_mri_matches_jax(mode, half):
    """The preprocess dispatch in every mode, with a scan that has no valid
    voxel (NaN in both packages for the per-scan modes)."""
    vol, mask = _scans(20)
    mask[1] = 0.0
    if half:
        vol = vol.astype(np.float16)
    batch = {"mri": vol, "mri_mask": mask}
    if mode == "min_max_memoised":
        rng = np.random.default_rng(21)
        batch["mri_qminmax"] = np.stack(
            [rng.uniform(100, 300, 3), rng.uniform(1500, 1800, 3)],
            axis=1).astype(np.float32)
    want = _jax_preprocess(MODES[mode])(
        {k: jnp.asarray(v) for k, v in batch.items()})
    launches = dict(hopper_norm.LAUNCHES)
    got = make_device_preprocess(normalize_mri=MODES[mode])(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want) == {"mri"}
    assert got["mri"].dtype == torch.float32
    # z-score reduces in another order than XLA; the rest is elementwise.
    tol = dict(rtol=2e-5, atol=2e-5) if mode == "normalize" else dict(
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["mri"].numpy(), np.asarray(want["mri"]),
                               **tol)
    assert hopper_norm.LAUNCHES == launches  # CPU tensors launch nothing


def test_single_scan_functions_match_jax():
    vol, mask = _scans(6, batch=1)
    v, m = vol[0], mask[0]
    tv, tm = torch.from_numpy(v), torch.from_numpy(m)
    jv, jm = jnp.asarray(v), jnp.asarray(m)
    np.testing.assert_allclose(
        port_norm.normalize_mri(tv, tm, {"per_scan_norm": "min_max"},
                                0.98).numpy(),
        np.asarray(jax_norm.normalize_mri(jv, jm,
                                          {"per_scan_norm": "min_max"},
                                          0.98)), rtol=1e-6, atol=1e-7)
    mean, std = port_quantile.masked_nonzero_mean_std(tv, tm)
    jmean, jstd = jax_quantile.masked_nonzero_mean_std(jv, jm)
    np.testing.assert_allclose([mean.item(), std.item()],
                               [float(jmean), float(jstd)], rtol=1e-5)
    np.testing.assert_allclose(
        port_norm.normalize_pet(tv, 0.5145, 0.5383).numpy(),
        np.asarray(jax_norm.normalize_pet(jv, 0.5145, 0.5383)), rtol=1e-6)


@pytest.mark.parametrize("cfg", [{"per_scan_norm": "bogus"}, {"bogus": 1}])
def test_dispatch_errors_match_jax(cfg):
    vol, mask = _scans(7, batch=2)
    with pytest.raises(ValueError) as jax_err:
        jax_norm.batched_normalize_mri(jnp.asarray(vol), jnp.asarray(mask),
                                       cfg)
    with pytest.raises(ValueError) as port_err:
        port_norm.batched_normalize_mri(torch.from_numpy(vol),
                                        torch.from_numpy(mask), cfg)
    assert str(port_err.value) == str(jax_err.value)


def test_wrappers_take_no_other_device():
    """Only CPU tensors take the plain versions; any device other than CUDA
    raises instead of computing somewhere else."""
    vol = torch.empty((2,) + SHAPE, device="meta")
    with pytest.raises(ValueError, match="meta"):
        hopper_norm.order_stats(vol, vol, (0.99, 0.01))
    with pytest.raises(ValueError, match="meta"):
        hopper_norm.minmax_apply(vol, vol, torch.zeros(2, device="meta"),
                                 torch.ones(2, device="meta"))
