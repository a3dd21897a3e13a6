"""The port's per-scan z-score (the plain version of K3) against the JAX
package, on the CPU.

On CPU tensors ``hopper_norm.per_scan_zscore`` runs its plain version, the
batched two-pass function the card's kernel is held to
(tests/test_torch_kernels_cuda.py). Here it is held to JAX's
``jax.vmap(mri_per_scan_zscore)``, the function of the JAX package's
z-score path, within rtol 2e-5 and atol 2e-5 (both reduce in f32, in other
orders), and to the Pallas kernel ``pallas_norm.per_scan_zscore`` in
interpret mode within JAX's own tolerance for it, rtol 2e-3 and atol 2e-4
(tests/test_normalization.py): the Pallas body sums x^2 unshifted in f32.
NaN must sit where JAX has NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.ops import normalization as jax_norm
from multimodal_alzheimer_tpu.ops import pallas_norm
from multimodal_alzheimer_tpu_torch.ops import hopper_norm
from multimodal_alzheimer_tpu_torch.ops import normalization as port_norm
from torch_threads import torch_threads  # noqa: F401 (autouse)

SHAPE = (12, 14, 12)
XLA_TOL = dict(rtol=2e-5, atol=2e-5)
PALLAS_TOL = dict(rtol=2e-3, atol=2e-4)


def _scans(std, batch=4, seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    vol = rng.normal(900, std, (batch,) + shape).astype(np.float32)
    mask = (rng.random(vol.shape) > 0.35).astype(np.float32)
    return vol, mask


def _degenerate(vol, mask):
    """Scan 1 without a valid voxel, scan 2 with one."""
    mask = mask.copy()
    mask[1] = 0.0
    mask[2] = 0.0
    mask[2].reshape(-1)[100] = 1.0
    return vol, mask


CASES = {
    "N(900,400)": lambda: _scans(400.0),
    "N(900,40)": lambda: _scans(40.0, seed=1),
    "degenerate": lambda: _degenerate(*_scans(400.0, seed=2)),
}


def _port(vol, mask):
    got = hopper_norm.per_scan_zscore(torch.from_numpy(vol),
                                      torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == vol.shape
    return got.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_zscore_matches_the_xla_path(case):
    vol, mask = CASES[case]()
    want = np.asarray(jax.vmap(jax_norm.mri_per_scan_zscore)(
        jnp.asarray(vol), jnp.asarray(mask)))
    np.testing.assert_allclose(_port(vol, mask), want, equal_nan=True,
                               **XLA_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_zscore_matches_the_pallas_kernel(case):
    vol, mask = CASES[case]()
    want = np.asarray(pallas_norm.per_scan_zscore(
        jnp.asarray(vol), jnp.asarray(mask), interpret=True))
    np.testing.assert_allclose(_port(vol, mask), want, equal_nan=True,
                               **PALLAS_TOL)


def test_degenerate_scans_are_nan_where_jax_has_nan():
    vol, mask = CASES["degenerate"]()
    got = _port(vol, mask)
    assert np.isnan(got[1]).all()
    assert not np.isfinite(got[2]).any()
    assert np.isfinite(got[[0, 3]]).all()


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("std", [400.0, 40.0])
def test_batched_normalize_mri_zscore_matches_jax(with_mask, std):
    """The preprocess dispatch's "normalize" branch, the whole batch at
    once; no mask means all ones in both packages."""
    vol, mask = _scans(std, seed=3)
    cfg = {"per_scan_norm": "normalize"}
    got = port_norm.batched_normalize_mri(
        torch.from_numpy(vol), torch.from_numpy(mask) if with_mask else None,
        cfg)
    want = jax_norm.batched_normalize_mri(
        jnp.asarray(vol), jnp.asarray(mask) if with_mask else None, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **XLA_TOL)


def test_zscore_plain_is_the_single_scan_function_batched():
    """The batched plain version computes, scan by scan, what the port's
    single-scan ``mri_per_scan_zscore`` does."""
    vol, mask = _scans(400.0, batch=3, seed=4)
    got = _port(vol, mask)
    for b in range(3):
        one = port_norm.mri_per_scan_zscore(torch.from_numpy(vol[b]),
                                            torch.from_numpy(mask[b]))
        np.testing.assert_allclose(got[b], one.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_zscore_casts_half_volumes_to_float32():
    vol, mask = _scans(400.0, batch=2, seed=5)
    half = vol.astype(np.float16)
    got = hopper_norm.per_scan_zscore(torch.from_numpy(half),
                                      torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(),
                                  _port(half.astype(np.float32), mask))


def test_zscore_takes_no_other_device():
    vol = torch.empty((2,) + SHAPE, device="meta")
    with pytest.raises(ValueError, match="meta"):
        hopper_norm.per_scan_zscore(vol, vol)


# K3 (csrc/zscore_norm.cu, zscore_kernel) walked in numpy: one cluster of
# 16 blocks per scan, each block's stretch, its partial, the merge over the
# cluster in rank order, the apply over each stretch.
CLUSTER_BLOCKS = 16


def _walk_cluster(vol, mask):
    b, n = vol.shape[0], vol[0].size
    per = (-(-n // CLUSTER_BLOCKS) + 3) // 4 * 4
    vols, masks = vol.reshape(b, n), mask.reshape(b, n)
    out = np.empty((b, n), np.float32)
    for s in range(b):
        vals = (vols[s] * masks[s]).astype(np.float64)
        stretches = [(min(r * per, n), min(min(r * per, n) + per, n))
                     for r in range(CLUSTER_BLOCKS)]
        assert sum(hi - lo for lo, hi in stretches) == n  # each voxel once
        parts = []
        for lo, hi in stretches:
            x = vals[lo:hi]
            ok = x != 0
            parts.append((ok.sum(), x[ok].sum(), (x[ok] ** 2).sum()))
        c = a = q = 0.0
        for pc, pa, pq in parts:  # rank order
            c, a, q = c + pc, a + pa, q + pq
        mean = a / c if c else np.nan
        var = max((q - a * mean) / max(c - 1.0, 1.0), 0.0)
        for lo, hi in stretches:
            out[s, lo:hi] = ((vols[s, lo:hi] - np.float32(mean))
                             / np.float32(np.sqrt(var)) * masks[s, lo:hi])
    return out.reshape(vol.shape)


@pytest.mark.parametrize("batch,shape", [(1, (2, 3, 5)), (3, (7, 5, 3)),
                                         (4, SHAPE), (2, (31, 29, 23))])
def test_cluster_walk_matches_plain(batch, shape):
    """N from 30 (most blocks get no voxel) to 20677."""
    vol, mask = _scans(400.0, batch=batch, seed=batch, shape=shape)
    if batch > 2:
        mask[1] = 0.0
    got = _walk_cluster(vol, mask)
    want = hopper_norm.zscore_plain(
        torch.from_numpy(vol.reshape(batch, -1)),
        torch.from_numpy(mask.reshape(batch, -1))).numpy().reshape(vol.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-5)
