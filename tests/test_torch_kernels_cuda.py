"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
False. Run them on a machine with an H100 and the CUDA toolkit; there
``--noconftest`` skips tests/conftest.py, which sets up JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

Order statistics must be equal; the min-max apply within 1e-6 absolute
(both are exact by construction, so any difference is a fault). The z-score
within 1e-5 * (1 + |plain|) with NaN where the plain version has NaN (the
kernel's statistics are summed in double in another order). The
BatchNorm kernels: the elementwise ones (apply, dx) equal to their plain
versions given the same inputs; the per-channel sums within 1e-6 of the sum
of the magnitudes of what is added (the order of summation differs). The
max-pool backward (K8) equal to its plain version, bit for bit, in float32
and bfloat16: both add in the same order with one rounding per add. The
one-launch reductions (K4, K6) and K8 allocate their output and nothing
else; K4 and K6 give the same bits on every call.
"""

import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.ops import (
    hopper_bn,
    hopper_maxpool,
    hopper_norm,
)
from multimodal_alzheimer_tpu_torch.ops.maxpool import (
    max_pool3d_backward_plain,
    pool_forward,
)
from multimodal_alzheimer_tpu_torch.ops.quantile import interpolate

pytestmark = pytest.mark.cuda

GRID = (91, 109, 91)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _scans(kind, batch, shape, seed, device):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        vol = rng.normal(900, 400, (batch,) + shape)
        mask = rng.random((batch,) + shape) > 0.35
    else:  # integer-valued duplicates with negatives, full mask
        vol = np.round(rng.normal(size=(batch,) + shape) * 4)
        mask = np.ones_like(vol)
    return (torch.tensor(vol, dtype=torch.float32, device=device),
            torch.tensor(mask, dtype=torch.float32, device=device))


def _plain_stats(vol, mask, qs):
    b = vol.shape[0]
    qs_t = torch.tensor(qs, dtype=torch.float32, device=vol.device)
    return hopper_norm.order_stats_plain(vol.reshape(b, -1),
                                         mask.reshape(b, -1), qs_t)


@pytest.mark.parametrize("shape", [GRID, (19, 23, 17)])
@pytest.mark.parametrize("kind", ["normal", "duplicates"])
@pytest.mark.parametrize("qs", [(0.99, 0.01), (1.0, 0.0), (0.5,)])
def test_select_equals_plain(device, shape, kind, qs):
    vol, mask = _scans(kind, 3, shape, seed=1, device=device)
    before = hopper_norm.LAUNCHES["minmax_select"]
    n, lo, hi = hopper_norm.order_stats(vol, mask, qs)
    torch.cuda.synchronize()
    assert hopper_norm.LAUNCHES["minmax_select"] == before + 1
    n_p, lo_p, hi_p = _plain_stats(vol, mask, qs)
    assert torch.equal(n, n_p)
    assert torch.equal(lo, lo_p) and torch.equal(hi, hi_p)


def test_select_survives_a_scan_with_no_valid_voxel(device):
    vol, mask = _scans("normal", 4, GRID, seed=2, device=device)
    mask[2] = 0.0
    n, lo, hi = hopper_norm.order_stats(vol, mask, (0.99, 0.01))
    torch.cuda.synchronize()
    n_p, lo_p, hi_p = _plain_stats(vol, mask, (0.99, 0.01))
    assert int(n[2]) == 0
    keep = torch.tensor([0, 1, 3], device=device)
    assert torch.equal(lo[keep], lo_p[keep]) and torch.equal(hi[keep],
                                                              hi_p[keep])


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
def test_apply_matches_plain(device, offset):
    """offset 1 starts the operands one float past a 16-byte boundary, so
    the kernel takes its scalar path."""
    vol, mask = _scans("normal", 3 + offset, GRID, seed=3, device=device)
    vol, mask = vol[offset:], mask[offset:]
    qmin = torch.tensor([200.0, 150.0, 300.0], device=device)
    qmax = torch.tensor([1700.0, 1650.0, 1600.0], device=device)
    got = hopper_norm.minmax_apply(vol, mask, qmin, qmax)
    want = hopper_norm.minmax_apply_plain(vol, mask, qmin, qmax)
    torch.cuda.synchronize()
    assert got.shape == vol.shape
    assert (got - want).abs().max().item() <= 1e-6


def test_per_scan_minmax_matches_plain(device):
    vol, mask = _scans("normal", 2, GRID, seed=4, device=device)
    got = hopper_norm.per_scan_minmax(vol, mask, 0.99)
    qs = (0.99, 1.0 - 0.99)
    q = interpolate(*_plain_stats(vol, mask, qs),
                    torch.tensor(qs, dtype=torch.float32, device=device))
    want = hopper_norm.minmax_apply_plain(vol, mask, q[:, 1], q[:, 0])
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-6


def test_memoised_bounds_launch_the_apply_kernel_alone(device):
    """With ``mri_qminmax`` the preprocess skips the select and runs the
    apply kernel."""
    vol, mask = _scans("normal", 2, GRID, seed=6, device=device)
    qminmax = torch.tensor([[200.0, 1700.0], [150.0, 1650.0]], device=device)
    before = dict(hopper_norm.LAUNCHES)
    got = make_device_preprocess(normalize_mri={"per_scan_norm": "min_max"})(
        {"mri": vol, "mri_mask": mask, "mri_qminmax": qminmax})["mri"]
    torch.cuda.synchronize()
    assert hopper_norm.LAUNCHES == {
        "minmax_select": before["minmax_select"],
        "minmax_apply": before["minmax_apply"] + 1,
        "zscore": before["zscore"]}
    want = hopper_norm.minmax_apply_plain(vol, mask, qminmax[:, 0],
                                          qminmax[:, 1])
    assert (got - want).abs().max().item() <= 1e-6


def test_select_rejects_too_many_levels(device):
    vol, mask = _scans("normal", 1, (8, 8, 8), seed=5, device=device)
    with pytest.raises(ValueError, match="quantile levels"):
        hopper_norm.order_stats(vol, mask, tuple(np.linspace(0, 1, 9)))


# ------------------------------------------------------------ z-score --

ZSCORE_TOL = 1e-5


def _check_zscore(got, want):
    """|got - want| <= 1e-5 * (1 + |want|), NaN exactly where want is."""
    assert got.shape == want.shape and got.dtype == torch.float32
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    ok = ~nan
    assert torch.equal(torch.isinf(got[ok]), torch.isinf(want[ok]))
    fin = ok & torch.isfinite(want)
    err = (got[fin] - want[fin]).abs()
    assert bool((err <= ZSCORE_TOL * (1 + want[fin].abs())).all()), \
        float(err.max())


def _zscore_plain(vol, mask):
    b = vol.shape[0]
    return hopper_norm.zscore_plain(vol.reshape(b, -1).float(),
                                    mask.reshape(b, -1).float()
                                    ).reshape(vol.shape)


@pytest.mark.parametrize("shape", [GRID, (19, 23, 17), (7, 5, 3)],
                         ids=["flagship", "odd", "tiny"])
@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("std", [400.0, 40.0])
def test_zscore_matches_plain(device, shape, batch, std):
    """N = 902629, 7429 and 105: all odd, so every row past the first
    starts off a 16-byte boundary; std 40 about a mean of 900 is the case an
    f32 sum of squares does not survive."""
    rng = np.random.default_rng(11)
    vol = torch.tensor(rng.normal(900, std, (batch,) + shape),
                       dtype=torch.float32, device=device)
    mask = torch.tensor(rng.random((batch,) + shape) > 0.35,
                        dtype=torch.float32, device=device)
    before = hopper_norm.LAUNCHES["zscore"]
    got = hopper_norm.per_scan_zscore(vol, mask)
    torch.cuda.synchronize()
    assert hopper_norm.LAUNCHES["zscore"] == before + 1
    _check_zscore(got, _zscore_plain(vol, mask))


def test_zscore_degenerate_scans(device):
    """A scan with no valid voxel is NaN throughout, one with a single
    valid voxel has std 0 (inf and NaN where the plain version has them);
    the other scans are unaffected."""
    vol, mask = _scans("normal", 4, GRID, seed=7, device=device)
    mask[1] = 0.0
    mask[2] = 0.0
    mask[2].view(-1)[12345] = 1.0
    got = hopper_norm.per_scan_zscore(vol, mask)
    want = _zscore_plain(vol, mask)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[1]).all())
    assert not bool(torch.isfinite(got[2]).any())
    assert bool(torch.isfinite(got[[0, 3]]).all())
    _check_zscore(got, want)


def test_zscore_on_a_misaligned_view(device):
    """Operands one float past a 16-byte boundary take the scalar path."""
    vol, mask = _scans("normal", 4, (19, 23, 17), seed=8, device=device)
    flat_v = torch.cat([torch.zeros(1, device=device), vol.reshape(-1)])
    flat_m = torch.cat([torch.zeros(1, device=device), mask.reshape(-1)])
    vol, mask = flat_v[1:].view(vol.shape), flat_m[1:].view(mask.shape)
    assert vol.data_ptr() % 16 == 4
    _check_zscore(hopper_norm.per_scan_zscore(vol, mask),
                  _zscore_plain(vol, mask))


def test_zscore_casts_other_dtypes_as_the_plain_path(device):
    """A float16 volume is cast to float32 before the kernel, exactly as
    the plain path casts it: the result equals the kernel on the cast."""
    vol, mask = _scans("normal", 2, (19, 23, 17), seed=9, device=device)
    half = vol.half()
    got = hopper_norm.per_scan_zscore(half, mask)
    assert got.dtype == torch.float32
    assert torch.equal(got, hopper_norm.per_scan_zscore(half.float(), mask))
    _check_zscore(got, _zscore_plain(half.float(), mask))


def test_normalize_preprocess_launches_the_zscore_kernel(device):
    """``{"per_scan_norm": "normalize"}`` runs the z-score kernel once for
    the batch, also when the mask is absent (all ones)."""
    vol, mask = _scans("normal", 3, (19, 23, 17), seed=10, device=device)
    pre = make_device_preprocess(normalize_mri={"per_scan_norm": "normalize"})
    for batch, m in (({"mri": vol, "mri_mask": mask}, mask),
                     ({"mri": vol}, torch.ones_like(vol))):
        before = dict(hopper_norm.LAUNCHES)
        got = pre(batch)["mri"]
        torch.cuda.synchronize()
        assert hopper_norm.LAUNCHES == dict(before,
                                            zscore=before["zscore"] + 1)
        _check_zscore(got, _zscore_plain(vol, m))


# ---------------------------------------------------------- BatchNorm --

BN_SHAPES = {
    "stem": (8, 64, 46, 55, 46),    # ResNet-18 at 91x109x91, batch 8
    "layer1": (8, 64, 23, 28, 23),
    "layer2": (8, 128, 12, 14, 12),
    "layer3": (8, 256, 12, 14, 12),
    "layer4": (8, 512, 12, 14, 12),
    "odd": (3, 5, 7, 9, 11),        # S = 693: the scalar path
    "dense": (6, 16),               # (B, C): S = 1
}
SUM_TOL = 1e-6


def _bn_operands(shape, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=gen, device=device) * 2 + 0.5
    g = torch.randn(shape, generator=gen, device=device)
    scale = torch.rand(c, generator=gen, device=device) + 0.5
    bias = torch.randn(c, generator=gen, device=device)
    return x, g, scale, bias


def _rows(t):
    return t.reshape(t.shape[0], t.shape[1], -1)


def _check_sums(got, want, terms):
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= SUM_TOL * terms).all()), \
        float((got - want).abs().max())


@pytest.mark.parametrize("name", sorted(BN_SHAPES))
def test_bn_kernels_match_plain(device, name):
    x, g, scale, bias = _bn_operands(BN_SHAPES[name], device)
    x3, g3 = _rows(x), _rows(g)
    before = dict(hopper_bn.LAUNCHES)
    sums = hopper_bn.bn_stats(x)
    _check_sums(sums, hopper_bn.bn_stats_plain(x3),
                torch.stack([x3.abs().sum((0, 2)), (x3 * x3).sum((0, 2))]))
    n = x.numel() // x.shape[1]
    mean = sums[0] / n
    inv = torch.rsqrt(sums[1] / n - mean * mean + 1e-5)
    y = hopper_bn.bn_apply(x, mean, inv, scale, bias)
    assert torch.equal(y, hopper_bn.bn_apply_plain(x3, mean, inv, scale,
                                                   bias).reshape(x.shape))
    red_sums = hopper_bn.bn_grad_sum(g, x, mean, inv)
    xhat = (x3 - mean[None, :, None]) * inv[None, :, None]
    _check_sums(red_sums, hopper_bn.bn_grad_sum_plain(g3, x3, mean, inv),
                torch.stack([g3.abs().sum((0, 2)),
                             (g3 * xhat).abs().sum((0, 2))]))
    red = red_sums / n
    dx = hopper_bn.bn_dx(g, x, mean, inv, scale, red)
    assert torch.equal(dx, hopper_bn.bn_dx_plain(g3, x3, mean, inv, scale,
                                                 red).reshape(x.shape))
    torch.cuda.synchronize()
    assert {k: hopper_bn.LAUNCHES[k] - before[k] for k in before} == \
        dict.fromkeys(before, 1)


@pytest.mark.parametrize("name", ["stem", "layer2", "layer4"])
def test_bn_sums_are_repeatable(device, name):
    """The one-launch reductions add in an order fixed by the code (no float
    atomics): two calls on the same inputs give the same bits. Clusters of
    8, 4 and 1 blocks per channel at these shapes."""
    x, g, _, _ = _bn_operands(BN_SHAPES[name], device, seed=4)
    mean = x.mean(dim=(0, 2, 3, 4))
    inv = torch.rsqrt(x.var(dim=(0, 2, 3, 4), unbiased=False) + 1e-5)
    first = (hopper_bn.bn_stats(x), hopper_bn.bn_grad_sum(g, x, mean, inv))
    second = (hopper_bn.bn_stats(x), hopper_bn.bn_grad_sum(g, x, mean, inv))
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def _allocations(fn):
    """The result of ``fn`` and the number of blocks it allocated on the
    card."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = fn()
    return out, torch.cuda.memory_stats()["allocation.all.allocated"] - before


def test_bn_reductions_launch_once_without_a_workspace(device):
    """K4 and K6 allocate their (2, C) output and nothing else, and launch
    one kernel."""
    x, g, _, _ = _bn_operands(BN_SHAPES["layer2"], device, seed=5)
    c = torch.ones(x.shape[1], device=device)
    x3 = x.reshape(x.shape[0], x.shape[1], -1)  # a view: no allocation
    for name, call in (("bn_stats", lambda: hopper_bn.bn_stats(x3)),
                       ("bn_grad_sum",
                        lambda: hopper_bn.bn_grad_sum(g, x3, c, c))):
        before = hopper_bn.LAUNCHES[name]
        sums, allocated = _allocations(call)
        assert sums.shape == (2, x.shape[1]) and allocated == 1, name
        assert hopper_bn.LAUNCHES[name] == before + 1


def test_bn_reduction_error_raises(device):
    """A shape the C entry point refuses (65536 channels: one cluster per
    channel on the grid's second axis) comes back as a CUDA error, and the
    wrapper raises; nothing falls back to another path."""
    x = torch.ones(1, 65536, device=device)
    before = dict(hopper_bn.LAUNCHES)
    with pytest.raises(RuntimeError, match="bn_stats: CUDA error"):
        hopper_bn.bn_stats(x)
    with pytest.raises(RuntimeError, match="bn_grad_sum: CUDA error"):
        hopper_bn.bn_grad_sum(x, x, x[0], x[0])
    assert hopper_bn.LAUNCHES == before


def test_bn_kernels_on_a_misaligned_view(device):
    """Operands one float past a 16-byte boundary take the scalar path."""
    shape = (8, 64, 6, 6, 6)
    n = 8 * 64 * 216
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(n + 1, generator=gen, device=device)[1:].view(shape)
    g = torch.randn(n + 1, generator=gen, device=device)[1:].view(shape)
    c = torch.rand(64, generator=gen, device=device) + 0.5
    x3, g3 = _rows(x), _rows(g)
    _check_sums(hopper_bn.bn_stats(x), hopper_bn.bn_stats_plain(x3),
                torch.stack([x3.abs().sum((0, 2)), (x3 * x3).sum((0, 2))]))
    assert torch.equal(hopper_bn.bn_apply(x, c, c, c, c),
                       hopper_bn.bn_apply_plain(x3, c, c, c, c).reshape(shape))
    red = torch.stack([c, c]) * 1e-3
    assert torch.equal(hopper_bn.bn_dx(g, x, c, c, c, red),
                       hopper_bn.bn_dx_plain(g3, x3, c, c, c,
                                             red).reshape(shape))


@pytest.mark.parametrize("name", ["stem", "layer4"])
def test_batch_norm_train_matches_torch(device, name):
    """Forward and backward against F.batch_norm(training=True) and
    autograd: y, dx within rtol 1e-4, atol 1e-5; dscale and dbias, sums of
    n = 16,128 to 931,040 terms of order 1, within rtol 1e-4, atol 1e-6 n."""
    x, g, scale, bias = _bn_operands(BN_SHAPES[name], device, seed=2)
    outs = []
    for fused in (True, False):
        xi = x.clone().requires_grad_(True)
        s = scale.clone().requires_grad_(True)
        b = bias.clone().requires_grad_(True)
        if fused:
            y, mean, var = hopper_bn.batch_norm_train(xi, s, b, 1e-5)
        else:
            y = torch.nn.functional.batch_norm(xi, None, None, s, b,
                                               training=True, eps=1e-5)
        y.backward(g)
        outs.append((y.detach(), xi.grad, s.grad, b.grad))
    torch.cuda.synchronize()
    n = x.numel() // x.shape[1]
    for i, (got, want) in enumerate(zip(outs[0], outs[1])):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-5 if i < 2 else 1e-6 * n)


def test_bn_kernels_refuse_what_they_do_not_take(device):
    x = torch.randn(2, 4, 27, device=device)
    with pytest.raises(TypeError, match="float32"):
        hopper_bn.bn_stats(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        hopper_bn.bn_stats(torch.randn(4, 2, 27, device=device).transpose(0, 1))
    c = torch.ones(4, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        hopper_bn.bn_apply(x, c, torch.ones(8, device=device)[::2], c, c)
    with pytest.raises(ValueError, match="operands on"):
        hopper_bn.bn_apply(x, c, c, c, c.cpu())


def test_bn_precision_tool_against_float64(device):
    """tools/bn_precision.py on random operands: the kernels' variance and
    backward within 1e-5 of float64, as cuDNN's."""
    from multimodal_alzheimer_tpu_torch.tools.bn_precision import (
        layer_precision,
    )

    x, g, scale, _ = _bn_operands((4, 16, 10, 10, 10), device, seed=3)
    r = layer_precision(x, g, scale)
    for key in ("var", "dscale", "dbias", "dx"):
        assert r[key]["kernel"] < 1e-5 and r[key]["cudnn"] < 1e-5, (key, r)


# The JAX tests' odd and even grids (tests/test_pallas_maxpool.py:35-40) as
# NCDHW, and the ResNet-18 stem at 91x109x91, batch 8.
POOL_SHAPES = [(2, 4, 9, 11, 9), (1, 3, 8, 8, 8), (2, 8, 12, 10, 14),
               (1, 2, 5, 7, 5), (8, 64, 46, 55, 46)]


def _pool_operands(shape, kind, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device)
    if kind == "relu_ties":
        x = torch.relu(x - 0.8)
    elif kind == "neg_inf_border":
        x[:, :, 0] = float("-inf")
        x[:, :, :, :3] = float("-inf")
    x = x.to(dtype)
    y = pool_forward(x)
    g = torch.randn(y.shape, generator=gen, device=device).to(dtype)
    return x, y, g


@pytest.mark.parametrize("kind", ["normal", "relu_ties", "neg_inf_border"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("shape", POOL_SHAPES, ids=str)
def test_maxpool_backward_equals_plain(device, shape, dtype, kind):
    x, y, g = _pool_operands(shape, kind, dtype, device, seed=1)
    before = hopper_maxpool.LAUNCHES["maxpool_bwd"]
    got = hopper_maxpool.max_pool3d_backward(x, y, g)
    torch.cuda.synchronize()
    assert hopper_maxpool.LAUNCHES["maxpool_bwd"] == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, max_pool3d_backward_plain(x, y, g))


def _slab(shape, dtype):
    from multimodal_alzheimer_tpu_torch.ops import _native

    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    return _native.library().maxpool_bwd_slab(*shape[2:], code)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_maxpool_backward_ragged_last_slab(device, dtype):
    """A D whose output slices do not fill the kernel's last slab: 32 x 32
    slices take slabs of 6 (float32) or 8 (bfloat16) output slices, and
    D = 29 gives 15 of them."""
    shape = (2, 3, 29, 32, 32)
    td, d_out = _slab(shape, dtype), (shape[2] - 1) // 2 + 1
    assert 1 < td < d_out and d_out % td != 0, td
    x, y, g = _pool_operands(shape, "relu_ties", dtype, device, seed=4)
    got = hopper_maxpool.max_pool3d_backward(x, y, g)
    torch.cuda.synchronize()
    assert torch.equal(got, max_pool3d_backward_plain(x, y, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_maxpool_backward_off_a_16_byte_boundary(device, dtype):
    """Operands one element past a 16-byte boundary: the kernel copies and
    stores the partial 16-byte chunks at either end of each range element by
    element, and its result is the plain version's, bit for bit."""
    shape = (8, 64, 46, 55, 46)
    x, y, g = _pool_operands(shape, "relu_ties", dtype, device, seed=5)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    xs, ys, gs = shifted(x), shifted(y), shifted(g)
    assert all(t.data_ptr() % 16 != 0 for t in (xs, ys, gs))
    got = hopper_maxpool.max_pool3d_backward(xs, ys, gs)
    torch.cuda.synchronize()
    assert torch.equal(got, max_pool3d_backward_plain(x, y, g))


def test_maxpool_backward_launches_once_without_a_workspace(device):
    x, y, g = _pool_operands((8, 64, 46, 55, 46), "relu_ties",
                             torch.float32, device, seed=6)
    before = hopper_maxpool.LAUNCHES["maxpool_bwd"]
    dx, allocated = _allocations(
        lambda: hopper_maxpool.max_pool3d_backward(x, y, g))
    assert allocated == 1 and dx.shape == x.shape  # dx alone
    assert hopper_maxpool.LAUNCHES["maxpool_bwd"] == before + 1


def test_maxpool_autograd_function_launches_once(device):
    x, _, g = _pool_operands((2, 8, 12, 10, 14), "relu_ties",
                             torch.float32, device, seed=2)
    x.requires_grad_(True)
    before = hopper_maxpool.LAUNCHES["maxpool_bwd"]
    y = hopper_maxpool.max_pool3d_pl(x)
    torch.testing.assert_close(y, pool_forward(x.detach()), rtol=0, atol=0)
    y.backward(g)
    torch.cuda.synchronize()
    assert hopper_maxpool.LAUNCHES["maxpool_bwd"] == before + 1
    assert torch.equal(x.grad, max_pool3d_backward_plain(x.detach(),
                                                         y.detach(), g))


def test_maxpool_backward_refuses_what_it_does_not_take(device):
    x, y, g = _pool_operands((2, 4, 9, 11, 9), "normal", torch.float32,
                             device, seed=3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        hopper_maxpool.max_pool3d_backward(x.double(), y.double(),
                                           g.double())
    with pytest.raises(ValueError, match="contiguous"):
        hopper_maxpool.max_pool3d_backward(
            x.transpose(0, 1).contiguous().transpose(0, 1), y, g)
    with pytest.raises(ValueError, match="pool of x"):
        hopper_maxpool.max_pool3d_backward(x, y[..., :-1].contiguous(), g)
    with pytest.raises(TypeError, match="operands of"):
        hopper_maxpool.max_pool3d_backward(x, y, g.to(torch.bfloat16))
    # Slices of 200 x 200 float32: a slab of one output slice needs more
    # shared memory than a block has.
    big = torch.zeros(1, 1, 3, 200, 200, device=device)
    assert _slab(big.shape, torch.float32) == 0
    before = hopper_maxpool.LAUNCHES["maxpool_bwd"]
    with pytest.raises(ValueError, match="does not fit"):
        hopper_maxpool.max_pool3d_backward(big, pool_forward(big),
                                           pool_forward(big))
    assert hopper_maxpool.LAUNCHES["maxpool_bwd"] == before

