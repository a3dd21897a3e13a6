"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
False. Run them on a machine with an H100 and the CUDA toolkit; there
``--noconftest`` skips tests/conftest.py, which sets up JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

Order statistics must be equal; the min-max apply within 1e-6 absolute
(both are exact by construction, so any difference is a fault). The
BatchNorm kernels: the elementwise ones (apply, dx) equal to their plain
versions given the same inputs; the per-channel sums within 1e-6 of the sum
of the magnitudes of what is added (the order of summation differs).
"""

import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.ops import hopper_bn, hopper_norm
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
        "minmax_apply": before["minmax_apply"] + 1}
    want = hopper_norm.minmax_apply_plain(vol, mask, qminmax[:, 0],
                                          qminmax[:, 1])
    assert (got - want).abs().max().item() <= 1e-6


def test_select_rejects_too_many_levels(device):
    vol, mask = _scans("normal", 1, (8, 8, 8), seed=5, device=device)
    with pytest.raises(ValueError, match="quantile levels"):
        hopper_norm.order_stats(vol, mask, tuple(np.linspace(0, 1, 9)))


# ---------------------------------------------------------- BatchNorm --

BN_SHAPES = {
    "stem": (8, 64, 46, 55, 46),    # ResNet-18 at 91x109x91, batch 8
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
