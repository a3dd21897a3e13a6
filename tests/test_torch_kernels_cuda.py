"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
False. Run them on a machine with an H100 and the CUDA toolkit; there
``--noconftest`` skips tests/conftest.py, which sets up JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

Order statistics must be equal; the apply within 1e-6 absolute (both are
exact by construction, so any difference is a fault).
"""

import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.ops import hopper_norm
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
