"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
False. Run them on a machine with an H100 and the CUDA toolkit; there
``--noconftest`` skips tests/conftest.py, which sets up JAX:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

Order statistics must be equal, bit for bit (NaN included); the min-max
apply within 1e-6 absolute (both are exact by construction, so any
difference is a fault). The select (K1) and the z-score (K3) at 91x109x91
are one launch with no workspace, and enqueue without waiting for the card. The z-score
within 1e-5 * (1 + |plain|) with NaN where the plain version has NaN (the
kernel's statistics are summed in double in another order). The
BatchNorm kernels: the elementwise ones (apply, dx) equal to their plain
versions given the same inputs; the per-channel sums within 1e-6 of the sum
of the magnitudes of what is added (the order of summation differs). The
max-pool backward (K8) equal to its plain version, bit for bit, in float32
and bfloat16: both add in the same order with one rounding per add. The
BatchNorm kernels take bfloat16 activations too, held to their plain
versions (float32 arithmetic, one rounding) the same way. The one-launch
reductions (K4, K6) and K8 allocate their output and nothing else; K4 and
K6 give the same bits on every call. The stage-3 and early-fusion train
steps launch the kernels their paths reach, as many times as chip_smoke.py
expects at full width. K10, the PET towers' narrow convolutions: each
direction against the float64 result of its bfloat16 operands and against
cuDNN, its weight gradient's bits on two calls, its allocations, and the
launches of a bfloat16 stage-3 step (none in the flagship's).
"""

import copy
import time

import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.data.synthetic import make_labeled_volumes
from multimodal_alzheimer_tpu_torch.losses.classification import (
    make_criterion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.all_modalities_fusion import (
    AllModalitiesFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.anat_pet_fusion import (
    AnatPETFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.early_fusion import (
    PETMRIEarlyFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.pet_tabular_fusion import (
    PETTabularFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.tabular_mri_fusion import (
    TabularMRIFusion,
)
from multimodal_alzheimer_tpu_torch.models.layers import FusedBatchNorm
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
    SmallPETCNN,
)
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp import (
    TabularMLP,
)
from multimodal_alzheimer_tpu_torch.ops import (
    _native,
    hopper_bn,
    hopper_maxpool,
    hopper_norm,
)
from multimodal_alzheimer_tpu_torch.ops.maxpool import (
    max_pool3d_backward_plain,
    pool_forward,
)
from multimodal_alzheimer_tpu_torch.ops.quantile import interpolate
from multimodal_alzheimer_tpu_torch.tools.kernel_times import (
    INT8_CONV_SHAPES,
    INT8_GEOMETRIES,
    NARROW_LAYERS,
    int8_conv_operands,
    int8_geometry_operands,
    narrow_operands,
)
from multimodal_alzheimer_tpu_torch.train.checkpoint import (
    sync_tower_duplicates,
)
from multimodal_alzheimer_tpu_torch.train.driver import fusion_optimizer
from multimodal_alzheimer_tpu_torch.train.state import (
    TrainState,
    make_train_step,
)

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


def _bits_equal(a, b):
    """Equal bit for bit (NaN included)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _check_select(vol, mask, qs):
    before = hopper_norm.LAUNCHES["minmax_select"]
    n, lo, hi = hopper_norm.order_stats(vol, mask, qs)
    torch.cuda.synchronize()
    assert hopper_norm.LAUNCHES["minmax_select"] == before + 1
    n_p, lo_p, hi_p = _plain_stats(vol, mask, qs)
    assert torch.equal(n, n_p)
    assert _bits_equal(lo, lo_p) and _bits_equal(hi, hi_p)


@pytest.mark.parametrize("shape", [GRID, (19, 23, 17)])
@pytest.mark.parametrize("kind", ["normal", "duplicates"])
@pytest.mark.parametrize("qs", [(0.99, 0.01), (1.0, 0.0), (0.5,)])
def test_select_equals_plain(device, shape, kind, qs):
    vol, mask = _scans(kind, 3, shape, seed=1, device=device)
    _check_select(vol, mask, qs)


@pytest.mark.parametrize("n_qs", range(1, 9))
@pytest.mark.parametrize("shape", [GRID, (19, 23, 17)])
def test_select_takes_one_to_eight_levels(device, shape, n_qs):
    """Levels in groups of up to three per pass at 91x109x91 (the shared
    memory beside the keys), four at the ragged shape: each group's digits
    and neighbours are its own."""
    vol, mask = _scans("duplicates" if n_qs % 2 else "normal", 2, shape,
                       seed=20 + n_qs, device=device)
    qs = tuple(float(q) for q in np.linspace(0.0, 1.0, n_qs + 2)[1:-1])
    _check_select(vol, mask, qs[::-1])


def test_select_with_nan_and_an_empty_scan(device):
    """NaN voxels are valid and sort last, as the plain sort puts them; a
    scan with no valid voxel gives +inf for both statistics, as the plain
    sort of an all-invalid row does."""
    vol, mask = _scans("normal", 4, GRID, seed=21, device=device)
    vol.view(4, -1)[1, ::5000] = float("nan")
    vol.view(4, -1)[3] = float("nan")
    mask[2] = 0.0
    _check_select(vol, mask, (0.99, 0.01, 1.0, 0.0))
    n, lo, hi = hopper_norm.order_stats(vol, mask, (0.99, 0.01))
    assert int(n[2]) == 0 and bool(torch.isposinf(lo[2]).all())
    assert bool(torch.isposinf(hi[2]).all())


def test_select_is_one_launch_without_a_workspace(device):
    """At 91x109x91 a scan's keys fit one cluster of 16 blocks: the C entry
    needs no workspace, allocates nothing and writes the same bits as the
    plain version; the wrapper counts one launch."""
    lib = _native.library()
    b, n = 3, int(np.prod(GRID))
    assert lib.minmax_select_cluster_blocks(n) == 16
    assert lib.minmax_select_workspace_words(b, n, 2) == 0
    vol, mask = _scans("normal", b, GRID, seed=22, device=device)
    qs = (0.99, 0.01)
    out = torch.empty((b, 5), dtype=torch.int32, device=device)
    levels = _native.Levels.of(qs)

    def call():
        return lib.minmax_select(vol.data_ptr(), mask.data_ptr(), levels, b,
                                 n, None, out.data_ptr(), vol.device.index,
                                 _native.stream(device))

    code, allocated = _allocations(call)
    assert code == 0 and allocated == 0
    torch.cuda.synchronize()
    n_p, lo_p, hi_p = _plain_stats(vol, mask, qs)
    n_k, lo_k, hi_k = hopper_norm.order_stats(vol, mask, qs)
    assert torch.equal(out[:, 0].long(), n_p)
    assert _bits_equal(lo_k, lo_p) and _bits_equal(hi_k, hi_p)
    assert _bits_equal(hopper_norm._decode_keys(out[:, 1::2]), lo_p)
    assert _bits_equal(hopper_norm._decode_keys(out[:, 2::2]), hi_p)


def test_select_large_scans_take_the_device_memory_route(device):
    """A scan of a million voxels does not fit one cluster: the route is
    the workspace one, chosen from N, and as exact."""
    lib = _native.library()
    shape = (100, 100, 100)
    assert lib.minmax_select_cluster_blocks(10 ** 6) == 0
    assert lib.minmax_select_workspace_words(2, 10 ** 6, 2) > 0
    for kind in ("normal", "duplicates"):
        vol, mask = _scans(kind, 2, shape, seed=23, device=device)
        _check_select(vol, mask, (0.99, 0.01))


def test_select_and_minmax_do_not_wait_for_the_card(device):
    """order_stats and per_scan_minmax only enqueue: both return while a
    spin kernel queued before them still runs (no copy from host memory,
    no synchronisation)."""
    vol, mask = _scans("normal", 8, GRID, seed=24, device=device)
    want = hopper_norm.per_scan_minmax(vol, mask, 0.99)  # builds, warms up
    stats = hopper_norm.order_stats(vol, mask, (0.99, 0.01))
    torch.cuda.synchronize()
    torch.cuda._sleep(int(5e8))  # about a quarter of a second
    start = time.perf_counter()
    got_stats = hopper_norm.order_stats(vol, mask, (0.99, 0.01))
    got = hopper_norm.per_scan_minmax(vol, mask, 0.99)
    host_s = time.perf_counter() - start
    assert not torch.cuda.current_stream().query(), host_s
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got_stats[0], stats[0])
    assert _bits_equal(got_stats[1], stats[1])
    assert _bits_equal(got_stats[2], stats[2])


def test_select_survives_a_scan_with_no_valid_voxel(device):
    vol, mask = _scans("normal", 4, GRID, seed=2, device=device)
    mask[2] = 0.0
    n, lo, hi = hopper_norm.order_stats(vol, mask, (0.99, 0.01))
    torch.cuda.synchronize()
    n_p, lo_p, hi_p = _plain_stats(vol, mask, (0.99, 0.01))
    assert int(n[2]) == 0
    assert torch.equal(lo, lo_p) and torch.equal(hi, hi_p)


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
    assert hopper_norm.LAUNCHES == dict(
        before, minmax_apply=before["minmax_apply"] + 1)
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


def _slabs(depth, n):
    per = -(-depth // n)
    return [(min(q * per, depth), min(q * per + per, depth))
            for q in range(n)]


@pytest.mark.parametrize("shape", [GRID, (19, 23, 17)],
                         ids=["flagship", "odd"])
@pytest.mark.parametrize("n", [2, 4])
def test_zscore_split_matches_plain(device, shape, n):
    """The K3 split on depth slabs (91 as 46 + 45, 23 + 23 + 23 + 22):
    each slab's partials within 1e-12 of the plain float64 sums, the apply
    bit for bit the plain expression, and the statistics from the partials
    added in rank order within 2e-6 of the whole-scan kernel's (its output
    through the same apply equal within the z-score tolerance)."""
    rng = np.random.default_rng(12)
    vol = torch.tensor(rng.normal(900, 40, (3,) + shape),
                       dtype=torch.float32, device=device)
    mask = torch.tensor(rng.random((3,) + shape) > 0.35,
                        dtype=torch.float32, device=device)
    before = dict(hopper_norm.LAUNCHES)
    total = None
    for lo, hi in _slabs(shape[0], n):
        part = hopper_norm.zscore_partials(vol[:, lo:hi], mask[:, lo:hi])
        rows = vol[:, lo:hi].reshape(3, -1), mask[:, lo:hi].reshape(3, -1)
        want = hopper_norm.zscore_partials_plain(*rows)
        torch.testing.assert_close(part, want, rtol=1e-12, atol=0)
        total = part if total is None else total + part
    mean, std = hopper_norm.zscore_stats(total)
    out = hopper_norm.zscore_apply(vol, mask, mean, std)
    torch.cuda.synchronize()
    assert hopper_norm.LAUNCHES["zscore_partials"] == \
        before["zscore_partials"] + n
    assert hopper_norm.LAUNCHES["zscore_apply"] == before["zscore_apply"] + 1
    b = vol.shape[0]
    assert torch.equal(out, hopper_norm.zscore_apply_plain(
        vol.reshape(b, -1), mask.reshape(b, -1), mean, std).reshape(
        vol.shape))
    rows = vol.reshape(b, -1).double(), mask.reshape(b, -1).double()
    valid = rows[0] * rows[1] != 0
    ref_mean = torch.stack([r[v].mean() for r, v in zip(rows[0], valid)])
    ref_std = torch.stack([r[v].std() for r, v in zip(rows[0], valid)])
    torch.testing.assert_close(mean.double(), ref_mean, rtol=2e-6, atol=0)
    torch.testing.assert_close(std.double(), ref_std, rtol=2e-6, atol=0)
    _check_zscore(out, hopper_norm.per_scan_zscore(vol, mask))


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("shape", [(46, 109, 91), (7, 13, 11), (1, 1, 5)],
                         ids=["slab", "odd", "five"])
@pytest.mark.parametrize("offset", [0, 1, 3], ids=["aligned", "off1",
                                                   "off3"])
def test_zscore_partials_on_a_card_sized_grid(device, batch, shape, offset):
    """K3s: a grid sized by the card, each block's partial in its slot, the
    last block of a slab adding the slots in index order. Within 1e-12 of
    the plain float64 sums at batches 1-5, an odd number of voxels and
    operands 1 or 3 floats past a 16-byte boundary (the volume and mask
    equally, or not: offset 3 shifts the mask alone); two calls give the
    same bits with one launch each, and after the first call (which may
    grow the workspace) a call allocates its (B, 3) output alone."""
    rng = np.random.default_rng(31)
    n = int(np.prod(shape))

    def shifted(a, by):
        flat = torch.empty(a.size + by, dtype=torch.float32, device=device)
        flat[by:] = torch.from_numpy(a.reshape(-1))
        return flat[by:].view((batch,) + shape)

    vol = rng.normal(900, 40, (batch,) + shape).astype(np.float32)
    mask = (rng.random((batch,) + shape) > 0.35).astype(np.float32)
    vol_t = shifted(vol, offset % 2)
    mask_t = shifted(mask, offset)
    want = hopper_norm.zscore_partials_plain(
        vol_t.reshape(batch, n), mask_t.reshape(batch, n))
    first = hopper_norm.zscore_partials(vol_t, mask_t)
    before = hopper_norm.LAUNCHES["zscore_partials"]
    second, allocated = _allocations(
        lambda: hopper_norm.zscore_partials(vol_t, mask_t))
    torch.cuda.synchronize()
    assert hopper_norm.LAUNCHES["zscore_partials"] == before + 1
    assert allocated == 1
    assert torch.equal(first, second)
    torch.testing.assert_close(first, want, rtol=1e-12, atol=0)
    blocks = _native.library().zscore_partials_blocks(batch, n, device.index
                                                      or 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    assert blocks == min(-(-sms // batch), -(-n // 2048))


def test_zscore_is_one_launch_without_a_workspace(device):
    """The z-score is one cluster launch: the C entry takes no workspace and
    allocates nothing; two calls give the same bits."""
    lib = _native.library()
    b, n = 8, int(np.prod(GRID))
    vol, mask = _scans("normal", b, GRID, seed=25, device=device)
    out = torch.empty_like(vol)

    def call():
        return lib.zscore_norm(vol.data_ptr(), mask.data_ptr(),
                               out.data_ptr(), b, n, vol.device.index,
                               _native.stream(device))

    code, allocated = _allocations(call)
    assert code == 0 and allocated == 0
    again = hopper_norm.per_scan_zscore(vol, mask)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(out, hopper_norm.per_scan_zscore(vol, mask))
    _check_zscore(out, _zscore_plain(vol, mask))


def test_zscore_mask_other_than_zero_and_one(device):
    """A mask holding values other than 0 and 1 (here 0.5 and -0.0) is read
    again for the output, as the plain version multiplies by it."""
    vol, mask = _scans("normal", 2, GRID, seed=26, device=device)
    mask.view(2, -1)[0, ::7] = 0.5
    mask.view(2, -1)[1, ::11] = -0.0
    got = hopper_norm.per_scan_zscore(vol, mask)
    want = _zscore_plain(vol, mask)
    torch.cuda.synchronize()
    _check_zscore(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.parametrize("shape", [(2, 3, 5), (100, 100, 100)],
                         ids=["30", "1e6"])
def test_zscore_tiny_and_large_scans(device, shape):
    """Thirty voxels (most of the cluster's 16 blocks get none) and a
    million: the same one launch, as exact."""
    vol, mask = _scans("normal", 3, shape, seed=27, device=device)
    _check_zscore(hopper_norm.per_scan_zscore(vol, mask),
                  _zscore_plain(vol, mask))


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


BF16_SHAPES = {k: BN_SHAPES[k] for k in
               ("stem", "layer1", "layer2", "layer3", "layer4", "odd")}


def _bf16_operands(shape, device, seed=0, offset=0):
    """bf16 x and g; ``offset`` elements into a larger buffer, so the
    operands start that many bf16 elements past a 16-byte boundary."""
    x, g, scale, bias = _bn_operands(shape, device, seed)
    n = x.numel()
    xs = torch.empty(n + offset, dtype=torch.bfloat16, device=device)
    gs = torch.empty(n + offset, dtype=torch.bfloat16, device=device)
    xs[offset:] = x.reshape(-1)
    gs[offset:] = g.reshape(-1)
    return (xs[offset:].view(shape), gs[offset:].view(shape), scale, bias)


def _check_bn_bf16(x, g, scale, bias):
    x3, g3 = _rows(x), _rows(g)
    xf, gf = x3.float(), g3.float()
    sums = hopper_bn.bn_stats(x)
    _check_sums(sums, hopper_bn.bn_stats_plain(x3),
                torch.stack([xf.abs().sum((0, 2)), (xf * xf).sum((0, 2))]))
    n = x.numel() // x.shape[1]
    mean = sums[0] / n
    inv = torch.rsqrt(sums[1] / n - mean * mean + 1e-5)
    y = hopper_bn.bn_apply(x, mean, inv, scale, bias)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, hopper_bn.bn_apply_plain(x3, mean, inv, scale,
                                                   bias).reshape(x.shape))
    red_sums = hopper_bn.bn_grad_sum(g, x, mean, inv)
    xhat = (xf - mean[None, :, None]) * inv[None, :, None]
    _check_sums(red_sums, hopper_bn.bn_grad_sum_plain(g3, x3, mean, inv),
                torch.stack([gf.abs().sum((0, 2)),
                             (gf * xhat).abs().sum((0, 2))]))
    red = red_sums / n
    dx = hopper_bn.bn_dx(g, x, mean, inv, scale, red)
    assert dx.dtype == torch.bfloat16
    assert torch.equal(dx, hopper_bn.bn_dx_plain(g3, x3, mean, inv, scale,
                                                 red).reshape(x.shape))
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", sorted(BF16_SHAPES))
def test_bn_kernels_match_plain_in_bfloat16(device, name):
    """bf16 activations: sums within 1e-6 of the sum of magnitudes of the
    bf16 values (both add the same values in f32, in other orders), apply
    and dx equal (f32 arithmetic, one rounding to bf16). At the stem a bf16
    row is 232,760 bytes, so every other row starts off a 16-byte
    boundary."""
    before = dict(hopper_bn.LAUNCHES)
    _check_bn_bf16(*_bf16_operands(BF16_SHAPES[name], device, seed=11))
    assert {k: hopper_bn.LAUNCHES[k] - before[k] for k in before} == \
        dict.fromkeys(before, 1)


@pytest.mark.parametrize("offset", [1, 3, 4])
def test_bn_kernels_in_bfloat16_off_a_16_byte_boundary(device, offset):
    """bf16 operands 2, 6 and 8 bytes past a 16-byte boundary: element
    heads and tails around the 16-byte chunks of every row."""
    _check_bn_bf16(*_bf16_operands(BN_SHAPES["layer1"], device, seed=12,
                                   offset=offset))


def test_bn_kernels_refuse_mixed_activation_dtypes(device):
    x = torch.randn(2, 4, 27, device=device)
    c = torch.ones(4, device=device)
    with pytest.raises(TypeError, match="dtypes"):
        hopper_bn.bn_grad_sum(x.bfloat16(), x, c, c)
    with pytest.raises(TypeError, match="float32 statistics"):
        hopper_bn.bn_apply(x.bfloat16(), c.bfloat16(), c, c, c)


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


@pytest.mark.parametrize("kind", ["normal", "relu_ties", "neg_inf_border"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("shape", [(2, 8, 46, 55, 46), (2, 4, 29, 32, 32),
                                   (1, 3, 12, 14, 12)], ids=str)
def test_maxpool_window_equals_plain(device, shape, dtype, kind):
    """K8 on depth windows: the outputs split over 2, 3 and 4 slabs, each
    slab's window (the lead plane on interior ones) bit for bit its plain
    version, the windows' dx added up the whole volume's; the window (0, D)
    is today's call, bit for bit."""
    x, y, g = _pool_operands(shape, kind, dtype, device, seed=7)
    depth, do = shape[2], y.shape[2]
    whole = hopper_maxpool.max_pool3d_backward(x, y, g)
    assert torch.equal(hopper_maxpool.max_pool3d_backward(x, y, g, 0, depth),
                       whole)
    for n in (2, 3, 4):
        dx = torch.zeros(x.shape, dtype=torch.float32, device=device)
        for o_lo, o_hi in _slabs(do, n):
            if o_hi == o_lo:
                continue
            first, end = max(2 * o_lo - 1, 0), min(2 * o_hi, depth)
            xw = x[:, :, first:end].contiguous()
            yw = y[:, :, o_lo:o_hi].contiguous()
            gw = g[:, :, o_lo:o_hi].contiguous()
            name = "maxpool_bwd_window" if first else "maxpool_bwd"
            before = hopper_maxpool.LAUNCHES[name]
            got = hopper_maxpool.max_pool3d_backward(xw, yw, gw, first,
                                                     depth)
            torch.cuda.synchronize()
            assert hopper_maxpool.LAUNCHES[name] == before + 1
            assert torch.equal(got, max_pool3d_backward_plain(
                xw, yw, gw, first, depth))
            dx[:, :, first:end] += got.float()
        # a plane two windows credit gets each window's sum rounded to the
        # dtype, then their sum: against one rounding per add, a few ulps of
        # the partial sums (which can cancel) in bfloat16
        torch.testing.assert_close(dx, whole.float(), rtol=0,
                                   atol=1e-5 if dtype == torch.float32
                                   else 6.25e-2)


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


# (shape, output slabs): ragged depth windows of 1-3 output slices, odd
# and even H and W, and the [tp] stem slab.
WINDOW_CASES = [((2, 3, 7, 11, 9), 3), ((1, 4, 9, 13, 10), 4),
                ((2, 2, 11, 9, 13), 2), ((1, 32, 46, 55, 46), 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", WINDOW_CASES, ids=lambda c: str(c[0]))
def test_maxpool_window_slabs_equal_plain(device, case, dtype):
    """K8w: every depth window of the outputs split into 2-4 slabs, with
    lead 0 (through maxpool_bwd) and 1 (maxpool_bwd_window), at the slab
    depth the kernel chooses and at forced ones (1, 2, 3, 5 and 8 output
    slices a block, deeper than the window or ragged), bit for bit the
    plain version, one launch a call."""
    shape, n = case
    x, y, g = _pool_operands(shape, "relu_ties", dtype, device, seed=17)
    depth, do = shape[2], y.shape[2]
    for o_lo, o_hi in _slabs(do, n):
        if o_hi == o_lo:
            continue
        first, end = max(2 * o_lo - 1, 0), min(2 * o_hi, depth)
        xw = x[:, :, first:end].contiguous()
        yw = y[:, :, o_lo:o_hi].contiguous()
        gw = g[:, :, o_lo:o_hi].contiguous()
        want = max_pool3d_backward_plain(xw, yw, gw, first, depth)
        name = "maxpool_bwd_window" if first else "maxpool_bwd"
        for slab in (0, 1, 2, 3, 5, 8):
            before = hopper_maxpool.LAUNCHES[name]
            got = hopper_maxpool.max_pool3d_backward(xw, yw, gw, first,
                                                     depth, slab=slab)
            torch.cuda.synchronize()
            assert hopper_maxpool.LAUNCHES[name] == before + 1
            assert torch.equal(got, want), (first, end, slab)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_maxpool_slab_plans(device, dtype):
    """The slab the kernel plans: at the [tp] interior window at most the
    deepest that three blocks an SM allow, every block resident in two
    rounds at most, bit for bit the plain version; at the ResNet-18 stem
    the deepest (a long grid, where a deeper slab reads less halo)."""
    from multimodal_alzheimer_tpu_torch.tools.kernel_times import (
        tp_window_operands,
    )

    gen = torch.Generator(device=device).manual_seed(3)
    xw, yw, g, first, depth = tp_window_operands(gen, device, dtype)
    plan = hopper_maxpool.slab_plan(xw, first, depth)
    deepest = _native.library().maxpool_bwd_slab(
        xw.shape[2] - 1, *xw.shape[3:], 0 if dtype == torch.float32 else 1)
    assert 1 <= plan["td"] <= deepest, plan
    assert 0 < plan["blocks"] <= 2 * plan["resident"], plan
    got = hopper_maxpool.max_pool3d_backward(xw, yw, g, first, depth)
    assert torch.equal(got, max_pool3d_backward_plain(xw, yw, g, first,
                                                      depth))
    stem = torch.empty((8, 64, 46, 55, 46), dtype=dtype, device=device)
    assert hopper_maxpool.slab_plan(stem)["td"] == _slab(stem.shape, dtype)


def test_maxpool_backward_launches_once_without_a_workspace(device):
    x, y, g = _pool_operands((8, 64, 46, 55, 46), "relu_ties",
                             torch.float32, device, seed=6)
    before = hopper_maxpool.LAUNCHES["maxpool_bwd"]
    dx, allocated = _allocations(
        lambda: hopper_maxpool.max_pool3d_backward(x, y, g))
    assert allocated == 1 and dx.shape == x.shape  # dx alone
    assert hopper_maxpool.LAUNCHES["maxpool_bwd"] == before + 1


def test_maxpool_window_launches_once_without_a_workspace(device):
    """K8w on the [tp] interior window allocates dx alone, one launch."""
    from multimodal_alzheimer_tpu_torch.tools.kernel_times import (
        tp_window_operands,
    )

    gen = torch.Generator(device=device).manual_seed(4)
    xw, yw, g, first, depth = tp_window_operands(gen, device)
    hopper_maxpool.max_pool3d_backward(xw, yw, g, first, depth)  # chooses
    before = hopper_maxpool.LAUNCHES["maxpool_bwd_window"]
    dx, allocated = _allocations(
        lambda: hopper_maxpool.max_pool3d_backward(xw, yw, g, first, depth))
    assert allocated == 1 and dx.shape == xw.shape
    assert hopper_maxpool.LAUNCHES["maxpool_bwd_window"] == before + 1


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



# The entry points only a depth-sharded step (parallel/tp.py) launches.
NO_TP_LAUNCHES = dict.fromkeys(
    ("zscore_partials", "zscore_apply", "maxpool_bwd_window"), 0)


def _launches() -> dict:
    return {**hopper_norm.LAUNCHES, **hopper_bn.LAUNCHES,
            **hopper_maxpool.LAUNCHES}


def _fusion_batch(modalities, n, device):
    data = make_labeled_volumes(n, (32, 36, 32), n_classes=2, seed=0,
                                modalities=modalities)
    data["label"] = (np.arange(n) % 2).astype(np.int32)
    return {k: torch.from_numpy(v).to(device) for k, v in data.items()}


@pytest.mark.parametrize("trained", [False, True],
                         ids=["frozen-shared", "towers-trained"])
def test_stage3_step_launches(device, trained):
    """Stage 3 over fused_bn="full" ResNet-10 towers, raw scans: K1 and K2
    once; frozen (shared), K4/K5 once per BatchNorm of one MRI tower and no
    K6/K7; towers trained (unshared), K4-K7 once per BatchNorm of both."""
    gen = torch.Generator(device=device).manual_seed(0)
    kw = dict(freeze_towers=not trained, device=device, generator=gen)

    def mri():
        return AnatCNN.from_hparams(
            {"n_classes": 2, "resnet_depth": 10, "linear_out": ()},
            fused_bn="full", device=device, generator=gen)

    tab = {"n_classes": 2, "hidden": (16, 32)}
    pet = {"n_classes": 2, "conv_out": (4, 8), "filter_size": (3, 3)}
    model = AllModalitiesFusion(
        2, AnatPETFusion(2, SmallPETCNN.from_hparams(pet, device=device),
                         mri(), **kw),
        TabularMRIFusion(2, mri(), TabularMLP.from_hparams(
            tab, device=device), **kw),
        PETTabularFusion(2, SmallPETCNN.from_hparams(pet, device=device),
                         TabularMLP.from_hparams(tab, device=device), **kw),
        freeze_towers=not trained, share_towers=not trained, device=device,
        generator=gen)
    model.load_state_dict(sync_tower_duplicates(model.state_dict()))
    n_bn = sum(isinstance(m, FusedBatchNorm)
               for m in model.model_anat_pet.mri_model.modules())
    hp = {"n_classes": 2, "lr": 1e-3, "l2_reg": 1e-2,
          "lr_pretrained": 1e-5 if trained else None,
          "loss_class_weights": [0.5, 0.5]}
    optimizer = fusion_optimizer(hp, ("stage3out", "cls3"), model)
    step = make_train_step(
        model, make_criterion(hp), optimizer, make_device_preprocess(
            {"mean": 0.5, "std": 0.25}, {"per_scan_norm": "min_max"}))
    batch = _fusion_batch(("mri", "pet1451", "tabular"), 2, device)
    before = _launches()
    step(TrainState(model, optimizer), batch)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in _launches().items()}
    n_fwd, n_bwd = (2 * n_bn, 2 * n_bn) if trained else (n_bn, 0)
    assert n_bn > 0 and got == {
        "minmax_select": 1, "minmax_apply": 1, "zscore": 0,
        "bn_stats": n_fwd, "bn_apply": n_fwd, "bn_grad_sum": n_bwd,
        "bn_dx": n_bwd, "maxpool_bwd": 0, **NO_TP_LAUNCHES}, got


@pytest.mark.parametrize("mri_norm,k12", [
    ({"per_scan_norm": "min_max"}, 1),
    ({"all_scan_norm": {"mean": 426.9336, "std": 1018.783}}, 0)],
    ids=["differentnorm", "samenorm"])
def test_early_fusion_step_launches(device, mri_norm, k12):
    """Early fusion: the per-scan min-max runs K1 and K2 once per step; the
    all-scan z-score is elementwise and runs no kernel."""
    model = PETMRIEarlyFusion(2, conv_out=(4, 8), filter_size=(5, 3),
                              device=device)
    hp = {"n_classes": 2, "loss_class_weights": [0.5, 0.5]}
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_train_step(model, make_criterion(hp), optimizer,
                           make_device_preprocess({"mean": 0.5,
                                                   "std": 0.25}, mri_norm))
    before = _launches()
    _, aux = step(TrainState(model, optimizer),
                  _fusion_batch(("mri", "pet1451"), 4, device))
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in _launches().items()}
    assert np.isfinite(aux["loss"].item())
    assert got == dict(dict.fromkeys(got, 0), minmax_select=k12,
                       minmax_apply=k12), got


class _MinMaxSplit:
    """A dataset's quantile and device preprocess, as
    ``percentile_normalizer`` reads them."""

    quantile = 0.99

    def get_device_preprocess(self):
        return make_device_preprocess(None, {"per_scan_norm": "min_max"},
                                      self.quantile)


def _raw_split(n, seed, modalities=("mri",)):
    data = make_labeled_volumes(n, (32, 36, 32), n_classes=2, seed=seed,
                                modalities=modalities)
    data["label"] = (np.arange(n) % 2).astype(np.int32)
    return data


def test_percentile_normalizer_launches_once_per_split(device):
    """The MRI search normalizes each split once per percentile bucket:
    one K1 and one K2 launch per split, none for a bucket of the resident
    q."""
    from multimodal_alzheimer_tpu_torch.models.mri_models.train_anat_cnn \
        import percentile_normalizer

    normalized = percentile_normalizer(_MinMaxSplit(), _raw_split(6, 0),
                                       _raw_split(4, 1), device)
    counts = []
    for q in (0.95, 0.95, 1.0):
        before = _launches()
        train, val = normalized(q)
        torch.cuda.synchronize()
        counts.append({k: _launches()[k] - before[k]
                       for k in ("minmax_select", "minmax_apply")})
        assert train["mri"].is_cuda and torch.isfinite(train["mri"]).all()
    assert counts == [{"minmax_select": 2, "minmax_apply": 2},
                      {"minmax_select": 0, "minmax_apply": 0},
                      {"minmax_select": 2, "minmax_apply": 2}], counts


def test_shared_tower_trials_launch_once_per_step_for_k_heads(device):
    """K = 3 TabularMRIFusion heads over one fused_bn="full" ResNet-10
    tower, raw scans: per train step K1 and K2 once and K4/K5 once per
    BatchNorm, whatever K is; no K6/K7 (frozen towers run no backward).
    The validation batch and the one shape probe before the first step
    each add K1 and K2 once and no BatchNorm kernel (eval)."""
    from multimodal_alzheimer_tpu_torch.train import fusion_hpo, vmap_hpo

    gen = torch.Generator(device="cpu").manual_seed(0)
    mri = AnatCNN.from_hparams(
        {"n_classes": 2, "resnet_depth": 10, "linear_out": ()},
        fused_bn="full", generator=gen)
    tab = TabularMLP.from_hparams({"n_classes": 2, "hidden": (16, 32)})
    head = TabularMRIFusion(2, copy.deepcopy(mri), copy.deepcopy(tab),
                            freeze_towers=True)
    n_bn = sum(isinstance(m, FusedBatchNorm) for m in mri.modules())
    rows = [{"lr": lr, "trial_seed": i}
            for i, lr in enumerate((1e-3, 3e-3, 1e-2))]
    steps = 2
    before = _launches()
    _, info = fusion_hpo.run_frozen_fusion_trials(
        head, {"mri": mri, "tab": tab},
        {"mri": mri.state_dict(), "tab": tab.state_dict()},
        vmap_hpo.stack_trial_hparams(rows),
        _raw_split(4 * steps, 0, ("mri", "tabular")),
        _raw_split(4, 1, ("mri", "tabular")),
        preprocess=make_device_preprocess(None, {"per_scan_norm": "min_max"}),
        batch_size=4,
        max_epochs=1, patience=1, class_weights=[0.5, 0.5], device=device)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in _launches().items()}
    assert np.isfinite(info["val_history"]).all()
    assert n_bn > 0 and got == {
        "minmax_select": steps + 2, "minmax_apply": steps + 2, "zscore": 0,
        "bn_stats": steps * n_bn, "bn_apply": steps * n_bn,
        "bn_grad_sum": 0, "bn_dx": 0, "maxpool_bwd": 0,
        **NO_TP_LAUNCHES}, got


def test_frozen_trial_keeps_its_backbone_on_the_card(device):
    """lr_select with lr_pretrained traced to 0.0: the frozen trial's
    backbone parameters stay bit for bit on the card, its head moves; the
    unfrozen trial's backbone moves."""
    from multimodal_alzheimer_tpu_torch.train import vmap_hpo

    model = AnatCNN(2, resnet_depth=10, linear_out=(16,),
                    trailing_relu=False)  # no logit clamped dead at init
    rows = [{"lr": 1e-3, "lr_pretrained": None, "trial_seed": 1},
            {"lr": 1e-3, "lr_pretrained": 1e-3, "trial_seed": 2}]
    data = _raw_split(8, 0)
    data["mri"] = data["mri"] / np.abs(data["mri"]).max()
    data.pop("mri_mask")
    _, info = vmap_hpo.run_parallel_trials(
        model, vmap_hpo.stack_trial_hparams(rows,
                                            extra_keys=("lr_pretrained",)),
        data, data, batch_size=4, max_epochs=2, patience=5,
        class_weights=[0.5, 0.5], seed=3,
        apply_fn=lambda m, batch, hp, train: m(batch),
        lr_select=lambda row, keys: (row["lr"] if keys[0] == "head"
                                     else row["lr_pretrained"]),
        return_state=True, device=device)
    params = info["carry"][0]
    init = [vmap_hpo._default_init(model, torch.Generator().manual_seed(
        vmap_hpo.trial_generator_seed(3, r["trial_seed"], 0)), None,
        None).state_dict() for r in rows]
    for name, value in params.items():
        if name.startswith("backbone."):
            assert torch.equal(value[0].cpu(), init[0][name]), name
    assert any(not torch.equal(params[k][0].cpu(), init[0][k])
               for k in params if k.startswith("head."))
    assert any(not torch.equal(params[k][1].cpu(), init[1][k])
               for k in params if k.startswith("backbone."))


# --------------------------------------------------------------------------
# K9: the int8 convolution (ops/int8_conv.py, csrc/int8_conv3d.cu)
# --------------------------------------------------------------------------

# Geometries beyond the flagship's shapes (kernel_times.INT8_GEOMETRIES): the
# C_in=2 stem, depth-50 1^3 convs, the PET tower's SAME pads, per-dimension
# pads, ragged M, N and K tails, long K at C not a multiple of 16, and the
# CPU tests' CONV_CASES.
K9_EXTRA = INT8_GEOMETRIES


def _k9_case(name, batch, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    if name in INT8_CONV_SHAPES:
        return int8_conv_operands(name, batch, gen, device)
    return int8_geometry_operands(name, batch, gen, device)


@pytest.mark.parametrize("name", sorted(
    ["stem", "layer1", "layer2_in", "layer2_down", "layer2", "layer3_in",
     "layer3_down", "layer3", "layer4_in", "layer4_down", "layer4"]
    + list(K9_EXTRA)))
def test_int8_conv_equals_plain(device, name):
    """Bit for bit: the int32 sums with scale 1 and bias 0, then the
    float32 epilogue with random scale and bias."""
    from multimodal_alzheimer_tpu_torch.ops import int8_conv

    x, w, scale, bias, args = _k9_case(name, 2, device, seed=40)
    ones, zeros = torch.ones_like(scale), torch.zeros_like(bias)
    for s, b in ((ones, zeros), (scale, bias)):
        got = int8_conv.int8_conv3d(x, w, s, b, *args)
        torch.cuda.synchronize()
        want = int8_conv.int8_conv3d_plain(x, w, s, b, *args)
        assert got.is_contiguous() and torch.equal(got, want), name


@pytest.mark.parametrize("name", sorted(
    ["stem", "layer1", "layer2_in", "layer2_down", "layer2", "layer3_in",
     "layer3_down", "layer3", "layer4_in", "layer4_down", "layer4"]
    + list(K9_EXTRA)))
def test_int8_conv_fused_equals_plain(device, name):
    """Every epilogue mode the int8 graph uses (residual none, float32 or
    int8; ReLU; float32 or int8 out) bit for bit against the plain fused
    version, one launch each, the output in the mode's dtype."""
    from multimodal_alzheimer_tpu_torch.ops import int8_conv
    from multimodal_alzheimer_tpu_torch.tools.kernel_times import (
        INT8_MODES,
        int8_fused_operands,
        int8_fused_plain,
    )

    x, w, scale, bias, args = _k9_case(name, 2, device, seed=44)
    gen = torch.Generator(device=device).manual_seed(45)
    for mode, (_, _, out_i8) in INT8_MODES.items():
        kw = int8_fused_operands(x, w, scale, bias, args, mode, gen)
        before = int8_conv.LAUNCHES["int8_conv3d"]
        got = int8_conv.int8_conv3d_fused(x, w, scale, bias, *args, **kw)
        torch.cuda.synchronize()
        assert int8_conv.LAUNCHES["int8_conv3d"] == before + 1
        want = int8_fused_plain(x, w, scale, bias, args, kw)
        assert got.dtype == (torch.int8 if out_i8 else torch.float32)
        assert torch.equal(got, want), (name, mode)


def test_int8_conv_launches_once_without_a_workspace(device):
    from multimodal_alzheimer_tpu_torch.ops import int8_conv

    x, w, scale, bias, args = _k9_case("layer3", 2, device, seed=41)
    before = int8_conv.LAUNCHES["int8_conv3d"]
    out, allocated = _allocations(
        lambda: int8_conv.int8_conv3d(x, w, scale, bias, *args))
    assert allocated == 1 and out.dtype == torch.float32
    assert int8_conv.LAUNCHES["int8_conv3d"] == before + 1


def test_int8_conv_refuses_what_it_does_not_take(device):
    from multimodal_alzheimer_tpu_torch.ops import int8_conv

    x, w, scale, bias, args = _k9_case("layer1", 1, device, seed=42)
    with pytest.raises(TypeError, match="int8"):
        int8_conv.int8_conv3d(x.float(), w, scale, bias, *args)
    with pytest.raises(ValueError, match="contiguous"):
        int8_conv.int8_conv3d(x.permute(0, 4, 1, 2, 3), w, scale, bias,
                              *args)
    with pytest.raises(ValueError, match="operands on"):
        int8_conv.int8_conv3d(x.cpu(), w, scale, bias, *args)
    big = torch.zeros((1, 4, 4, 4, 5000), dtype=torch.int8, device=device)
    with pytest.raises(ValueError, match="overflow"):
        int8_conv.int8_conv3d(big, w, scale, bias, *args)
    lib = _native.library()
    assert lib.int8_conv3d_max_k() == int8_conv.MAX_K


def test_custom_ops_under_export_on_the_card(device):
    """An int8 serve with the min-max preprocess exported on the card:
    reloaded, it launches K1, K2 and K9 and gives the eager bits."""
    from multimodal_alzheimer_tpu_torch.inference import export, quantize
    from multimodal_alzheimer_tpu_torch.ops import int8_conv

    model = AnatCNN(3, resnet_depth=10).to(device).eval()
    preprocess = make_device_preprocess(
        normalize_mri={"per_scan_norm": "min_max"}, quantile=0.99)
    rng = np.random.default_rng(43)
    batch = {"mri": torch.tensor(rng.normal(900, 400, (2, 32, 36, 32)),
                                 dtype=torch.float32, device=device),
             "mri_mask": torch.tensor(rng.random((2, 32, 36, 32)) > 0.35,
                                      dtype=torch.float32, device=device)}
    serve, _ = quantize.quantize_anat_cnn(model, [batch], preprocess)
    eager = serve(batch)
    loaded = export.load_exported(export.export_serve_fn(serve, batch))
    hopper_norm.reset_launches()
    int8_conv.reset_launches()
    got = loaded(batch)
    torch.cuda.synchronize()
    assert hopper_norm.LAUNCHES["minmax_select"] == 1
    assert hopper_norm.LAUNCHES["minmax_apply"] == 1
    assert int8_conv.LAUNCHES["int8_conv3d"] == 12  # stem, 8, 3 downsamples
    assert torch.equal(got["logits"], eager["logits"])
    assert torch.equal(got["embeddings"]["backbone_gap"],
                       eager["embeddings"]["backbone_gap"])


# K10 (ops/narrow_conv.py): the PET towers' narrow convolutions at the
# stage-3 shapes (kernel_times.NARROW_LAYERS: block_0 on the full grid,
# block_1 on its first pool), a few volumes and a tower's batch of 32, and
# on an odd grid whose tiles are ragged on every axis.
def _narrow_operands(shape, grid, batch, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return narrow_operands(shape, tuple(grid), batch, gen, device)


def _check_narrow(got, plain, ref, mags, tol):
    """``got`` (bfloat16) against the float64 result ``ref`` of the same
    bfloat16 operands: each value within 2^-8 |ref| (its one rounding to
    bfloat16 is at most 2^-9) plus ``tol`` times the sum of the magnitudes
    of its terms ``mags`` (float32 sums in another order); and the whole
    tensor's distance at most 1.5 times the plain version's (cuDNN's
    bfloat16 result, whose error is its own rounding), so a missing or
    doubled part of a sum shows even where each value is small."""
    got64 = got.double()
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    bound = 2.0 ** -8 * ref.abs() + tol * mags
    assert bool(((got64 - ref).abs() <= bound).all()), \
        float(((got64 - ref).abs() - bound).max())
    assert float((got64 - ref).norm()) <= \
        1.5 * float((plain.double() - ref).norm()) + 2.0 ** -14 * float(
            ref.norm())


def _conv64(x, w, bias=None):
    return torch.nn.functional.conv3d(x.double(), w.double(),
                                      None if bias is None else
                                      bias.double(), padding=w.shape[2] // 2)


@pytest.mark.parametrize("grid,batch", [("stage3", 2), ("stage3", 32),
                                        ((19, 23, 17), 2)], ids=str)
@pytest.mark.parametrize("layer", sorted(NARROW_LAYERS))
def test_narrow_conv_matches_plain(device, layer, grid, batch):
    """fprop, dgrad (block_1; block_0's input takes no gradient) and wgrad
    with db against the float64 result of the same bfloat16 operands, and
    against the plain version (cuDNN's bfloat16 conv and its backward).
    fprop and dgrad sum 1,000 to 2,000 terms (tol 2^-14, the worst-case
    float32 error of such a sum); wgrad and db sum every voxel of the batch
    (tol 2^-12: blocked sums of a fixed number of blocks, 264 or 528
    partials, each block's run 16 times longer at batch 32 than at 2)."""
    from multimodal_alzheimer_tpu_torch.ops import narrow_conv

    shape, stage3 = NARROW_LAYERS[layer]
    grid = stage3 if grid == "stage3" else grid
    x, w, b, dy = _narrow_operands(shape, grid, batch, 11, device)
    with torch.no_grad():
        y = narrow_conv.fprop(x, w, b)
        _check_narrow(y, narrow_conv.fprop_plain(x, w, b), _conv64(x, w, b),
                      _conv64(x.abs(), w.abs(), b.abs()), 2.0 ** -14)
        if shape in narrow_conv.DGRAD:
            dx = narrow_conv.dgrad(dy, w)
            flipped = w.flip((2, 3, 4)).transpose(0, 1)
            _check_narrow(dx, narrow_conv.dgrad_plain(dy, w),
                          _conv64(dy, flipped),
                          _conv64(dy.abs(), flipped.abs()), 2.0 ** -14)
        dw, db = narrow_conv.wgrad(x, dy, w.shape, True)
        plain_dw, plain_db = narrow_conv.wgrad_plain(x, dy, w.shape, True)
        ref = torch.ops.aten.convolution_backward(
            dy.double(), x.double(), w.double(), [w.shape[0]], [1] * 3,
            [w.shape[2] // 2] * 3, [1] * 3, False, [0] * 3, 1,
            [False, True, True])
        mags = torch.ops.aten.convolution_backward(
            dy.double().abs(), x.double().abs(), w.double(), [w.shape[0]],
            [1] * 3, [w.shape[2] // 2] * 3, [1] * 3, False, [0] * 3, 1,
            [False, True, True])
        _check_narrow(dw, plain_dw, ref[1], mags[1], 2.0 ** -12)
        _check_narrow(db, plain_db, ref[2], mags[2], 2.0 ** -12)


@pytest.mark.parametrize("layer", sorted(NARROW_LAYERS))
def test_narrow_conv_wgrad_repeats_its_bits(device, layer):
    """The weight gradient's reduction has a fixed order: two calls give
    the same bits."""
    from multimodal_alzheimer_tpu_torch.ops import narrow_conv

    shape, grid = NARROW_LAYERS[layer]
    x, w, _, dy = _narrow_operands(shape, grid, 2, 12, device)
    first = narrow_conv.wgrad(x, dy, w.shape, True)
    second = narrow_conv.wgrad(x, dy, w.shape, True)
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.parametrize("layer", sorted(NARROW_LAYERS))
def test_narrow_conv_allocates_its_outputs_and_scratch(device, layer):
    """fprop and dgrad allocate their output alone (dgrad reads the weights
    flipped in place); wgrad its partials' scratch, dw and db; each call one
    launch of its direction."""
    from multimodal_alzheimer_tpu_torch.ops import narrow_conv

    shape, grid = NARROW_LAYERS[layer]
    x, w, b, dy = _narrow_operands(shape, grid, 1, 13, device)
    calls = {"fprop": (lambda: narrow_conv.fprop(x, w, b), 1),
             "wgrad": (lambda: narrow_conv.wgrad(x, dy, w.shape, True), 3)}
    if shape in narrow_conv.DGRAD:
        calls["dgrad"] = (lambda: narrow_conv.dgrad(dy, w), 1)
    for name, (call, blocks) in calls.items():
        before = narrow_conv.LAUNCHES[name]
        _, allocated = _allocations(call)
        assert allocated == blocks, name
        assert narrow_conv.LAUNCHES[name] == before + 1, name


def test_narrow_conv_refuses_what_it_has_no_kernel_for(device):
    """On the card a shape with no instance raises; no call falls back."""
    from multimodal_alzheimer_tpu_torch.ops import narrow_conv

    x, w, b, dy = _narrow_operands((16, 32, 3), (8, 8, 8), 1, 14, device)
    with pytest.raises(ValueError, match="no forward"):
        narrow_conv.fprop(x, w, b)
    with pytest.raises(ValueError, match="no weight gradient"):
        narrow_conv.wgrad(x, dy, w.shape, True)
    x, w, b, dy = _narrow_operands((1, 8, 5), (8, 8, 8), 1, 14, device)
    with pytest.raises(ValueError, match="no input gradient"):
        narrow_conv.dgrad(dy, w)
    with pytest.raises(TypeError):
        narrow_conv.fprop(x.float(), w, b)


def test_stage3_and_flagship_steps_launch_k10_by_the_rule(device):
    """A bfloat16 stage-3 step with every tower trained launches K10 as the
    rule predicts: the two PET towers' block_0 and block_1 forward (4),
    their weight gradients (4) and block_1's input gradients (2); a
    bfloat16 AnatCNN step launches none."""
    from multimodal_alzheimer_tpu_torch.ops import narrow_conv
    from multimodal_alzheimer_tpu_torch.tools.cases import (
        FUSION_HPARAMS,
        TAB_HPARAMS,
        raw_batch,
        stage3_model,
        stage3_preprocess,
    )

    batch, (mean, std) = raw_batch(("mri", "pet1451", "tabular"),
                                   (32, 36, 32), 15, device, n=2)
    model = stage3_model(torch.bfloat16, 1e-5,
                         dict(TAB_HPARAMS, feature_mean=mean,
                              feature_std=std), device=device)
    hp = dict(FUSION_HPARAMS, lr_pretrained=1e-5)
    optimizer = fusion_optimizer(hp, ("stage3out", "cls3"), model)
    step = make_train_step(model, make_criterion(hp), optimizer,
                           stage3_preprocess())
    narrow_conv.reset_launches()
    _, aux = step(TrainState(model, optimizer), batch)
    torch.cuda.synchronize()
    assert np.isfinite(aux["loss"].item())
    assert narrow_conv.LAUNCHES == {"fprop": 4, "dgrad": 2, "wgrad": 4}
    flagship = AnatCNN(3, resnet_depth=18, dtype=torch.bfloat16,
                       fused_bn="full").to(device)
    optimizer = torch.optim.Adam(flagship.parameters(), lr=1e-3)
    step = make_train_step(flagship, make_criterion(
        {"n_classes": 3, "loss_class_weights": [0.4, 0.3, 0.3]}), optimizer,
        make_device_preprocess(normalize_mri={"per_scan_norm": "normalize"}))
    narrow_conv.reset_launches()
    mri = make_labeled_volumes(2, (32, 36, 32), n_classes=3, seed=16,
                               modalities=("mri",))
    step(TrainState(flagship, optimizer),
         {"mri": torch.from_numpy(mri["mri"]).to(device),
          "mri_mask": torch.from_numpy(mri["mri_mask"]).to(device),
          "label": torch.tensor([0, 2], device=device)})
    torch.cuda.synchronize()
    assert narrow_conv.LAUNCHES == {"fprop": 0, "dgrad": 0, "wgrad": 0}
