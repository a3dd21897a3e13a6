"""K1's one-cluster select walked in numpy, bit for bit against the plain
version.

``csrc/minmax_norm.cu`` (``select_cluster_kernel``, with the layout of
``csrc/scan_cluster.cuh``) cannot run without the card. This walks the same
decomposition on the CPU: the cluster size and stretch of each scan, each
block's 16-byte-aligned slots with the partial chunks at either end of its
stretch and the padding keys beyond it, the per-block valid counts and digit
histograms, their merge over the cluster in rank order, the levels taken in
groups of what fits beside the keys, the four digit picks, the duplicate
test on the last digit and the smallest key above k_lo, the min over the
blocks. Its order statistics must equal ``hopper_norm.order_stats_plain``'s
bit for bit, NaN included.
"""

import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu_torch.ops import hopper_norm
from torch_threads import torch_threads  # noqa: F401 (autouse)

# csrc/scan_cluster.cuh
THREADS = 1024
MAX_BLOCKS = 16
MAX_SMEM = 232448
# csrc/minmax_norm.cu
BINS = 256
GROUP = THREADS // BINS
INVALID_KEY = np.uint32(0xFF800000)   # +inf
NO_KEY = np.uint32(0xFFFFFFFF)
STATE_BYTES = (4 * (32 + 2 + 5 * GROUP) + 15) // 16 * 16  # SelectState


def stretch(n, blocks):
    return ((n + blocks - 1) // blocks + 3) // 4 * 4


def slots(n, blocks):
    return (stretch(n, blocks) + 6) // 4 * 4


def select_extra(group):
    return 2 * group * BINS * 4 + STATE_BYTES


def cluster_blocks(n):
    for c in range(1, MAX_BLOCKS + 1):
        if slots(n, c) * 4 + select_extra(1) <= MAX_SMEM:
            return c
    return 0


def float_key(v):
    b = v.view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | np.uint32(0x80000000))


def decode(keys):
    keys = np.asarray(keys, np.uint32)
    bits = np.where(keys & 0x80000000, keys & np.uint32(0x7FFFFFFF), ~keys)
    return bits.astype(np.uint32).view(np.float32)


def block_keys(vol_row, mask_row, n, per, rank, row_addr, blocks):
    """Block ``rank``'s slots: keys of its stretch at the row's 16-byte
    chunks, invalid voxels +inf, slots outside the stretch NO_KEY; and its
    valid count."""
    begin = min(rank * per, n)
    end = min(begin + per, n)
    lead = ((row_addr + 4 * begin) % 16) // 4
    base = begin - lead
    keys = np.full(slots(n, blocks), NO_KEY, np.uint32)
    chunks = -(-(end - base) // 4)
    assert chunks <= keys.size // 4
    assert (row_addr + 4 * base) % 16 == 0  # slot chunks are device chunks
    starts = base + 4 * np.arange(chunks)
    whole = (starts >= begin) & (starts + 4 <= end)
    assert whole[1:-1].all()  # only the end chunks may be partial
    val = vol_row[begin:end] * mask_row[begin:end]
    ok = val != 0  # NaN is valid
    keys[lead:lead + end - begin] = np.where(ok, float_key(val),
                                             INVALID_KEY)
    return keys, int(ok.sum())


def pick(counts, rank):
    """(digit, rank within it, keys in it) of the bin holding ``rank``."""
    cum = np.cumsum(counts, dtype=np.int64)
    digit = int(np.searchsorted(cum, rank, side="right"))
    below = int(cum[digit] - counts[digit])
    return digit, rank - below, int(counts[digit])


def low_rank(q, n_valid):
    return int(np.floor(np.float32(q)
                        * (np.float32(n_valid) - np.float32(1.0))))


def walk_scan(vol_row, mask_row, qs, row_addr):
    n = vol_row.size
    blocks = cluster_blocks(n)
    assert blocks > 0
    per = stretch(n, blocks)
    parts = [block_keys(vol_row, mask_row, n, per, r, row_addr, blocks)
             for r in range(blocks)]
    keys = [k for k, _ in parts]
    n_valid = 0
    top = np.zeros(BINS, np.int64)
    for k, valid in parts:  # the merge over the cluster, in rank order
        n_valid += valid
        top += np.bincount(k >> 24, minlength=BINS)
    total_keys = blocks * keys[0].size
    group = GROUP
    while group > 1 and (keys[0].size * 4 + select_extra(group)
                         > MAX_SMEM):
        group -= 1
    group = min(group, len(qs))
    out = [n_valid]
    for t0 in range(0, len(qs), group):
        for q in qs[t0:t0 + group]:
            lo = low_rank(q, n_valid)
            rank = min(max(lo, 0), total_keys - 1)
            digit, rank, equal = pick(top, rank)
            prefix = digit << 24
            for p in (1, 2, 3):
                shift = 24 - 8 * p
                high = (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF
                counts = np.zeros(BINS, np.int64)
                for k in keys:
                    on = k[(k & np.uint32(high)) == prefix]
                    counts += np.bincount((on >> shift) & 0xFF,
                                          minlength=BINS)
                digit, rank, equal = pick(counts, rank)
                prefix |= digit << shift
            same = (equal > rank + 1
                    or np.float32(lo) + np.float32(1.0)
                    >= np.float32(n_valid))
            k_hi = prefix
            if not same:
                k_hi = min(int(k[k > prefix].min(initial=NO_KEY))
                           for k in keys)
            out += [prefix, k_hi]
    return out


def walk(vol, mask, qs, base_addr):
    b = vol.shape[0]
    vol, mask = vol.reshape(b, -1), mask.reshape(b, -1)
    n = vol.shape[1]
    rows = [walk_scan(vol[i], mask[i], qs, base_addr + 4 * i * n)
            for i in range(b)]
    counts = np.array([r[0] for r in rows], np.int64)
    lo = decode([r[1::2] for r in rows])
    hi = decode([r[2::2] for r in rows])
    return counts, lo, hi


def scans(kind, batch, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "duplicates":
        vol = np.round(rng.normal(size=(batch,) + shape) * 4)
        mask = np.ones_like(vol)
    else:
        vol = rng.normal(900, 400, (batch,) + shape)
        mask = (rng.random((batch,) + shape) > 0.35).astype(np.float64)
    vol, mask = vol.astype(np.float32), mask.astype(np.float32)
    if kind == "nan_empty":
        vol.reshape(batch, -1)[0, ::97] = np.nan
        mask[-1] = 0.0
    return vol, mask


CASES = [
    ((91, 109, 91), "normal", (0.99, 0.01), 0),
    ((91, 109, 91), "duplicates", (1.0, 0.0, 0.5), 8),
    ((91, 109, 91), "nan_empty", (0.99, 0.01, 1.0, 0.0, 0.5), 4),
    ((19, 23, 17), "normal", (0.99, 0.01), 12),
    ((19, 23, 17), "nan_empty", tuple(np.linspace(0.05, 0.95, 8)), 4),
    ((60, 61, 62), "duplicates", (0.75,), 8),
    ((7, 5, 3), "normal", (0.99, 0.01, 0.5), 0),
]


@pytest.mark.parametrize("shape,kind,qs,base", CASES,
                         ids=[f"{'x'.join(map(str, s))}-{k}-q{len(q)}-{b}"
                              for s, k, q, b in CASES])
def test_k1_cluster_walk_equals_plain(shape, kind, qs, base):
    """``base``: the batch's byte offset from a 16-byte boundary; scans
    after the first start wherever N * 4 bytes put them."""
    vol, mask = scans(kind, 2, shape, seed=len(qs) + base)
    n, lo, hi = walk(vol, mask, qs, base)
    qs_t = torch.tensor(qs, dtype=torch.float32)
    n_p, lo_p, hi_p = hopper_norm.order_stats_plain(
        torch.from_numpy(vol.reshape(2, -1)),
        torch.from_numpy(mask.reshape(2, -1)), qs_t)
    np.testing.assert_array_equal(n, n_p.numpy())
    np.testing.assert_array_equal(lo.view(np.uint32),
                                  lo_p.numpy().view(np.uint32))
    np.testing.assert_array_equal(hi.view(np.uint32),
                                  hi_p.numpy().view(np.uint32))


def test_k1_cluster_layout_at_the_flagship_grid():
    """91x109x91: 16 blocks of 56,416 voxels, 225,680 bytes of keys, and
    levels in groups of 3 beside them."""
    n = 91 * 109 * 91
    assert cluster_blocks(n) == 16
    assert stretch(n, 16) == 56416 and slots(n, 16) * 4 == 225680
    assert slots(n, 16) * 4 + select_extra(3) <= MAX_SMEM
    assert slots(n, 16) * 4 + select_extra(4) > MAX_SMEM
    assert cluster_blocks(10 ** 6) == 0
