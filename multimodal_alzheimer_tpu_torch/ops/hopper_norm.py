"""Per-scan MRI normalisation: Hopper kernels and plain versions.

Counterpart of ``multimodal_alzheimer_tpu/ops/pallas_norm.py``'s
``batched_masked_quantiles``, ``per_scan_minmax``, ``minmax_apply`` and
``per_scan_zscore``. Three kernels do the work on the card:

* ``minmax_select`` (``csrc/minmax_norm.cu``): exact per-scan order
  statistics by an 8-bit digit radix select over keys held in one
  thread-block cluster per scan (the TPU's ``_minmax_select_kernel``);
* ``minmax_apply`` (same file): ``clamp((x - qmin) / (qmax - qmin), 0, 1) *
  mask`` (the TPU's ``_minmax_apply_kernel``);
* ``zscore`` (``csrc/zscore_norm.cu``): ``(x - mean) / std * mask`` with the
  mean and Bessel-corrected std of each scan's ``{x*mask != 0}``, one
  thread-block cluster per scan (the TPU's ``_zscore_stream_kernel``).

For a batch whose depth is sharded over a spatial axis (``parallel/tp.py``)
the z-score runs split, in two entry points of the same file:
``zscore_partials`` (each slab's count, sum and sum of squares in double)
and ``zscore_apply`` (the apply with given per-scan mean and std). The
slabs' partials are gathered over the spatial group and added in rank
order, and ``zscore_stats`` takes mean and std from them as the kernel
does (``per_scan_zscore``). The min-max path gathers the whole scans over
the spatial group for the selection and applies on the slab.

Each wrapper takes the plain PyTorch version for CPU tensors only. For a CUDA
tensor it launches the kernel or raises; no other device is accepted. Every
kernel launch adds one to ``LAUNCHES[name]``, so a run can show that its
requests went through the kernels. On the card the wrappers only enqueue
work: the quantile levels travel by value in the launch arguments, and the
interpolation takes them from a tensor made once per device by a fill
kernel, so no call copies from host memory or waits for the card.

The three kernels are custom ops (``mmalz_port::order_stats``,
``::minmax_apply``, ``::zscore``): CPU kernel the plain version, CUDA kernel
the hand-written one, and a fake kernel for shapes, so ``torch.export``
records each as one op and an exported program launches the same kernel.
"""

from __future__ import annotations

import functools

import torch
from torch._subclasses.fake_tensor import is_fake

from multimodal_alzheimer_tpu_torch.ops import _native
from multimodal_alzheimer_tpu_torch.parallel.tp import spatial
from multimodal_alzheimer_tpu_torch.ops.quantile import (
    interpolate,
    order_stats_rows,
)

LAUNCHES = {"minmax_select": 0, "minmax_apply": 0, "zscore": 0,
            "zscore_partials": 0, "zscore_apply": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _rows(volume: torch.Tensor, mask: torch.Tensor):
    """(B, N) contiguous float32 views of a (B, ...) volume and mask."""
    if volume.shape != mask.shape:
        raise ValueError(f"volume {tuple(volume.shape)} and mask "
                         f"{tuple(mask.shape)} differ in shape")
    if volume.device != mask.device:
        raise ValueError(f"volume on {volume.device}, mask on {mask.device}")
    b = volume.shape[0]
    return (volume.reshape(b, -1).to(torch.float32).contiguous(),
            mask.reshape(b, -1).to(torch.float32).contiguous())


def order_stats_plain(vol: torch.Tensor, mask: torch.Tensor,
                      qs: torch.Tensor):
    """Plain version of ``minmax_select``: a full sort of each row."""
    return order_stats_rows(vol * mask, qs)


def _fill_levels(qs: tuple[float, ...], device: torch.device):
    return torch.stack([torch.full((), q, dtype=torch.float32, device=device)
                        for q in qs])


@functools.cache
def levels_tensor(qs: tuple[float, ...], device: torch.device):
    """(Q,) float32 ``qs`` on ``device``, made once by fill kernels (no
    copy from host memory); equal to ``torch.tensor(qs, dtype=float32)``."""
    return _fill_levels(qs, device)


def _order_stats_kernel(vol: torch.Tensor, mask: torch.Tensor,
                        qs: tuple[float, ...]):
    """One launch with no workspace for a scan that 16 blocks' shared memory
    holds (``minmax_select_cluster_blocks(N) > 0``: N up to about 3.7
    million voxels, 91x109x91 is 902,629), else the device-memory route
    with its workspace. The route depends on N alone."""
    lib = _native.library()
    b, n = vol.shape
    levels = _native.Levels.of(qs)
    device = vol.device
    words = lib.minmax_select_workspace_words(b, n, len(qs))
    work = (torch.empty(words, dtype=torch.int32, device=device)
            if words else None)
    out = torch.empty((b, 1 + 2 * len(qs)), dtype=torch.int32, device=device)
    code = lib.minmax_select(
        vol.data_ptr(), mask.data_ptr(), levels, b, n,
        work.data_ptr() if work is not None else None, out.data_ptr(),
        device.index, _native.stream(device))
    _native.check(code, "minmax_select")
    LAUNCHES["minmax_select"] += 1
    return (out[:, 0].to(torch.int64), _decode_keys(out[:, 1::2]),
            _decode_keys(out[:, 2::2]))


def _decode_keys(keys: torch.Tensor) -> torch.Tensor:
    """Inverse of the kernel's order-preserving float -> uint32 key map."""
    keys = keys.contiguous()
    bits = torch.where(keys < 0, keys & 0x7FFFFFFF, ~keys)
    return bits.view(torch.float32)


@torch.library.custom_op("mmalz_port::order_stats", mutates_args=(),
                         device_types="cpu")
def _order_stats_op(vol: torch.Tensor, mask: torch.Tensor,
                    qs: list[float]) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    return order_stats_plain(vol, mask, _fill_levels(tuple(qs), vol.device))


@_order_stats_op.register_kernel("cuda")
def _(vol, mask, qs):
    return _order_stats_kernel(vol, mask, tuple(qs))


@_order_stats_op.register_fake
def _(vol, mask, qs):
    b = vol.shape[0]
    return (vol.new_empty((b,), dtype=torch.int64),
            vol.new_empty((b, len(qs))), vol.new_empty((b, len(qs))))


def order_stats(volume: torch.Tensor, mask: torch.Tensor,
                qs: tuple[float, ...]):
    """Per-scan ``(n, v_lo, v_hi)`` order statistics of ``{x*mask != 0}``.

    ``qs`` (1 to 8 levels) are formed in Python double and cast to float32,
    as in JAX. Returns the (B,) int64 valid counts and two (B, Q) float32
    tensors. A scan with no valid voxel gives +inf for both statistics.
    """
    vol, msk = _rows(volume, mask)
    _native.on_cuda(vol)  # raises for a device with neither route
    return _order_stats_op(vol, msk, [float(q) for q in qs])


def batched_masked_quantiles(volume: torch.Tensor, mask: torch.Tensor,
                             qs: tuple[float, ...]) -> torch.Tensor:
    """(B, Q) exact per-scan quantiles of the nonzero masked voxels.

    Matches ``torch.quantile(..., interpolation='linear')`` over each scan's
    ``{x*mask != 0}`` voxels; needs >= 2 valid voxels per scan for a
    meaningful result (a scan with none gives NaN).
    """
    n, v_lo, v_hi = order_stats(volume, mask, qs)
    # Under torch.export the tensors are fake: the cache must not keep one.
    levels = _fill_levels if is_fake(v_lo) else levels_tensor
    return interpolate(n, v_lo, v_hi, levels(tuple(qs), v_lo.device))


def minmax_apply_plain(volume: torch.Tensor, mask: torch.Tensor,
                       qmin: torch.Tensor, qmax: torch.Tensor) -> torch.Tensor:
    """Plain version of ``minmax_apply`` on (B, ...) operands."""
    expand = (slice(None),) + (None,) * (volume.ndim - 1)
    out = (volume - qmin[expand]) / (qmax - qmin)[expand]
    return torch.clamp(out, 0.0, 1.0) * mask


def _minmax_apply_kernel(vol: torch.Tensor, mask: torch.Tensor,
                         qmin: torch.Tensor, qmax: torch.Tensor):
    lib = _native.library()
    b, n = vol.shape
    if qmin.shape != (b,) or qmax.shape != (b,):
        raise ValueError(f"qmin {tuple(qmin.shape)} and qmax "
                         f"{tuple(qmax.shape)} must both be ({b},)")
    q = torch.stack([qmin, qmax], dim=1).to(vol.device, torch.float32)
    out = torch.empty_like(vol)
    device = vol.device
    code = lib.minmax_apply(
        vol.data_ptr(), mask.data_ptr(), q.data_ptr(),
        out.data_ptr(), b, n, device.index,
        _native.stream(device))
    _native.check(code, "minmax_apply")
    LAUNCHES["minmax_apply"] += 1
    return out


@torch.library.custom_op("mmalz_port::minmax_apply", mutates_args=(),
                         device_types="cpu")
def _minmax_apply_op(vol: torch.Tensor, mask: torch.Tensor,
                     qmin: torch.Tensor, qmax: torch.Tensor) -> torch.Tensor:
    return minmax_apply_plain(vol, mask, qmin.to(torch.float32),
                              qmax.to(torch.float32))


@_minmax_apply_op.register_kernel("cuda")
def _(vol, mask, qmin, qmax):
    return _minmax_apply_kernel(vol, mask, qmin, qmax)


@_minmax_apply_op.register_fake
def _(vol, mask, qmin, qmax):
    return torch.empty_like(vol)


def minmax_apply(volume: torch.Tensor, mask: torch.Tensor,
                 qmin: torch.Tensor, qmax: torch.Tensor) -> torch.Tensor:
    """``clamp((x - qmin) / (qmax - qmin), 0, 1) * mask`` with (B,) per-scan
    bounds, as float32 of the volume's shape."""
    vol, msk = _rows(volume, mask)
    _native.on_cuda(vol)  # raises for a device with neither route
    return _minmax_apply_op(vol, msk, qmin, qmax).reshape(volume.shape)


def per_scan_minmax(volume: torch.Tensor, mask: torch.Tensor,
                    quantile: float = 0.99) -> torch.Tensor:
    """Quantile min-max normalisation of a (B, ...) batch, per scan.

    ``(x - Q(1-q)) / (Q(q) - Q(1-q))`` clamped to [0, 1] and re-masked
    (reference: dataloader.py:261-270), with exact quantiles. On a
    depth-sharded batch (``parallel.tp.spatial()``) the quantiles are taken
    of the whole scans, gathered over the spatial group, and the apply runs
    on the slab.
    """
    levels = (quantile, 1.0 - quantile)
    sp = spatial()
    if sp is None:
        quants = batched_masked_quantiles(volume, mask, levels)
    else:
        quants = batched_masked_quantiles(sp.gather_depth(volume),
                                          sp.gather_depth(mask), levels)
    return minmax_apply(volume, mask, quants[:, 1], quants[:, 0])


def zscore_plain(vol: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``zscore`` kernel on (B, N) rows: the two-pass
    mean and std of ``ops/quantile.masked_nonzero_mean_std`` for every scan
    at once, then ``(x - mean) / std * mask``."""
    vals = vol * mask
    valid = vals != 0
    n = valid.sum(dim=1).to(vol.dtype)
    mean = torch.where(valid, vals, 0).sum(dim=1) / n
    sq = torch.where(valid, (vals - mean[:, None]) ** 2, 0)
    std = torch.sqrt(sq.sum(dim=1) / torch.clamp(n - 1, min=1))
    return (vol - mean[:, None]) / std[:, None] * mask


def _zscore_kernel(vol: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One launch, no workspace: a cluster of 16 blocks per scan."""
    lib = _native.library()
    b, n = vol.shape
    device = vol.device
    out = torch.empty_like(vol)
    code = lib.zscore_norm(vol.data_ptr(), mask.data_ptr(), out.data_ptr(), b,
                           n, device.index, _native.stream(device))
    _native.check(code, "zscore_norm")
    LAUNCHES["zscore"] += 1
    return out


@torch.library.custom_op("mmalz_port::zscore", mutates_args=(),
                         device_types="cpu")
def _zscore_op(vol: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return zscore_plain(vol, mask)


@_zscore_op.register_kernel("cuda")
def _(vol, mask):
    return _zscore_kernel(vol, mask)


@_zscore_op.register_fake
def _(vol, mask):
    return torch.empty_like(vol)


def zscore_partials_plain(vol: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Plain version of ``zscore_partials`` on (B, N) rows: (B, 3) float64
    count, sum and sum of squares of each row's ``{x*mask != 0}``."""
    vals = vol * mask
    valid = vals != 0
    v = torch.where(valid, vals, 0).to(torch.float64)
    return torch.stack([valid.sum(dim=1).to(torch.float64), v.sum(dim=1),
                        (v * v).sum(dim=1)], dim=1)


def zscore_apply_plain(vol: torch.Tensor, mask: torch.Tensor,
                       mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Plain version of ``zscore_apply``: ``(x - mean) / std * mask`` with
    (B,) float32 mean and std, the expression of ``zscore_plain``."""
    return (vol - mean[:, None]) / std[:, None] * mask


def zscore_stats(partials: torch.Tensor):
    """float32 (mean, std) per scan from (B, 3) float64 count, sum and sum
    of squares, as ``csrc/zscore_norm.cu`` takes them: mean = sum / n, var =
    (sumsq - sum * mean) / max(n - 1, 1), at least 0, in double."""
    n, a, q = partials.unbind(dim=1)
    mean = a / n
    var = torch.clamp((q - a * mean) / torch.clamp(n - 1.0, min=1.0),
                      min=0.0)
    return mean.to(torch.float32), torch.sqrt(var).to(torch.float32)


# zscore_partials' workspace per (device index, stream handle): the int32
# arrival counters (zeroed once; the kernel leaves them 0) and the float64
# slots of the blocks' partials, grown when a batch needs more.
_PARTIALS_WORKSPACE: dict = {}


def _partials_workspace(device, stream: int, batch: int, slots: int):
    key = (device.index, stream)
    arrivals, partials = _PARTIALS_WORKSPACE.get(key, (None, None))
    if arrivals is None or arrivals.numel() < batch:
        arrivals = torch.zeros(batch, dtype=torch.int32, device=device)
    if partials is None or partials.numel() < 3 * slots:
        partials = torch.empty(3 * slots, dtype=torch.float64, device=device)
    _PARTIALS_WORKSPACE[key] = arrivals, partials
    return arrivals, partials


def _zscore_partials_kernel(vol: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """One launch: a grid sized by the card, the blocks' partials merged
    in a fixed order by the last block of each slab, in a workspace kept
    per device and stream (allocated at a call only when it grows)."""
    lib = _native.library()
    b, n = vol.shape
    device = vol.device
    blocks = lib.zscore_partials_blocks(b, n, device.index)
    if blocks == 0:
        raise ValueError(f"zscore_partials takes no ({b}, {n}) batch on "
                         f"{device}")
    stream = _native.stream(device)
    arrivals, slots = _partials_workspace(device, stream, b, b * blocks)
    out = torch.empty((b, 3), dtype=torch.float64, device=device)
    code = lib.zscore_partials(vol.data_ptr(), mask.data_ptr(),
                               out.data_ptr(), slots.data_ptr(),
                               arrivals.data_ptr(), b, n, device.index,
                               stream)
    _native.check(code, "zscore_partials")
    LAUNCHES["zscore_partials"] += 1
    return out


def _zscore_apply_kernel(vol, mask, mean, std) -> torch.Tensor:
    lib = _native.library()
    b, n = vol.shape
    device = vol.device
    mean = mean.to(device, torch.float32).contiguous()
    std = std.to(device, torch.float32).contiguous()
    if mean.shape != (b,) or std.shape != (b,):
        raise ValueError(f"mean {tuple(mean.shape)} and std "
                         f"{tuple(std.shape)} must both be ({b},)")
    out = torch.empty_like(vol)
    code = lib.zscore_apply(vol.data_ptr(), mask.data_ptr(), mean.data_ptr(),
                            std.data_ptr(), out.data_ptr(), b, n,
                            device.index, _native.stream(device))
    _native.check(code, "zscore_apply")
    LAUNCHES["zscore_apply"] += 1
    return out


def zscore_partials(volume: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, 3) float64 count, sum and sum of squares of each scan's (or
    slab's) ``{x*mask != 0}``."""
    vol, msk = _rows(volume, mask)
    if not _native.on_cuda(vol):
        return zscore_partials_plain(vol, msk)
    return _zscore_partials_kernel(vol, msk)


def zscore_apply(volume: torch.Tensor, mask: torch.Tensor, mean: torch.Tensor,
                 std: torch.Tensor) -> torch.Tensor:
    """``(x - mean) / std * mask`` with (B,) per-scan mean and std, as
    float32 of the volume's shape."""
    vol, msk = _rows(volume, mask)
    if not _native.on_cuda(vol):
        out = zscore_apply_plain(vol, msk, mean.to(torch.float32),
                                 std.to(torch.float32))
    else:
        out = _zscore_apply_kernel(vol, msk, mean, std)
    return out.reshape(volume.shape)


def per_scan_zscore(volume: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-scan z-score of a (B, ...) batch over each scan's nonzero masked
    voxels, re-masked (reference: dataloader.py:252-260), as float32 of the
    volume's shape. Operands of another dtype are cast to float32 first, on
    both paths. A scan with no valid voxel gives NaN throughout; one with a
    single valid voxel has std 0. On a depth-sharded batch
    (``parallel.tp.spatial()``) the slabs' partial sums are gathered over
    the spatial group and added in rank order, then applied on the slab."""
    vol, msk = _rows(volume, mask)
    _native.on_cuda(vol)  # raises for a device with neither route
    sp = spatial()
    if sp is None:
        return _zscore_op(vol, msk).reshape(volume.shape)
    parts = sp.gather_spatial(zscore_partials(vol, msk))
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    mean, std = zscore_stats(total)
    return zscore_apply(vol, msk, mean, std).reshape(volume.shape)
