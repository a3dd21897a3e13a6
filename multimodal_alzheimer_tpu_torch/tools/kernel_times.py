"""Device times of the per-scan normalisation kernels (K1 select, K3
z-score), the BatchNorm kernels (K4-K7, float32 and bfloat16), the stem
max-pool backward (K8), the int8 convolution (K9, at every shape of the
int8 ResNet-18, batch 8 and 32, with cuDNN's bfloat16 convolution of the
same shape beside it as context) and the PET towers' narrow convolutions
(K10, each direction of each block the rule takes, at a stage-3 tower's
batch of 32, with cuDNN's call beside it), with their plain versions and
torch's call for the same function where there is one, at the shapes of
the flagship ResNet-18 serving and train paths; and the entry points of the
depth-sharded path (K3 split into ``zscore_partials`` and ``zscore_apply``,
K8's ``maxpool_bwd_window``, in float32 and bfloat16, and K8 on the edge
window) at one rank's shapes of a (1, 2, 2) mesh; with ``--k8-slabs``, K8
at every slab depth at those windows and the stem.

    python3 multimodal_alzheimer_tpu_torch/tools/kernel_times.py \
        [--root DIR] [--label NAME] [--out FILE] [--kernels K,...] \
        [--bn-dtypes float32,bfloat16] [--k8-slabs]

It imports ``multimodal_alzheimer_tpu_torch`` from ``--root`` (default: the
checkout that holds this file) and calls only its public wrappers
(``hopper_norm.order_stats``, ``hopper_norm.per_scan_zscore``,
``hopper_bn.bn_*``, ``hopper_maxpool.max_pool3d_backward``), so one command
on one card can time two checkouts' kernels in turns: A, B, B, A, each in a
process of its own. It prints one line per kernel, shape and dtype, then the
card's name and power limit, and writes the rows as JSON to ``--out``.
``chip_smoke.py`` takes its kernel times from the same functions. A
checkout whose ``order_stats`` waits for the card (its levels copied from
host memory, before ``hopper_norm.levels_tensor``) cannot be queued behind
a spin; its K1 is timed on the launch alone.

Two figures per call:

* ``device_ms`` (the one every table reports): CUDA events around
  ``launches`` back-to-back calls that the host enqueues behind a spin
  kernel (``torch.cuda._sleep``), so the card runs them from a full queue
  and the wrappers' host time (argument checks, ``torch.empty``, the ctypes
  call) is hidden; the elapsed time over the count, median of ``reps``
  runs. A run in which the spin ended before the host had enqueued every
  call is thrown away and taken again with a spin twice as long.
* ``call_ms``: CUDA events around one call, median of 20; the card waits
  for the host inside each call, so ``call_ms - device_ms`` is the host
  time a lone call costs.

The calls cycle through copies of their operands, enough that one round
moves at least twice the H100's 50 MB L2 cache: each call finds its inputs
in device memory, as the bound assumes, and not in L2 from the call before.
Plain versions launch a kernel per tensor operation, more than the launch
queue holds behind a spin, so they are timed with back-to-back calls and no
spin: their figure includes whatever host time their launches cost.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# BatchNorm inputs of the ResNet-18 backbone (dilated) at 91x109x91, batch 8,
# and how many of the 20 BatchNorms of a train step run at each shape: the
# stem's, layer1's 2 blocks x 2, layers 2-4's 2 blocks x 2 and a shortcut.
BN_SHAPES = {"stem": (8, 64, 46, 55, 46), "layer1": (8, 64, 23, 28, 23),
             "layer2": (8, 128, 12, 14, 12), "layer3": (8, 256, 12, 14, 12),
             "layer4": (8, 512, 12, 14, 12)}
BN_PER_STEP = {"stem": 1, "layer1": 4, "layer2": 5, "layer3": 5,
               "layer4": 5}
BN_KERNELS = ("bn_stats", "bn_apply", "bn_grad_sum", "bn_dx")
BN_EPS = 1e-5
# The per-scan normalisation at the serving rungs and the train batch.
GRID = (91, 109, 91)
NORM_BATCHES = (8, 32)
NORM_KERNELS = ("minmax_select", "zscore")
QS = (0.99, 0.01)
# The stem pool's input at 91x109x91, batch 8 (NCDHW).
STEM = (8, 64, 46, 55, 46)
# Every distinct convolution of the int8 ResNet-18 (dilated) at 91x109x91:
# name -> (C_in, F, kernel, stride, dilation, input (D, H, W), convs of that
# shape in one forward); 20 convolutions in all, 3 of them downsamples.
INT8_CONV_SHAPES = {
    "stem": (1, 64, 7, 2, 1, (91, 109, 91), 1),
    "layer1": (64, 64, 3, 1, 1, (23, 28, 23), 4),
    "layer2_in": (64, 128, 3, 2, 1, (23, 28, 23), 1),
    "layer2_down": (64, 128, 1, 2, 1, (23, 28, 23), 1),
    "layer2": (128, 128, 3, 1, 1, (12, 14, 12), 3),
    "layer3_in": (128, 256, 3, 1, 2, (12, 14, 12), 1),
    "layer3_down": (128, 256, 1, 1, 1, (12, 14, 12), 1),
    "layer3": (256, 256, 3, 1, 2, (12, 14, 12), 3),
    "layer4_in": (256, 512, 3, 1, 4, (12, 14, 12), 1),
    "layer4_down": (256, 512, 1, 1, 1, (12, 14, 12), 1),
    "layer4": (512, 512, 3, 1, 4, (12, 14, 12), 3),
}
# K9's epilogue modes the int8 ResNet graph uses: name -> (residual dtype,
# relu, int8 output). "f32" is int8_conv3d itself (the downsamples and the
# PET towers); the stem and each block's first conv take "relu_i8"; a block's
# last conv adds its shortcut (the int8 carrier, or the downsample's float32
# output), and the last block's writes the float32 feature map.
INT8_MODES = {"f32": (None, False, False), "relu_i8": (None, True, True),
              "res_i8_relu_i8": (torch.int8, True, True),
              "res_f32_relu_i8": (torch.float32, True, True),
              "res_i8_relu_f32": (torch.int8, True, False),
              "res_f32_relu_f32": (torch.float32, True, False)}
# The convolutions of one dilated ResNet-18 forward by shape and mode.
INT8_FORWARD = {
    "stem": {"relu_i8": 1},
    "layer1": {"relu_i8": 2, "res_i8_relu_i8": 2},
    "layer2_in": {"relu_i8": 1}, "layer2_down": {"f32": 1},
    "layer2": {"res_f32_relu_i8": 1, "relu_i8": 1, "res_i8_relu_i8": 1},
    "layer3_in": {"relu_i8": 1}, "layer3_down": {"f32": 1},
    "layer3": {"res_f32_relu_i8": 1, "relu_i8": 1, "res_i8_relu_i8": 1},
    "layer4_in": {"relu_i8": 1}, "layer4_down": {"f32": 1},
    "layer4": {"res_f32_relu_i8": 1, "relu_i8": 1, "res_i8_relu_f32": 1},
}
# Further geometries K9 is held to on the card: (C_in, F, kernel, stride,
# dilation, pads, input (D, H, W)): the C_in=2 stem, depth-50 1^3 convs, the
# PET tower's SAME pads (k=5, and k=4 asymmetric), per-dimension pads,
# ragged M, N and K tails (F=70, K=81), C not a multiple of 16 with K longer
# than the shared-memory ring (64- and 128-wide tiles), and the CPU tests'
# CONV_CASES (tests/test_torch_quantize.py) at their (9, 10, 8) input.
INT8_GEOMETRIES = {
    "stem_2ch": (2, 64, (7, 7, 7), 2, 1, ((3, 3),) * 3, (91, 109, 91)),
    "d50_expand": (64, 256, (1, 1, 1), 1, 1, ((0, 0),) * 3, (23, 28, 23)),
    "d50_reduce": (1024, 256, (1, 1, 1), 1, 1, ((0, 0),) * 3, (12, 14, 12)),
    "d50_down": (1024, 2048, (1, 1, 1), 1, 1, ((0, 0),) * 3, (12, 14, 12)),
    "pet_k5": (1, 8, (5, 5, 5), 1, 1, ((2, 2),) * 3, (91, 109, 91)),
    "pet_k4": (8, 16, (4, 4, 4), 1, 1, ((1, 2),) * 3, (45, 54, 45)),
    "per_dim_pads": (48, 70, (3, 2, 3), 2, 2, ((2, 1), (0, 1), (2, 2)),
                     (9, 11, 10)),
    "ragged": (3, 70, (3, 3, 3), 1, 1, ((1, 1),) * 3, (5, 7, 6)),
    "long_k_64": (8, 16, (7, 7, 7), 1, 1, ((3, 3),) * 3, (9, 10, 8)),
    "long_k_128": (3, 100, (7, 7, 7), 2, 1, ((3, 3),) * 3, (15, 14, 13)),
    **{f"case{i}": case + ((9, 10, 8),) for i, case in enumerate([
        (1, 8, (7, 7, 7), 2, 1, ((3, 3),) * 3),
        (2, 8, (7, 7, 7), 2, 1, ((3, 3),) * 3),
        (8, 16, (3, 3, 3), 1, 1, ((1, 1),) * 3),
        (64, 16, (3, 3, 3), 2, 1, ((1, 1),) * 3),
        (64, 24, (1, 1, 1), 2, 1, ((0, 0),) * 3),
        (16, 8, (3, 3, 3), 1, 2, ((2, 2),) * 3),
        (16, 8, (3, 3, 3), 1, 4, ((4, 4),) * 3),
        (8, 4, (4, 4, 4), 1, 1, ((1, 2),) * 3),
        (1, 4, (5, 5, 5), 1, 1, ((2, 2),) * 3),
        (3, 5, (3, 2, 3), 1, 1, ((1, 1), (0, 1), (1, 1))),
    ])}}
# The int8 tensor cores of one H100 SXM, dense: 1,979 TOP/s.
INT8_OPS_PER_MS = 1979e9
# One H100 SXM: 3.35 TB/s of HBM, 67 TFLOP/s f32 outside the tensor cores,
# 50 MB of L2.
HBM_BYTES_PER_MS = 3.35e9
F32_FLOP_PER_MS = 67e9
L2_BYTES = 50e6
# Cycles of the spin kernel per ms: above the H100's top SM clock (1.98 GHz),
# so a spin meant to last t ms lasts at least that long.
SPIN_CYCLES_PER_MS = 2.0e6
MAX_SPIN_MS = 2000.0


def n_copies(nbytes: float, most: int = 16) -> int:
    """Copies of operands of ``nbytes`` whose round moves 2x the L2."""
    return max(1, min(most, math.ceil(2 * L2_BYTES / nbytes)))


def device_ms(fns, launches: int = 40, reps: int = 5, warmup: int = 3,
              spin: bool = True) -> float:
    """Device ms of one call of ``fns`` (cycled), from a full queue."""
    n = len(fns)
    for i in range(max(warmup, n)):
        fns[i % n]()
    torch.cuda.synchronize()
    start_s = time.perf_counter()
    for i in range(launches):
        fns[i % n]()
    host_ms = (time.perf_counter() - start_s) * 1e3
    torch.cuda.synchronize()
    spin_ms = 2 * host_ms + 1.0
    times = []
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
        start.record()
        for i in range(launches):
            fns[i % n]()
        end.record()
        drained = spin and start.query()
        end.synchronize()
        if drained:  # the card ran dry while the host was enqueueing
            spin_ms *= 2
            if spin_ms > MAX_SPIN_MS:
                raise RuntimeError(
                    f"the host enqueues {launches} calls slower than a "
                    f"{MAX_SPIN_MS} ms spin: no device time to measure")
            continue
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def call_ms(fns, reps: int = 20, warmup: int = 3) -> float:
    """Median ms of one call between two CUDA events, the host's time in
    the call included."""
    n = len(fns)
    for i in range(max(warmup, n)):
        fns[i % n]()
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fns[i % n]()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple:
    """Least time one H100 SXM could take: the bytes over 3.35 TB/s or the
    f32 operations over 67 TFLOP/s, whichever is larger; and which."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_MS, flops / F32_FLOP_PER_MS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def bn_bounds(shape, item: int = 4) -> dict:
    """Per kernel: each input read once, each output written once
    (activations of ``item`` bytes, float32 (C,) vectors), and its f32
    operations per element."""
    elems = float(np.prod(shape))
    c = shape[1]
    #        (full tensors moved, (C,) vectors moved, flops per element)
    counts = {"bn_stats": (1, 2, 3), "bn_apply": (2, 4, 4),
              "bn_grad_sum": (2, 4, 5), "bn_dx": (3, 5, 6)}
    return {k: bound(item * t * elems + 4 * v * c, f * elems)
            for k, (t, v, f) in counts.items()}


def norm_bounds(batch: int, n: int) -> dict:
    """K1: volume and mask read once, (B, 1 + 2Q) words written, one
    multiply per voxel; K3: volume and mask read, the output written, four
    f32 operations per voxel (its double sums are 3 more on 34 TFLOP/s, far
    below the bytes either way)."""
    voxels = float(batch * n)
    return {"minmax_select": bound(8 * voxels + 4 * batch * (1 + 2 * len(QS)),
                                   voxels),
            "zscore": bound(12 * voxels, 4 * voxels)}


def norm_operands(batch: int, generator, device):
    """The flagship entry recipe: N(900, 400) volumes, masks > 0.35."""
    shape = (batch,) + GRID
    vol = torch.randn(shape, generator=generator, device=device) * 400 + 900
    mask = (torch.rand(shape, generator=generator, device=device)
            > 0.35).to(torch.float32)
    return vol, mask


def time_norm(batch: int, generator, device,
              kernels=NORM_KERNELS) -> dict:
    """K1 (``order_stats``, the whole call) and K3 (``per_scan_zscore``) at
    (batch, 91x109x91): device and per-call ms, the plain version's ms and
    the bound; no library call computes either function."""
    from multimodal_alzheimer_tpu_torch.ops import hopper_norm

    vol, mask = norm_operands(batch, generator, device)
    copies = [(vol, mask)] + [(vol.clone(), mask.clone()) for _ in range(
        n_copies(8 * vol.numel()) - 1)]
    b = batch
    qs_t = torch.tensor(QS, dtype=torch.float32, device=device)
    if hasattr(hopper_norm, "levels_tensor"):
        select = [lambda v=v, m=m: hopper_norm.order_stats(v, m, QS)
                  for v, m in copies]
    else:  # the wrapper waits for the card: time the launch alone
        select = [lambda v=v, m=m: hopper_norm._order_stats_kernel(
            v.reshape(b, -1), m.reshape(b, -1), qs_t) for v, m in copies]
    calls = {
        "minmax_select": (select, [lambda: hopper_norm.order_stats_plain(
            vol.reshape(b, -1), mask.reshape(b, -1), qs_t)]),
        "zscore": ([lambda v=v, m=m: hopper_norm.per_scan_zscore(v, m)
                    for v, m in copies],
                   [lambda: hopper_norm.zscore_plain(
                       vol.reshape(b, -1), mask.reshape(b, -1))]),
    }
    bounds = norm_bounds(batch, int(np.prod(GRID)))
    out = {}
    for name in kernels:
        kernel, plain = calls[name]
        out[name] = {"ms": device_ms(kernel), "call_ms": call_ms(kernel),
                     "plain_ms": device_ms(plain, launches=5, reps=3,
                                           spin=False),
                     "library_ms": None, "library_call_ms": None,
                     "bound_ms": bounds[name][0],
                     "bound_by": bounds[name][1]}
    return out


def pool_bound(shape, dtype, winners=None) -> tuple:
    """K8's bound: x, y, g read once and dx written once; its operations
    are the winner compares this run makes (a window stops at its winner)
    and one add per credited window."""
    from multimodal_alzheimer_tpu_torch.ops.maxpool import NO_WINNER

    n_in = float(np.prod(shape))
    n_out = float(np.prod(shape[:2])) * float(np.prod(
        [(n - 1) // 2 + 1 for n in shape[2:]]))
    item = torch.tensor([], dtype=dtype).element_size()
    ops = 0.0
    if winners is not None:
        ops = float((winners.clamp(max=NO_WINNER - 1).to(torch.float64)
                     + 1).sum() + (winners < NO_WINNER).sum())
    return bound(item * (2 * n_in + 2 * n_out), ops)


# The [tp] shapes: a (1, 2, 2) mesh at 91x109x91, global batch 4. A rank
# z-scores its depth slab of the scans (46 or 45 planes of 91); the stem
# pool's input is 32 channels of 64 and the rank's slab of 46 planes, whose
# interior slab (spatial rank 1, outputs [12, 23)) reads planes [23, 46)
# with its lead plane through the window entry point, and whose edge slab
# (spatial rank 0, outputs [0, 12)) planes [0, 24) through maxpool_bwd.
TP_ZSCORE = (4, 46) + GRID[1:]
TP_POOL = (4, 32, 46, 55, 46)
TP_POOL_WINDOW = (23, 46)  # its planes [first, end) of 46
TP_POOL_EDGE = (0, 24)
TP_KERNELS = ("zscore_partials", "zscore_apply", "maxpool_bwd_window")
# K8's slab depths timed by --k8-slabs (output slices a block).
K8_SLABS = tuple(range(1, 9))


def tp_window_operands(generator, device, dtype=torch.float32,
                       window=TP_POOL_WINDOW):
    """A slab's window of the stem pool at ``TP_POOL`` (the interior one by
    default): x, y and g of the window (ReLU-zero ties), and its first plane
    and depth."""
    first, end = window
    depth = TP_POOL[2]
    x = torch.relu(torch.randn(TP_POOL, generator=generator, device=device)
                   - 0.8).to(dtype)
    y = torch.nn.functional.max_pool3d(x, 3, 2, 1)
    o_lo = (first + 1) // 2
    o_hi = (end + 1) // 2 if end < depth else y.shape[2]
    xw = x[:, :, first:end].contiguous()
    yw = y[:, :, o_lo:o_hi].contiguous()
    g = torch.randn(yw.shape, generator=generator, device=device).to(dtype)
    return xw, yw, g, first, depth


def window_bound(xw, yw, first: int) -> tuple:
    """K8's bound on a window: x, y, g read once, dx written once; the
    compares this run's winners make and one add per credited window."""
    from multimodal_alzheimer_tpu_torch.ops.maxpool import (
        NO_WINNER,
        winner_offsets,
    )

    winners = winner_offsets(xw, yw, lead=1 if first else 0)
    ops = float((winners.clamp(max=NO_WINNER - 1).to(torch.float64) + 1)
                .sum() + (winners < NO_WINNER).sum())
    pool_bytes = (2 * xw.numel() + 2 * yw.numel()) * xw.element_size()
    return bound(pool_bytes, ops)


def time_window(generator, device, dtype=torch.float32,
                window=TP_POOL_WINDOW) -> dict:
    """K8 on a [tp] slab's window (``maxpool_bwd_window`` for the interior
    one, ``maxpool_bwd`` for the edge one): device and per-call ms, the
    plain version's ms, the bound and the kernel's slab (``slab_plan``)."""
    from multimodal_alzheimer_tpu_torch.ops import hopper_maxpool
    from multimodal_alzheimer_tpu_torch.ops.maxpool import (
        max_pool3d_backward_plain,
    )

    xw, yw, g, first, depth = tp_window_operands(generator, device, dtype,
                                                 window)
    pool_bytes = (2 * xw.numel() + 2 * yw.numel()) * xw.element_size()
    pools = [(xw, yw, g)] + [(xw.clone(), yw.clone(), g.clone()) for _ in
                             range(n_copies(pool_bytes) - 1)]
    kernel = [lambda c=c: hopper_maxpool.max_pool3d_backward(
        c[0], c[1], c[2], first, depth) for c in pools]
    bound_ms, bound_by = window_bound(xw, yw, first)
    plan = (hopper_maxpool.slab_plan(xw, first, depth)
            if hasattr(hopper_maxpool, "slab_plan") else None)
    return {"ms": device_ms(kernel), "call_ms": call_ms(kernel),
            "plain_ms": device_ms([lambda: max_pool3d_backward_plain(
                xw, yw, g, first, depth)], launches=5, reps=3, spin=False),
            "library_ms": None, "library_call_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by, "plan": plan,
            "dims": tuple(xw.shape), "window": window, "dtype": str(dtype)}


# An empty kernel, for the time of a launch alone on a given grid; built
# here at first use, beside the port's kernels, and never part of them.
EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int64_t blocks, int64_t threads, int64_t device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  empty_kernel<<<static_cast<unsigned>(blocks),
                 static_cast<unsigned>(threads), 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
"""
# Threads of a zscore_partials block (kPartialThreads, csrc/zscore_norm.cu).
PARTIAL_THREADS = 512


def empty_launcher():
    """``empty_launch(blocks, threads, device, stream)`` of EMPTY_SOURCE,
    compiled with the port's nvcc into its build directory."""
    import ctypes
    import hashlib

    from multimodal_alzheimer_tpu_torch.ops import _native

    digest = hashlib.sha256(EMPTY_SOURCE.encode()).hexdigest()[:16]
    lib = _native.BUILD_DIR / f"libempty_launch-{digest}.so"
    if not lib.exists():
        _native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = lib.with_suffix(".cu")
        src.write_text(EMPTY_SOURCE)
        subprocess.run([_native._nvcc(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-shared",
                        "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
                       check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).empty_launch
    fn.argtypes = [ctypes.c_int64] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def time_partials(batch: int, generator, device) -> dict:
    """``zscore_partials`` on ``batch`` slabs of 46x109x91: device and
    per-call ms, the plain version's ms, the bound, and, where the checkout
    sizes its grid by the card (``zscore_partials_blocks``), the grid's
    blocks and the device ms of an empty kernel on the same grid (the
    launch alone)."""
    from multimodal_alzheimer_tpu_torch.ops import _native, hopper_norm

    shape = (batch,) + TP_ZSCORE[1:]
    vol = torch.randn(shape, generator=generator, device=device) * 400 + 900
    mask = (torch.rand(shape, generator=generator, device=device)
            > 0.35).to(torch.float32)
    voxels = float(vol.numel())
    copies = [(vol, mask)] + [(vol.clone(), mask.clone()) for _ in range(
        n_copies(8 * voxels) - 1)]
    kernel = [lambda v=v, m=m: hopper_norm.zscore_partials(v, m)
              for v, m in copies]
    rows = vol.reshape(batch, -1), mask.reshape(batch, -1)
    bound_ms, bound_by = bound(8 * voxels + 24 * batch, 3 * voxels)
    out = {"ms": device_ms(kernel), "call_ms": call_ms(kernel),
           "plain_ms": device_ms([lambda: hopper_norm.zscore_partials_plain(
               *rows)], launches=5, reps=3, spin=False),
           "library_ms": None, "library_call_ms": None,
           "bound_ms": bound_ms, "bound_by": bound_by, "empty_ms": None,
           "dims": shape}
    lib = _native.library()
    if hasattr(lib, "zscore_partials_blocks"):
        index, stream = device.index or 0, _native.stream(device)
        blocks = batch * lib.zscore_partials_blocks(batch, rows[0].shape[1],
                                                    index)
        empty = empty_launcher()
        out["empty_ms"] = device_ms([lambda: empty(
            blocks, PARTIAL_THREADS, index, stream)])
        out["blocks"] = blocks
    return out


def time_tp(generator, device) -> dict:
    """The [tp] entry points at ``TP_ZSCORE`` and ``TP_POOL``: K3's
    ``zscore_partials`` (at batch 4 and 1) and ``zscore_apply`` on one
    rank's slabs, K8's ``maxpool_bwd_window`` on the interior window in
    float32 and bfloat16 and K8 on the edge window; device and per-call ms,
    the plain versions' ms and the bounds (bytes: each input read once,
    each output written once, at 3.35 TB/s). No library call computes
    these functions."""
    from multimodal_alzheimer_tpu_torch.ops import hopper_norm

    b = TP_ZSCORE[0]
    vol = torch.randn(TP_ZSCORE, generator=generator, device=device) * 400 \
        + 900
    mask = (torch.rand(TP_ZSCORE, generator=generator, device=device)
            > 0.35).to(torch.float32)
    voxels = float(vol.numel())
    copies = [(vol, mask)] + [(vol.clone(), mask.clone()) for _ in range(
        n_copies(8 * voxels) - 1)]
    mean = torch.full((b,), 900.0, device=device)
    std = torch.full((b,), 400.0, device=device)
    rows = vol.reshape(b, -1), mask.reshape(b, -1)
    kernel = [lambda v=v, m=m: hopper_norm.zscore_apply(v, m, mean, std)
              for v, m in copies]
    bound_ms, bound_by = bound(12 * voxels + 8 * b, 4 * voxels)
    out = {"zscore_partials": time_partials(b, generator, device),
           "zscore_partials B=1": time_partials(1, generator, device),
           "zscore_apply": {
               "ms": device_ms(kernel), "call_ms": call_ms(kernel),
               "plain_ms": device_ms([lambda: hopper_norm.zscore_apply_plain(
                   *rows, mean, std)], launches=5, reps=3, spin=False),
               "library_ms": None, "library_call_ms": None,
               "bound_ms": bound_ms, "bound_by": bound_by, "dims": TP_ZSCORE},
           "maxpool_bwd_window": time_window(generator, device),
           "maxpool_bwd_window bf16": time_window(generator, device,
                                                  torch.bfloat16)}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        out[f"maxpool_bwd edge {tag}"] = time_window(
            generator, device, dtype, TP_POOL_EDGE)
    return out


def time_k8_slabs(generator, device, slabs=K8_SLABS) -> list:
    """K8's device ms at each slab depth of ``slabs`` that fits a block and
    at the one it chooses, at the [tp] interior and edge windows and the
    ResNet-18 stem (batch 8) in float32 and bfloat16; each result checked
    equal to the chosen slab's. Rows: case, dtype, slab, ms, equal, and the
    chosen slab's plan."""
    from multimodal_alzheimer_tpu_torch.ops import hopper_maxpool

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, window in (("interior", TP_POOL_WINDOW),
                             ("edge", TP_POOL_EDGE)):
            xw, yw, g, first, depth = tp_window_operands(generator, device,
                                                         dtype, window)
            cases.append((name, dtype, xw, yw, g, first, depth))
        x, y, _, g = pool_operands(STEM, dtype, generator, device)
        cases.append(("stem", dtype, x, y, g, 0, None))
    rows = []
    for name, dtype, x, y, g, first, depth in cases:
        nbytes = (2 * x.numel() + 2 * y.numel()) * x.element_size()
        copies = [(x, y, g)] + [(x.clone(), y.clone(), g.clone()) for _ in
                                range(n_copies(nbytes) - 1)]
        want = hopper_maxpool.max_pool3d_backward(x, y, g, first, depth)
        chosen = hopper_maxpool.slab_plan(x, first, depth)
        for td in (0,) + tuple(slabs):
            def call(c, td=td):
                return hopper_maxpool.max_pool3d_backward(
                    c[0], c[1], c[2], first, depth, slab=td)
            try:
                equal = torch.equal(call(copies[0]), want)
            except RuntimeError:  # the slab does not fit a block
                continue
            ms = device_ms([lambda c=c: call(c) for c in copies], reps=3)
            rows.append({"case": name, "dtype": str(dtype),
                         "slab": "chosen" if td == 0 else td,
                         "plan": chosen, "ms": ms, "equal": equal})
        del copies
    return rows


def bn_operands(shape, generator, device, dtype=torch.float32):
    """x and g in ``dtype`` (the model's compute dtype), float32 scale and
    bias."""
    c = shape[1]
    x = torch.randn(shape, generator=generator, device=device) * 2 + 0.5
    g = torch.randn(shape, generator=generator, device=device)
    scale = torch.rand(c, generator=generator, device=device) + 0.5
    bias = torch.randn(c, generator=generator, device=device)
    return x.to(dtype), g.to(dtype), scale, bias


def _rows3(t):
    return t.reshape(t.shape[0], t.shape[1], -1)


def bn_chain(x, g):
    """The kernels' inputs as batch_norm_train forms them: mean, inv, red."""
    from multimodal_alzheimer_tpu_torch.ops import hopper_bn

    n = x.numel() // x.shape[1]
    sums = hopper_bn.bn_stats_plain(_rows3(x))
    mean = sums[0] / n
    inv = torch.rsqrt(sums[1] / n - mean * mean + BN_EPS)
    red = hopper_bn.bn_grad_sum_plain(_rows3(g), _rows3(x), mean, inv) / n
    return mean, inv, red


def bn_calls(shape, generator, device, dtype=torch.float32) -> dict:
    """Per BatchNorm kernel: (kernel, plain, library) lists of calls, one
    per copy of the operands; and F.batch_norm's (forward, backward)."""
    from multimodal_alzheimer_tpu_torch.ops import hopper_bn

    x, g, scale, bias = bn_operands(shape, generator, device, dtype)
    mean, inv, red = bn_chain(x, g)
    n = x.numel() // shape[1]
    count = torch.tensor([n], dtype=torch.int32, device=device)
    sum_dy, sum_dy_xmu = torch.batch_norm_backward_reduce(
        g, x, mean, inv, scale, True, True, True)[:2]
    copies = [(x, g)] + [(x.clone(), g.clone()) for _ in range(
        n_copies(2 * x.element_size() * x.numel()) - 1)]

    def each(make):
        return [make(xc, gc) for xc, gc in copies]

    calls = {
        "bn_stats": (
            each(lambda xc, gc: lambda: hopper_bn.bn_stats(xc)),
            each(lambda xc, gc: lambda: hopper_bn.bn_stats_plain(
                _rows3(xc))),
            each(lambda xc, gc: lambda: torch.batch_norm_stats(xc, BN_EPS))),
        "bn_apply": (
            each(lambda xc, gc: lambda: hopper_bn.bn_apply(
                xc, mean, inv, scale, bias)),
            each(lambda xc, gc: lambda: hopper_bn.bn_apply_plain(
                _rows3(xc), mean, inv, scale, bias)),
            each(lambda xc, gc: lambda: torch.batch_norm_elemt(
                xc, scale, bias, mean, inv, BN_EPS))),
        "bn_grad_sum": (
            each(lambda xc, gc: lambda: hopper_bn.bn_grad_sum(
                gc, xc, mean, inv)),
            each(lambda xc, gc: lambda: hopper_bn.bn_grad_sum_plain(
                _rows3(gc), _rows3(xc), mean, inv)),
            each(lambda xc, gc: lambda: torch.batch_norm_backward_reduce(
                gc, xc, mean, inv, scale, True, True, True))),
        "bn_dx": (
            each(lambda xc, gc: lambda: hopper_bn.bn_dx(
                gc, xc, mean, inv, scale, red)),
            each(lambda xc, gc: lambda: hopper_bn.bn_dx_plain(
                _rows3(gc), _rows3(xc), mean, inv, scale, red)),
            each(lambda xc, gc: lambda: torch.batch_norm_backward_elemt(
                gc, xc, mean, inv, scale, sum_dy, sum_dy_xmu, count))),
    }
    graphs = []
    for xc, gc in copies:
        xg = xc.detach().clone().requires_grad_(True)
        sg = scale.detach().clone().requires_grad_(True)
        bg = bias.detach().clone().requires_grad_(True)
        y = torch.nn.functional.batch_norm(xg, None, None, sg, bg,
                                           training=True, eps=BN_EPS)
        graphs.append((y, xg, sg, bg, gc))
    calls["F.batch_norm"] = (
        each(lambda xc, gc: lambda: torch.nn.functional.batch_norm(
            xc, None, None, scale, bias, training=True, eps=BN_EPS)),
        [lambda y=y, xg=xg, sg=sg, bg=bg, gc=gc: torch.autograd.grad(
            y, (xg, sg, bg), gc, retain_graph=True)
         for y, xg, sg, bg, gc in graphs])
    return calls


def time_bn(shape, generator, device, kernels=BN_KERNELS,
            dtype=torch.float32) -> dict:
    """Per BatchNorm kernel at ``shape`` with ``dtype`` activations: device
    and per-call ms of the kernel and the library call, the plain version's
    ms, and the bound; and F.batch_norm's forward and backward device ms."""
    calls = bn_calls(shape, generator, device, dtype)
    bounds = bn_bounds(shape, torch.tensor([], dtype=dtype).element_size())
    out = {}
    for name in kernels:
        kernel, plain, library = calls[name]
        out[name] = {
            "ms": device_ms(kernel), "call_ms": call_ms(kernel),
            "plain_ms": device_ms(plain, spin=False),
            "library_ms": device_ms(library),
            "library_call_ms": call_ms(library),
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1]}
    fwd, bwd = calls["F.batch_norm"]
    out["F.batch_norm"] = {"forward_ms": device_ms(fwd),
                           "backward_ms": device_ms(bwd)}
    return out


def aten_pool_backward(g, x, indices):
    return torch.ops.aten.max_pool3d_with_indices_backward(
        g, x, [3, 3, 3], [2, 2, 2], [1, 1, 1], [1, 1, 1], False, indices)


def pool_operands(shape, dtype, generator, device):
    """ReLU-zero ties, as after the stem: x, its pool y, aten's indices,
    and a cotangent g."""
    x = torch.relu(torch.randn(shape, generator=generator, device=device)
                   - 0.8).to(dtype)
    y, indices = torch.nn.functional.max_pool3d(x, 3, 2, 1,
                                                return_indices=True)
    g = torch.randn(y.shape, generator=generator, device=device).to(dtype)
    return x, y, indices, g


def time_pool(x, y, indices, g) -> dict:
    """K8 at one input: device and per-call ms of the kernel and aten's
    backward, the plain version's ms, and the bound."""
    from multimodal_alzheimer_tpu_torch.ops import hopper_maxpool
    from multimodal_alzheimer_tpu_torch.ops.maxpool import (
        max_pool3d_backward_plain,
        winner_offsets,
    )

    nbytes = (x.numel() + y.numel() + g.numel()) * x.element_size()
    copies = [(x, y, indices, g)] + [
        tuple(t.clone() for t in (x, y, indices, g))
        for _ in range(n_copies(nbytes) - 1)]
    kernel = [lambda c=c: hopper_maxpool.max_pool3d_backward(c[0], c[1],
                                                              c[3])
              for c in copies]
    library = [lambda c=c: aten_pool_backward(c[3], c[0], c[2])
               for c in copies]
    bound_ms, bound_by = pool_bound(tuple(x.shape), x.dtype,
                                    winner_offsets(x, y))
    return {"ms": device_ms(kernel), "call_ms": call_ms(kernel),
            "plain_ms": device_ms([lambda: max_pool3d_backward_plain(
                x, y, g)], launches=5, reps=3, spin=False),
            "library_ms": device_ms(library),
            "library_call_ms": call_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by}


# K10: the SmallPETCNN blocks the rule takes, at a stage-3 step's shapes:
# one call a tower at batch 32 (two towers a step), block_0 on the full
# grid, block_1 on its first pool; bounds by bytes (each operand read once,
# each output written once) or bf16 operations at 989 TFLOP/s.
NARROW_LAYERS = {"block_0": ((1, 8, 5), GRID),
                 "block_1": ((8, 16, 5), (45, 54, 45))}
NARROW_BATCH = 32
NARROW_CALLS_PER_STEP = 2
BF16_FLOP_PER_MS = 989e9


def narrow_bound(shape, grid, batch: int) -> tuple:
    """(ms, what bounds it) of one direction of a narrow conv: each reads
    one of its two activation tensors and writes or reads the other (x and
    y, dy and dx, x and dy), 2 * MACs operations."""
    cin, cout, k = shape
    voxels = batch * math.prod(grid)
    nbytes = (cin + cout) * voxels * 2
    flops = 2 * voxels * cin * cout * k ** 3
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_MS, flops / BF16_FLOP_PER_MS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def narrow_operands(shape, grid, batch: int, generator, device):
    """bfloat16 x, w, bias and dy of a narrow conv."""
    cin, cout, k = shape
    x = torch.randn((batch, cin) + tuple(grid), generator=generator,
                    device=device)
    w = torch.randn((cout, cin, k, k, k), generator=generator,
                    device=device) / math.sqrt(cin * k ** 3)
    b = torch.rand(cout, generator=generator, device=device)
    dy = torch.randn((batch, cout) + tuple(grid), generator=generator,
                     device=device)
    return tuple(t.to(torch.bfloat16) for t in (x, w, b, dy))


def narrow_gap(got, want) -> dict:
    """The relative L2 distance and the largest absolute difference of a
    K10 result from its plain version's."""
    diff = got.float() - want.float()
    return {"rel_l2": (diff.norm() / want.float().norm()).item(),
            "max_abs_err": diff.abs().max().item()}


def time_narrow(layer: str, generator, device,
                batch: int = NARROW_BATCH) -> dict:
    """K10 at ``NARROW_LAYERS[layer]``: per direction (fprop, dgrad where
    the rule takes an input gradient, wgrad with db) the kernel's device
    and per-call ms, cuDNN's (the plain version, ``F.conv3d`` and
    ``aten.convolution_backward``, the library call the rule replaces), the
    bound, and the distance of the kernel's result from the plain
    version's on the same operands (``narrow_gap``; the wgrad's record
    also db's, as ``db``, and whether a second call repeats its bits)."""
    from multimodal_alzheimer_tpu_torch.ops import narrow_conv

    shape, grid = NARROW_LAYERS[layer]
    x, w, b, dy = narrow_operands(shape, grid, batch, generator, device)
    nbytes = (x.numel() + dy.numel()) * 2
    copies = [(x, dy)] + [(x.clone(), dy.clone())
                          for _ in range(n_copies(nbytes) - 1)]
    calls = {"fprop": (lambda c: narrow_conv.fprop(c[0], w, b),
                       lambda c: narrow_conv.fprop_plain(c[0], w, b)),
             "wgrad": (lambda c: narrow_conv.wgrad(c[0], c[1], w.shape, True),
                       lambda c: narrow_conv.wgrad_plain(c[0], c[1], w.shape,
                                                         True))}
    if shape in narrow_conv.DGRAD:
        calls["dgrad"] = (lambda c: narrow_conv.dgrad(c[1], w),
                          lambda c: narrow_conv.dgrad_plain(c[1], w))
    bound_ms, bound_by = narrow_bound(shape, grid, batch)
    out = {}
    with torch.no_grad():
        for direction, (kernel_call, plain_call) in calls.items():
            got, want = kernel_call(copies[0]), plain_call(copies[0])
            if direction == "wgrad":
                again = kernel_call(copies[0])
                gaps = {**narrow_gap(got[0], want[0]),
                        "db": narrow_gap(got[1], want[1]),
                        "repeats": all(map(torch.equal, got, again))}
                del again
            else:
                gaps = narrow_gap(got, want)
            del got, want
            kernel = [lambda c=c: kernel_call(c) for c in copies]
            library = [lambda c=c: plain_call(c) for c in copies]
            library_ms = device_ms(library, launches=10)
            out[direction] = {
                "dims": (batch,) + tuple(grid), "shape": shape,
                "ms": device_ms(kernel, launches=10),
                "call_ms": call_ms(kernel), "plain_ms": library_ms,
                "library_ms": library_ms,
                "library_call_ms": call_ms(library),
                "bound_ms": bound_ms, "bound_by": bound_by, **gaps}
    return out


def int8_conv_operands(name: str, batch: int, generator, device):
    """K9's operands at ``INT8_CONV_SHAPES[name]``: int8 channels-last input
    and packed weights in [-127, 127], float32 scale and bias; and the
    call's (kernel, stride, dilation, pads)."""
    from multimodal_alzheimer_tpu_torch.ops import int8_conv

    c, f, k, stride, dilation, size, _ = INT8_CONV_SHAPES[name]
    x = torch.randint(-127, 128, (batch,) + size + (c,), generator=generator,
                      device=device, dtype=torch.int32).to(torch.int8)
    w = torch.randint(-127, 128, (f, c, k, k, k), generator=generator,
                      device=device, dtype=torch.int32).to(torch.int8)
    scale = torch.rand(f, generator=generator, device=device) * 1e-3
    bias = torch.randn(f, generator=generator, device=device)
    pad = dilation * (k - 1) // 2
    return (x, int8_conv.pack_weight(w), scale, bias,
            ((k, k, k), stride, dilation, ((pad, pad),) * 3))


def int8_fused_operands(x, w, scale, bias, args, mode: str, generator):
    """Keyword arguments of ``int8_conv3d_fused`` for ``INT8_MODES[mode]``
    on K9's operands: a residual of the output's shape (float32 about a
    quarter of the float32 output's largest magnitude, or int8 in [-127,
    127] with the scale of a carrier of that range), and an output scale
    that clamps the largest values, as a calibration on other data would."""
    from multimodal_alzheimer_tpu_torch.ops import int8_conv

    residual, relu, out_i8 = INT8_MODES[mode]
    v = int8_conv.int8_conv3d_fused_plain(x[:1], w, scale, bias, *args)
    amax = max(float(v.abs().max()), 1e-6)
    shape = (x.shape[0],) + tuple(v.shape[1:])
    kw = {"relu": relu, "out_scale": amax / 2 / 127 if out_i8 else None,
          "residual_scale": amax / 127}
    if residual == torch.float32:
        kw["residual"] = torch.randn(shape, generator=generator,
                                     device=x.device) * (amax / 4)
    elif residual == torch.int8:
        kw["residual"] = torch.randint(-127, 128, shape, generator=generator,
                                       device=x.device,
                                       dtype=torch.int32).to(torch.int8)
    return kw


def int8_fused_plain(x, w, scale, bias, args, kw):
    """The plain version of ``int8_conv3d_fused(x, w, scale, bias, *args,
    **kw)``, the output scale's reciprocal rounded as the wrapper rounds
    it."""
    from multimodal_alzheimer_tpu_torch.ops import int8_conv

    out_inv = (None if kw["out_scale"] is None
               else float(np.float32(1.0 / kw["out_scale"])))
    return int8_conv.int8_conv3d_fused_plain(
        x, w, scale, bias, *args, kw.get("residual"),
        float(np.float32(kw["residual_scale"])), kw["relu"], out_inv)


def int8_geometry_operands(name: str, batch: int, generator, device):
    """K9's operands at ``INT8_GEOMETRIES[name]``, as
    ``int8_conv_operands``."""
    from multimodal_alzheimer_tpu_torch.ops import int8_conv

    c, f, kernel, stride, dilation, pads, size = INT8_GEOMETRIES[name]
    x = torch.randint(-127, 128, (batch,) + size + (c,), generator=generator,
                      device=device, dtype=torch.int32).to(torch.int8)
    w = torch.randint(-127, 128, (f, c) + kernel, generator=generator,
                      device=device, dtype=torch.int32).to(torch.int8)
    scale = torch.rand(f, generator=generator, device=device) * 1e-3
    bias = torch.randn(f, generator=generator, device=device)
    return (x, int8_conv.pack_weight(w), scale, bias,
            (kernel, stride, dilation, pads))


def int8_conv_bound(name: str, batch: int, mode: str = "f32") -> tuple:
    """K9's bound: 2 M F K operations on the int8 tensor cores, or the
    input and weights read once (int8), scale and bias, the residual read
    once and the output written once (4 bytes a value in float32, 1 in
    int8), over the HBM rate; whichever is larger."""
    from multimodal_alzheimer_tpu_torch.ops import int8_conv

    c, f, k, stride, dilation, size, _ = INT8_CONV_SHAPES[name]
    residual, _, out_i8 = INT8_MODES[mode]
    pad = dilation * (k - 1) // 2
    out = int8_conv.output_size(size, (k, k, k), stride, dilation,
                                ((pad, pad),) * 3)
    m = batch * float(np.prod(out))
    kk = float(c * k ** 3)
    ops = 2.0 * m * f * kk
    per_value = ((1 if out_i8 else 4)
                 + {None: 0, torch.int8: 1, torch.float32: 4}[residual])
    nbytes = (batch * float(np.prod(size)) * c + f * kk + 8 * f
              + per_value * m * f)
    by_ops, by_bytes = ops / INT8_OPS_PER_MS, nbytes / HBM_BYTES_PER_MS
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                             "bytes")


def int_mm_gemm(name: str, batch: int, generator, device):
    """K9's GEMM alone, as one PyTorch call: ``torch._int_mm`` of random
    int8 im2col columns (M, K_pad) by the packed weights' transpose
    (K_pad, F), int32 out. The same M, N and K as the convolution, not the
    same function (no gather, no epilogue): a yardstick for the mainloop."""
    from multimodal_alzheimer_tpu_torch.ops import int8_conv

    c, f, k, stride, dilation, size, _ = INT8_CONV_SHAPES[name]
    pad = dilation * (k - 1) // 2
    out = int8_conv.output_size(size, (k, k, k), stride, dilation,
                                ((pad, pad),) * 3)
    m = batch * int(np.prod(out))
    kk = int8_conv.padded_k(c * k ** 3)
    a = torch.randint(-127, 128, (m, kk), generator=generator, device=device,
                      dtype=torch.int32).to(torch.int8)
    w = torch.randint(-127, 128, (f, kk), generator=generator, device=device,
                      dtype=torch.int32).to(torch.int8)
    return [lambda: torch._int_mm(a, w.t())]


def time_int8_conv(name: str, batch: int, generator, device,
                   plain: bool = True, mode: str = "f32") -> dict:
    """K9 at ``INT8_CONV_SHAPES[name]``, batch ``batch``, epilogue mode
    ``mode`` (``INT8_MODES``; anything but "f32" needs a port with
    ``int8_conv3d_fused``): its output held to the plain version's on the
    same operands (``equal``, bit for bit, and ``max_abs_err``), device and
    per-call ms, the plain version's ms (float64 convolution; None unless
    ``plain``), the bound, and in mode "f32" ``library_ms``, the GEMM of
    the same M, N, K alone through ``torch._int_mm`` (``int_mm_gemm``: not
    the same function), and as context cuDNN's bfloat16 ``F.conv3d`` of
    the same shape (not the same function either). The input is cycled
    past the L2, the weights are not."""
    from multimodal_alzheimer_tpu_torch.ops import int8_conv

    x, w, scale, bias, args = int8_conv_operands(name, batch, generator,
                                                 device)
    if mode == "f32":
        kw = {}

        def call(xc):
            return int8_conv.int8_conv3d(xc, w, scale, bias, *args)

        def plain_call():
            return int8_conv.int8_conv3d_plain(x, w, scale, bias, *args)
    else:
        kw = int8_fused_operands(x, w, scale, bias, args, mode, generator)

        def call(xc):
            return int8_conv.int8_conv3d_fused(xc, w, scale, bias, *args,
                                               **kw)

        def plain_call():
            return int8_fused_plain(x, w, scale, bias, args, kw)
    got, want = call(x), plain_call()
    equal = got.dtype == want.dtype and torch.equal(got, want)
    max_abs_err = float((got.float() - want.float()).abs().max())
    del got, want
    copies = [x] + [x.clone() for _ in range(n_copies(x.numel()) - 1)]
    kernel = [lambda xc=xc: call(xc) for xc in copies]
    bound_ms, bound_by = int8_conv_bound(name, batch, mode)
    r = {"mode": mode, "equal": equal, "max_abs_err": max_abs_err,
         "ms": device_ms(kernel), "call_ms": call_ms(kernel),
         "plain_ms": (device_ms([plain_call], launches=3, reps=3,
                                spin=False) if plain else None),
         "library_ms": None, "library_call_ms": None, "cudnn_bf16_ms": None,
         "bound_ms": bound_ms, "bound_by": bound_by}
    del kw
    if mode == "f32":
        gemm = int_mm_gemm(name, batch, generator, device)
        r["library_ms"], r["library_call_ms"] = device_ms(gemm), call_ms(gemm)
        del gemm
        c = x.shape[-1]
        xb = x.permute(0, 4, 1, 2, 3).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last_3d)
        wb = int8_conv.unpack_weight(w, args[0], c).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
        pad = args[3][0][0]
        r["cudnn_bf16_ms"] = device_ms([
            lambda: torch.nn.functional.conv3d(xb, wb, None, args[1], pad,
                                               args[2])])
    return r


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def row_line(label: str, what: str, r: dict) -> str:
    library = ("none" if r["library_ms"] is None else
               f"{r['library_ms']:.4f} ms (per call "
               f"{r['library_call_ms']:.4f})")
    plain = ("not timed" if r["plain_ms"] is None
             else f"{r['plain_ms']:.4f} ms")
    return (f"[{label}] {what}: kernel {r['ms']:.4f} ms (per call "
            f"{r['call_ms']:.4f}), plain {plain}, library "
            f"{library}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parents[2]),
                        help="checkout whose port to import")
    parser.add_argument("--label", default="kernels")
    parser.add_argument("--out", default=None, help="JSON file to write")
    parser.add_argument("--kernels", default=",".join(
        NORM_KERNELS + BN_KERNELS + ("maxpool_bwd", "int8_conv3d",
                                     "narrow_conv3d") + TP_KERNELS),
        help="comma-separated kernels to time")
    parser.add_argument("--bn-dtypes", default="float32,bfloat16",
                        help="activation dtypes of the BatchNorm kernels")
    parser.add_argument("--k8-slabs", action="store_true",
                        help="time K8 at every slab depth of K8_SLABS at "
                        "the [tp] windows and the stem")
    args = parser.parse_args()
    chosen = args.kernels.split(",")
    bn_dtypes = [getattr(torch, d) for d in args.bn_dtypes.split(",")]
    if not torch.cuda.is_available():
        print("kernel_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from multimodal_alzheimer_tpu_torch.ops import _native

    print(f"[{args.label}] port from {_native.__file__}", flush=True)
    _native.library()
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(5)
    rows = []
    norm = tuple(k for k in NORM_KERNELS if k in chosen)
    for batch in NORM_BATCHES if norm else ():
        times = time_norm(batch, gen, device, norm)
        for kernel in norm:
            rows.append({"kernel": kernel, "shape": f"B={batch}",
                         "dims": (batch,) + GRID, **times[kernel]})
            print(row_line(args.label, f"{kernel} B={batch} {GRID}",
                           times[kernel]), flush=True)
    bn = tuple(k for k in BN_KERNELS if k in chosen)
    for dtype in bn_dtypes if bn else ():
        for name, shape in BN_SHAPES.items():
            times = time_bn(shape, gen, device, bn, dtype)
            for kernel in bn:
                rows.append({"kernel": kernel, "shape": name, "dims": shape,
                             "dtype": str(dtype), **times[kernel]})
                print(row_line(args.label, f"{kernel} {name} {shape} "
                               f"{dtype}", times[kernel]), flush=True)
    for dtype in (torch.float32, torch.bfloat16) if "maxpool_bwd" in chosen \
            else ():
        r = time_pool(*pool_operands(STEM, dtype, gen, device))
        rows.append({"kernel": "maxpool_bwd", "shape": "stem", "dims": STEM,
                     "dtype": str(dtype), **r})
        print(row_line(args.label, f"maxpool_bwd stem {STEM} {dtype}", r),
              flush=True)
    if any(k in chosen for k in TP_KERNELS):
        for name, r in time_tp(gen, device).items():
            kernel = name.split()[0]
            if kernel not in chosen and not (
                    kernel == "maxpool_bwd" and "maxpool_bwd_window"
                    in chosen):
                continue
            rows.append({"kernel": name, "shape": "tp", **r})
            extra = "".join(f", {key} {r[key]}" for key in
                            ("empty_ms", "blocks", "plan") if r.get(key))
            print(row_line(args.label, f"{name} tp {r['dims']}", r) + extra,
                  flush=True)
    if args.k8_slabs:
        for r in time_k8_slabs(gen, device):
            rows.append({"kernel": "maxpool_bwd slabs", **r})
            print(f"[{args.label}] K8 slab {r['case']} {r['dtype']} "
                  f"{r['slab']}: {r['ms']:.4f} ms, equal {r['equal']}"
                  + (f" (plan {r['plan']})" if r["slab"] == "chosen"
                     else ""), flush=True)
    if "narrow_conv3d" in chosen:
        step = {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        for layer in NARROW_LAYERS:
            for direction, r in time_narrow(layer, gen, device).items():
                rows.append({"kernel": f"narrow_conv3d {direction}",
                             "shape": layer, **r})
                print(row_line(args.label, f"narrow_conv3d {direction} "
                               f"{layer} {r['shape']} {r['dims']}", r)
                      + f", share {r['bound_ms'] / r['ms']:.3f}, relative "
                      f"L2 distance to cuDNN {r['rel_l2']:.3g}", flush=True)
                for key in step:
                    step[key] += NARROW_CALLS_PER_STEP * r[key]
        print(f"[{args.label}] narrow_conv3d a stage-3 step (two PET towers "
              f"at B={NARROW_BATCH}): kernel {step['ms']:.4f} ms, cuDNN "
              f"{step['library_ms']:.4f} ms, bound {step['bound_ms']:.4f} ms",
              flush=True)
    from multimodal_alzheimer_tpu_torch.ops import int8_conv

    fused = hasattr(int8_conv, "int8_conv3d_fused")
    for batch in NORM_BATCHES if "int8_conv3d" in chosen else ():
        total = {"f32": 0.0, "graph": 0.0, "bound_f32": 0.0,
                 "bound_graph": 0.0}
        for name in INT8_CONV_SHAPES:
            count = INT8_CONV_SHAPES[name][-1]
            modes = ["f32"] + ([m for m in INT8_FORWARD[name] if m != "f32"]
                               if fused else [])
            for mode in modes:
                r = time_int8_conv(name, batch, gen, device,
                                   plain=batch == NORM_BATCHES[0], mode=mode)
                rows.append({"kernel": "int8_conv3d", "shape": name,
                             "batch": batch, **r})
                extra = ("" if r["cudnn_bf16_ms"] is None else
                         f", cuDNN bf16 {r['cudnn_bf16_ms']:.4f} ms")
                print(row_line(args.label, f"int8_conv3d {name} B={batch} "
                               f"{mode}", r) + extra
                      + f", equal to plain {r['equal']}", flush=True)
                if mode == "f32":
                    total["f32"] += count * r["ms"]
                    total["bound_f32"] += count * r["bound_ms"]
                graph = INT8_FORWARD[name].get(mode, 0) if fused else (
                    count if mode == "f32" else 0)
                total["graph"] += graph * r["ms"]
                total["bound_graph"] += graph * r["bound_ms"]
        print(f"[{args.label}] int8_conv3d one ResNet-18 forward B={batch}: "
              f"20 convs in float32-out mode {total['f32']:.4f} ms (bound "
              f"{total['bound_f32']:.4f}); in the graph's modes "
              f"{total['graph']:.4f} ms (bound {total['bound_graph']:.4f})",
              flush=True)
    card = nvidia_smi()
    print(f"[{args.label}] {card}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"label": args.label, "card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
