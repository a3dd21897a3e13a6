"""Device times of the BatchNorm kernels (K4-K7) and the stem max-pool
backward (K8), with their plain versions and torch's call for the same
function, at the shapes of the flagship ResNet-18 train path.

    python3 multimodal_alzheimer_tpu_torch/tools/kernel_times.py \
        [--root DIR] [--label NAME] [--out FILE]

It imports ``multimodal_alzheimer_tpu_torch`` from ``--root`` (default: the
checkout that holds this file) and calls only its public wrappers
(``hopper_bn.bn_*``, ``hopper_maxpool.max_pool3d_backward``), so one command
on one card can time two checkouts' kernels in turns: A, B, B, A, each in a
process of its own. It prints one line per kernel, shape and dtype, then the
card's name and power limit, and writes the rows as JSON to ``--out``.
``chip_smoke.py`` takes its BatchNorm and K8 times from the same functions.

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
# The stem pool's input at 91x109x91, batch 8 (NCDHW).
STEM = (8, 64, 46, 55, 46)
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


def bn_bounds(shape) -> dict:
    """Per kernel: each input read once, each output written once (4-byte
    floats), and its f32 operations per element."""
    elems = float(np.prod(shape))
    c = shape[1]
    #        (full tensors moved, (C,) vectors moved, flops per element)
    counts = {"bn_stats": (1, 2, 3), "bn_apply": (2, 4, 4),
              "bn_grad_sum": (2, 4, 5), "bn_dx": (3, 5, 6)}
    return {k: bound(4 * (t * elems + v * c), f * elems)
            for k, (t, v, f) in counts.items()}


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


def bn_operands(shape, generator, device):
    c = shape[1]
    x = torch.randn(shape, generator=generator, device=device) * 2 + 0.5
    g = torch.randn(shape, generator=generator, device=device)
    scale = torch.rand(c, generator=generator, device=device) + 0.5
    bias = torch.randn(c, generator=generator, device=device)
    return x, g, scale, bias


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


def bn_calls(shape, generator, device) -> dict:
    """Per BatchNorm kernel: (kernel, plain, library) lists of calls, one
    per copy of the operands; and F.batch_norm's (forward, backward)."""
    from multimodal_alzheimer_tpu_torch.ops import hopper_bn

    x, g, scale, bias = bn_operands(shape, generator, device)
    mean, inv, red = bn_chain(x, g)
    n = x.numel() // shape[1]
    count = torch.tensor([n], dtype=torch.int32, device=device)
    sum_dy, sum_dy_xmu = torch.batch_norm_backward_reduce(
        g, x, mean, inv, scale, True, True, True)[:2]
    copies = [(x, g)] + [(x.clone(), g.clone()) for _ in range(
        n_copies(2 * 4 * x.numel()) - 1)]

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


def time_bn(shape, generator, device, kernels=BN_KERNELS) -> dict:
    """Per BatchNorm kernel at ``shape``: device and per-call ms of the
    kernel and the library call, the plain version's ms, and the bound;
    and F.batch_norm's forward and backward device ms."""
    calls = bn_calls(shape, generator, device)
    bounds = bn_bounds(shape)
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


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def row_line(label: str, what: str, r: dict) -> str:
    return (f"[{label}] {what}: kernel {r['ms']:.4f} ms (per call "
            f"{r['call_ms']:.4f}), plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms (per call {r['library_call_ms']:.4f})"
            f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parents[2]),
                        help="checkout whose port to import")
    parser.add_argument("--label", default="kernels")
    parser.add_argument("--out", default=None, help="JSON file to write")
    parser.add_argument("--kernels", default=",".join(BN_KERNELS
                                                      + ("maxpool_bwd",)),
                        help="comma-separated kernels to time")
    args = parser.parse_args()
    chosen = args.kernels.split(",")
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
    bn = tuple(k for k in BN_KERNELS if k in chosen)
    for name, shape in BN_SHAPES.items() if bn else ():
        times = time_bn(shape, gen, device, bn)
        for kernel in bn:
            rows.append({"kernel": kernel, "shape": name, "dims": shape,
                         **times[kernel]})
            print(row_line(args.label, f"{kernel} {name} {shape}",
                           times[kernel]), flush=True)
    for dtype in (torch.float32, torch.bfloat16) if "maxpool_bwd" in chosen \
            else ():
        r = time_pool(*pool_operands(STEM, dtype, gen, device))
        rows.append({"kernel": "maxpool_bwd", "shape": "stem", "dims": STEM,
                     "dtype": str(dtype), **r})
        print(row_line(args.label, f"maxpool_bwd stem {STEM} {dtype}", r),
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
