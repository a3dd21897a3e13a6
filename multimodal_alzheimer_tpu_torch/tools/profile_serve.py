"""Where the serving step's device time goes, on one NVIDIA GPU.

    python3 -m multimodal_alzheimer_tpu_torch.tools.profile_serve [--out DIR]

Serves staged raw 91x109x91 requests (``mri`` + ``mri_mask``, no memoised
bounds) through ``Predictor.predict_parts``: the ResNet-18 ``AnatCNN``
(dilated, float32, TF32 off, random weights from a seed) behind the min-max
preprocess, whose quantiles and apply run in the two CUDA kernels. Three
cases: rung 8 with 1 real sample (a lone request), rung 8 with 8, rung 32
with 32. Each case is warmed up, then runs ``CALLS`` back-to-back calls
under ``torch.profiler``, each call inside a ``record_function`` span.
Per case it reports:

* ``host_ms``: the span of one call (staged inputs in, numpy out, so it
  includes the device-to-host copy and the synchronisation);
* ``busy_ms``: the union of every kernel, memcpy and memset interval inside
  that span (CUPTI timestamps, on the host spans' clock);
* ``idle_share``: 1 - busy / span, over all calls;
* ``share``: device busy time by kind: ``conv_gemm`` (cuDNN/cuBLAS),
  ``K1`` (the radix select's kernels), ``K2`` (the apply kernel),
  ``pooling``, ``memory`` (copies and sets) and ``other`` (BatchNorm, ReLU,
  residual adds, reductions, softmax);
* ``conv_tflops``: 2 x the MACs of every ``Conv3d`` (counted by forward
  hooks on the real shapes, padding rows included) over the ``conv_gemm``
  device time;
* ``kernels_ms``: device ms per call of each kernel name, largest first.

Medians are over calls. It prints one line per case and the card's name and
power limit, and writes ``profile_serve.json`` and each case's Chrome trace
under ``--out`` (default ``profile_out/``). The profiler adds host time to
every launch, so ``host_ms`` and ``idle_share`` here read above an
unprofiled run; ``chip_smoke.py`` times the kernels without it.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.inference.predictor import Predictor
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

GRID = (91, 109, 91)
CASES = ((8, 1), (8, 8), (32, 32))  # (rung, real samples)
CALLS = 5
SEED = 0
K1_KERNELS = ("keys_kernel", "init_targets_kernel", "digit_hist_kernel",
              "digit_pick_kernel", "neighbour_kernel", "finish_kernel")
K2_KERNELS = ("minmax_apply_kernel",)
CONV_WORDS = ("conv", "fprop", "implicit", "gemm", "xmma", "winograd")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = "serve_call"


def kind(event: dict) -> str:
    """The kind of one device event of a Chrome trace."""
    name = event["name"]
    if event["cat"] != "kernel":
        return "memory"
    if any(k in name for k in K1_KERNELS):
        return "K1"
    if any(k in name for k in K2_KERNELS):
        return "K2"
    low = name.lower()
    if any(w in low for w in CONV_WORDS):
        return "conv_gemm"
    if "pool" in low:
        return "pooling"
    return "other"


def union_ms(intervals) -> float:
    """Total length of the union of (start, end) intervals, us -> ms."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1e3


def breakdown(trace: dict, calls: int, span: str = SPAN,
              classify=kind) -> dict:
    """Per-call host span, device busy time and time by kind
    (``classify`` of each device event), over the ``span`` annotations."""
    events = trace["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("name") == span and e.get("cat") ==
                   "user_annotation")
    if len(spans) != calls:
        raise RuntimeError(f"found {len(spans)} '{span}' spans, "
                           f"expected {calls}")
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and "dur" in e]
    if not device:
        raise RuntimeError("the trace holds no device events")
    host_ms, busy_ms = [], []
    by_kind, by_name = {}, {}
    for s, e in spans:
        inside = [(max(d["ts"], s), min(d["ts"] + d["dur"], e), d)
                  for d in device if d["ts"] < e and d["ts"] + d["dur"] > s]
        host_ms.append((e - s) / 1e3)
        busy_ms.append(union_ms((a, b) for a, b, _ in inside))
        for a, b, d in inside:
            k = classify(d)
            by_kind[k] = by_kind.get(k, 0.0) + (b - a) / 1e3
            by_name[d["name"]] = by_name.get(d["name"], 0.0) + (b - a) / 1e3
    kind_total = sum(by_kind.values())
    return {
        "host_ms": host_ms,
        "busy_ms": busy_ms,
        "idle_share": 1.0 - sum(busy_ms) / sum(host_ms),
        "share": {k: v / kind_total for k, v in sorted(by_kind.items())},
        "kind_ms": {k: v / calls for k, v in sorted(by_kind.items())},
        "kernels_ms": dict(sorted(((n, v / calls) for n, v in
                                   by_name.items()),
                                  key=lambda kv: -kv[1])),
    }


def conv_macs(model: torch.nn.Module, run) -> int:
    """MACs of every Conv3d in one call of ``run``."""
    macs = [0]

    def hook(module, _, out):
        macs[0] += out.numel() * (module.in_channels // module.groups) * \
            math.prod(module.kernel_size)

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv3d)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return macs[0]


def requests(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    shape = (n,) + GRID
    mri = rng.standard_normal(shape, dtype=np.float32) * 400 + 900
    mask = (rng.random(shape, dtype=np.float32) > 0.35).astype(np.float32)
    return [{"mri": mri[i], "mri_mask": mask[i]} for i in range(n)]


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="profile_out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs an NVIDIA GPU")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    model = AnatCNN(n_classes=3, resnet_depth=18, dilated=True,
                    generator=make_generator(SEED)).eval()
    predictor = Predictor(
        model, batch_size=32, ladder=(8,), device=device,
        preprocess=make_device_preprocess(
            normalize_mri={"per_scan_norm": "min_max"}, quantile=0.99))
    staged = [predictor.stage_sample(r)
              for r in requests(32, SEED + 1)]
    smi = nvidia_smi()
    report = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "grid": GRID,
              "calls": CALLS, "cases": []}
    for rung, n in CASES:
        parts = staged[:n]
        for _ in range(3):
            predictor.predict_parts(parts)
        macs = conv_macs(predictor.model,
                         lambda: predictor.predict_parts(parts))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                with record_function(SPAN):
                    predictor.predict_parts(parts)
        trace_path = out / f"profile_serve_rung{rung}_n{n}.json"
        prof.export_chrome_trace(str(trace_path))
        case = breakdown(json.loads(trace_path.read_text()), CALLS)
        conv_ms = case["kind_ms"].get("conv_gemm")
        if not conv_ms:
            raise RuntimeError(f"no convolution kernel among "
                               f"{list(case['kernels_ms'])[:10]}")
        case.update(rung=rung, samples=n, conv_gflop=2 * macs / 1e9,
                    conv_tflops=(2 * macs / 1e12) / (conv_ms / 1e3),
                    trace=str(trace_path))
        report["cases"].append(case)
        shares = ", ".join(f"{k} {v:.4f}" for k, v in case["share"].items())
        print(f"[profile] rung {rung} ({n} real): host "
              f"{statistics.median(case['host_ms']):.3f} ms/call, device "
              f"busy {statistics.median(case['busy_ms']):.3f} ms/call, idle "
              f"share {case['idle_share']:.4f}; {shares}; conv "
              f"{case['conv_gflop']:.1f} GFLOP at "
              f"{case['conv_tflops']:.2f} TFLOP/s", flush=True)
    (out / "profile_serve.json").write_text(json.dumps(report, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
