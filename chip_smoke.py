"""Smoke run of the PyTorch port's MRI serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines:
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: compiles csrc/minmax_norm.cu with nvcc for sm_90a;
  3. kernels against their plain PyTorch versions at the real 91x109x91
     grid, batch 8: order statistics equal, apply within 1e-6;
  4. times: at each serving rung (batch 8 and 32) the kernels are held to
     their plain versions again, then both are timed, median of 20 runs
     after 3 warm-ups (CUDA events);
  5. the ResNet-18 AnatCNN (dilated, f32, seeded random weights) on the GPU
     against the same model on the CPU, on 2 raw requests;
  6. serving: 40 raw requests from 4 client threads through BatchingServer
     -> Predictor (rungs 8/32) -> min-max preprocess (the kernels) ->
     AnatCNN, checked against single-sample predict_batch, with the kernels'
     launch counts over the run.
Any failed check raises, so the script exits non-zero without printing its
last line, {"ok": true, "device": {...}}. It needs one card and imports the
port only.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.inference.predictor import Predictor
from multimodal_alzheimer_tpu_torch.inference.server import BatchingServer
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.ops import _native, hopper_norm
from multimodal_alzheimer_tpu_torch.ops.quantile import interpolate
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

GRID = (91, 109, 91)
SEED = 0
QUANTILE = 0.99
MINMAX = {"per_scan_norm": "min_max"}
SOURCE = "multimodal_alzheimer_tpu_torch/csrc/minmax_norm.cu"
REPLACES = {"minmax_select": "multimodal_alzheimer_tpu/ops/pallas_norm.py:263",
            "minmax_apply": "multimodal_alzheimer_tpu/ops/pallas_norm.py:354"}
APPLY_TOL = 1e-6
# GPU (cuDNN, TF32 off) against CPU (oneDNN) sums every conv of 18 layers
# in another order; batch composition changes cuDNN's algorithm choice.
MODEL_TOL = dict(rtol=1e-3, atol=1e-4)
SERVE_TOL = dict(rtol=1e-4, atol=1e-5)
N_REQUESTS, N_CLIENTS = 40, 4


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def phase_environment() -> None:
    log(f"[env] {nvidia_smi()}")
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")


def phase_build() -> None:
    fresh = not _native.library_path().exists()
    start = time.perf_counter()
    _native.library()
    seconds = time.perf_counter() - start
    log(f"[build] {_native.library_path().name} "
        f"{'built' if fresh else 'found'} in {seconds:.2f} s "
        f"(nvcc {' '.join(_native.NVCC_FLAGS)})")
    if fresh:
        for line in _native.build_log_path().read_text().splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


def make_scans(kind: str, batch: int, grid, generator, device):
    """Synthetic volumes on the device: the flagship entry recipe
    (N(900, 400), mask > 0.35), or integer-valued duplicates with
    negatives under a full mask."""
    shape = (batch,) + tuple(grid)
    noise = torch.randn(shape, generator=generator, device=device)
    if kind == "normal":
        mask = torch.rand(shape, generator=generator, device=device) > 0.35
        return noise * 400 + 900, mask.to(torch.float32)
    return torch.round(noise * 4), torch.ones(shape, device=device)


def _rows(vol, mask):
    b = vol.shape[0]
    return vol.reshape(b, -1), mask.reshape(b, -1)


def phase_kernels(device, grid=GRID, batch=8) -> dict:
    """Each kernel against its plain version; returns max abs errors."""
    gen = make_generator(SEED, device)
    err = {"minmax_select": 0.0, "minmax_apply": 0.0}
    for kind in ("normal", "duplicates"):
        vol, mask = make_scans(kind, batch, grid, gen, device)
        for qs in ((0.99, 0.01), (1.0, 0.0)):
            qs_t = torch.tensor(qs, dtype=torch.float32, device=device)
            n, lo, hi = hopper_norm.order_stats(vol, mask, qs)
            n_p, lo_p, hi_p = hopper_norm.order_stats_plain(
                *_rows(vol, mask), qs_t)
            check(torch.equal(n, n_p), f"{kind} {qs}: n")
            check(torch.equal(lo, lo_p) and torch.equal(hi, hi_p),
                  f"{kind} {qs}: order statistics equal")
            quants = interpolate(n, lo, hi, qs_t)
            quants_p = interpolate(n_p, lo_p, hi_p, qs_t)
            err["minmax_select"] = max(err["minmax_select"], (
                quants - quants_p).abs().max().item())
            qmin, qmax = quants_p[:, -1], quants_p[:, 0]
            got = hopper_norm.minmax_apply(vol, mask, qmin, qmax)
            want = hopper_norm.minmax_apply_plain(vol, mask, qmin, qmax)
            e = (got - want).abs().max().item()
            check(e <= APPLY_TOL, f"{kind} {qs}: apply error {e}")
            err["minmax_apply"] = max(err["minmax_apply"], e)
            log(f"[kernels] {kind} qs={qs} B={batch}: order statistics "
                f"equal, quantile err {err['minmax_select']}, apply err {e}")
    vol, mask = make_scans("normal", batch, grid, gen, device)
    mask[batch // 2] = 0.0
    qs = (QUANTILE, 1.0 - QUANTILE)
    qs_t = torch.tensor(qs, dtype=torch.float32, device=device)
    out = hopper_norm.per_scan_minmax(vol, mask, QUANTILE)
    n, lo, hi = hopper_norm.order_stats(vol, mask, qs)
    n_p, lo_p, hi_p = hopper_norm.order_stats_plain(*_rows(vol, mask), qs_t)
    torch.cuda.synchronize()
    keep = torch.arange(batch, device=device) != batch // 2
    check(int(n[batch // 2]) == 0 and torch.equal(lo[keep], lo_p[keep])
          and torch.equal(hi[keep], hi_p[keep]),
          "a scan with no valid voxel leaves the others exact")
    check(bool(torch.isfinite(out[keep]).all()), "finite min-max output")
    log(f"[kernels] batch with an all-zero scan: ran, other scans exact")
    return err


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_times(device, err: dict, batches=(8, 32), grid=GRID) -> dict:
    """Kernel and plain times at each serving rung, after holding the
    kernels to their plain versions at that rung; updates ``err``."""
    gen = make_generator(SEED + 1, device)
    qs = (QUANTILE, 1.0 - QUANTILE)
    qs_t = torch.tensor(qs, dtype=torch.float32, device=device)
    times = {}
    for batch in batches:
        vol, mask = make_scans("normal", batch, grid, gen, device)
        rows = _rows(vol, mask)
        n, lo, hi = hopper_norm.order_stats(vol, mask, qs)
        n_p, lo_p, hi_p = hopper_norm.order_stats_plain(*rows, qs_t)
        check(torch.equal(n, n_p) and torch.equal(lo, lo_p)
              and torch.equal(hi, hi_p), f"B={batch}: order statistics equal")
        quants = interpolate(n_p, lo_p, hi_p, qs_t)
        err["minmax_select"] = max(err["minmax_select"], (
            interpolate(n, lo, hi, qs_t) - quants).abs().max().item())
        qmin, qmax = quants[:, 1].contiguous(), quants[:, 0].contiguous()
        e = (hopper_norm.minmax_apply(vol, mask, qmin, qmax)
             - hopper_norm.minmax_apply_plain(vol, mask, qmin, qmax)
             ).abs().max().item()
        check(e <= APPLY_TOL, f"B={batch}: apply error {e}")
        err["minmax_apply"] = max(err["minmax_apply"], e)
        log(f"[times] B={batch}: order statistics equal, apply err {e}")
        times[batch] = {
            "minmax_select": (
                time_ms(lambda: hopper_norm.order_stats(vol, mask, qs)),
                time_ms(lambda: hopper_norm.order_stats_plain(*rows, qs_t))),
            "minmax_apply": (
                time_ms(lambda: hopper_norm.minmax_apply(vol, mask, qmin,
                                                         qmax)),
                time_ms(lambda: hopper_norm.minmax_apply_plain(
                    vol, mask, qmin, qmax))),
        }
        for name, (k, p) in times[batch].items():
            log(f"[times] {name} B={batch} at {grid}: kernel {k:.4f} ms, "
                f"plain {p:.4f} ms")
        del vol, mask, rows
    return times


def make_requests(n: int, grid, seed: int) -> list:
    """Raw serving requests: ``mri`` and ``mri_mask``, no memoised bounds."""
    rng = np.random.default_rng(seed)
    shape = (n,) + tuple(grid)
    mri = rng.standard_normal(shape, dtype=np.float32) * 400 + 900
    mask = (rng.random(shape, dtype=np.float32) > 0.35).astype(np.float32)
    return [{"mri": mri[i], "mri_mask": mask[i]} for i in range(n)]


def _stack(samples, device=None):
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    if device is None:
        return batch
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def phase_model(device, grid=GRID):
    """The model on the card against the same weights on the CPU."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[model] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    model_cpu = AnatCNN(n_classes=3, resnet_depth=18, dilated=True,
                        generator=make_generator(SEED)).eval()
    model = copy.deepcopy(model_cpu).to(device)
    preprocess = make_device_preprocess(normalize_mri=MINMAX,
                                        quantile=QUANTILE)
    requests = make_requests(2, grid, SEED + 2)
    outs = {}
    for dev, m in ((device, model), ("cpu", model_cpu)):
        with torch.inference_mode():
            start = time.perf_counter()
            x = preprocess(_stack(requests, dev))
            out = m(x)
            logits = out["logits"].cpu().numpy()
            gap = out["embeddings"]["backbone_gap"].cpu().numpy()
            outs[str(dev)] = (x["mri"].cpu().numpy(), logits, gap)
            log(f"[model] {dev}: logits {logits.tolist()} in "
                f"{time.perf_counter() - start:.2f} s")
    (x_gpu, l_gpu, g_gpu), (x_cpu, l_cpu, g_cpu) = outs[str(device)], \
        outs["cpu"]
    e_x = float(np.abs(x_gpu - x_cpu).max())
    check(e_x <= APPLY_TOL, f"preprocessed volumes GPU vs CPU err {e_x}")
    check(np.isfinite(l_gpu).all() and l_gpu.shape == (2, 3),
          "finite (2, 3) logits")
    check(np.allclose(l_gpu, l_cpu, **MODEL_TOL)
          and np.allclose(g_gpu, g_cpu, **MODEL_TOL),
          f"GPU logits {l_gpu} vs CPU {l_cpu} within {MODEL_TOL}, and "
          f"backbone_gap")
    log(f"[model] preprocessed max abs err {e_x}, logits max abs err "
        f"{float(np.abs(l_gpu - l_cpu).max())}, backbone_gap max abs err "
        f"{float(np.abs(g_gpu - g_cpu).max())} (tolerance {MODEL_TOL})")
    return model, preprocess


def phase_serve(model, preprocess, device, grid=GRID) -> dict:
    predictor = Predictor(model, batch_size=32, ladder=(8,), device=device,
                          preprocess=preprocess)
    requests = make_requests(N_REQUESTS, grid, SEED + 3)
    start = time.perf_counter()
    predictor.warmup(_stack(requests[:1]), parts=True)
    log(f"[serve] warmup of rungs {predictor.ladder} in "
        f"{time.perf_counter() - start:.2f} s")

    submitted, done = [0.0] * N_REQUESTS, [0.0] * N_REQUESTS
    futures = [None] * N_REQUESTS

    def client(indices):
        for i in indices:
            submitted[i] = time.perf_counter()
            futures[i] = server.submit(requests[i])
            futures[i].add_done_callback(
                lambda _, i=i: done.__setitem__(i, time.perf_counter()))

    hopper_norm.reset_launches()
    server = BatchingServer(predictor, max_wait_s=0.05)
    try:
        threads = [threading.Thread(target=client,
                                    args=(range(k, N_REQUESTS, N_CLIENTS),))
                   for k in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            check(not t.is_alive(), "client thread finished")
        results = [f.result(timeout=300) for f in futures]
        torch.cuda.synchronize()
        launches = dict(hopper_norm.LAUNCHES)
    finally:
        server.close()
    wall = max(done) - min(submitted)
    latency = [d - s for s, d in zip(submitted, done)]
    log(f"[serve] {N_REQUESTS} requests from {N_CLIENTS} clients: batch "
        f"histogram {dict(sorted(server.batch_histogram.items()))}, "
        f"{N_REQUESTS / wall:.2f} requests/s, p50 latency "
        f"{statistics.median(latency) * 1e3:.1f} ms, launches {launches}")
    check(server.samples_served == N_REQUESTS, "every request served")
    for name, count in launches.items():
        check(count > 0, f"{name} launched during serving")
    for i, result in enumerate(results):
        single = predictor.predict_batch(_stack([requests[i]]))
        for key, got, want in (
                ("logits", result["logits"], single["logits"][0]),
                ("probs", result["probs"], single["probs"][0]),
                ("backbone_gap", result["embeddings"]["backbone_gap"],
                 single["embeddings"]["backbone_gap"][0])):
            check(np.isfinite(got).all() and got.shape == want.shape,
                  f"request {i} {key}: finite, shape {want.shape}")
            check(np.allclose(got, want, **SERVE_TOL),
                  f"request {i} {key} matches single-sample predict_batch")
    check(results[0]["logits"].shape == (3,)
          and results[0]["embeddings"]["backbone_gap"].shape == (512,),
          "per-request shapes (3,) and (512,)")
    log(f"[serve] all {N_REQUESTS} results finite and equal to "
        f"single-sample predict_batch within {SERVE_TOL}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase_environment()
    phase_build()
    err = phase_kernels(device)
    times = phase_times(device, err)
    model, preprocess = phase_model(device)
    launches = phase_serve(model, preprocess, device)
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": err[name], "batch": 8,
                "ms": times[8][name][0], "plain_ms": times[8][name][1]}
               for name in ("minmax_select", "minmax_apply")]
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
