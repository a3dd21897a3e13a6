"""Smoke run of the PyTorch port on one NVIDIA GPU: MRI serving, training and
the entry points from NIfTI files on disk, and the PET family with the stem
max-pool backward kernel.

    python3 chip_smoke.py

Phases, each printing its lines:
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: compiles csrc/minmax_norm.cu, csrc/batch_norm.cu,
     csrc/zscore_norm.cu and csrc/maxpool_bwd.cu with nvcc for sm_90a, one
     process per source, all started together, into one library; prints
     ptxas register counts;
  3. min-max kernels against their plain PyTorch versions at the real
     91x109x91 grid, batch 8: order statistics equal, apply within 1e-6;
  4. min-max times: at each serving rung (batch 8 and 32) the kernels are
     held to their plain versions again, then both are timed, median of 20
     runs after 3 warm-ups (CUDA events);
  5. BatchNorm kernels against their plain versions at the ResNet-18 stem
     (8, 64, 46, 55, 46) and layer4 (8, 512, 12, 14, 12) shapes: sums within
     1e-6 of the sum of magnitudes, apply and dx equal; batch_norm_train
     forward and backward against F.batch_norm(training=True) and autograd;
     then kernel, plain and library times at both shapes (median of 20);
  6. the ResNet-18 AnatCNN (dilated, f32, seeded random weights) on the GPU
     against the same model on the CPU, on 2 raw requests;
  7. serving: 40 raw requests from 4 client threads through BatchingServer
     -> Predictor (rungs 8/32) -> min-max preprocess (the kernels) ->
     AnatCNN, checked against single-sample predict_batch, with the kernels'
     launch counts over the run;
  8. a train step at full width: ResNet-18 AnatCNN, batch 8 of raw scans
     preprocessed in the step, from the same weights once with
     fused_bn="full" (the BatchNorm kernels) and once with fused_bn=False;
     loss and every parameter's gradient norm must agree, and the fused
     step must launch each BatchNorm kernel 20 times and K1+K2 once; then
     both steps are timed;
  9. training: Trainer.fit, one epoch over 16 training and 8 validation
     scans at batch 8 with fused_bn="full", from a DataLoader on the card,
     with its launch counts; a top-k checkpoint is loaded back;
 10. the z-score kernel (K3) against its plain version at batch 8 and 32,
     on N(900, 400) and N(900, 40) scans, with a scan that has no valid
     voxel and one with a single valid voxel: within 1e-5 * (1 + |plain|),
     NaN where the plain version has NaN; then kernel and plain times at
     both batches (median of 20 after 3 warm-ups);
 11. the flagship z-score train step (bench.py's configuration in f32):
     ResNet-18, 3 classes, batch 8 of raw scans z-scored in the step, one
     K3 launch per step, finite loss, step ms;
 12. the max-pool backward kernel (K8) against its plain version at the
     ResNet-18 stem (8, 64, 46, 55, 46), float32 and bfloat16, on ReLU-zero
     ties: equal; against aten's max_pool3d_with_indices_backward on
     NaN-free inputs: within 1e-6 (float32) and 1/32 (bfloat16) of the sum
     of the magnitudes of the credited terms (the adds run in another
     order); then kernel, plain and library times (median of 20 after 3
     warm-ups) beside the bound;
 13. a full-width PETResNetCNN train step (ResNet-18 dilated, batch 8 of PET
     volumes z-scored in the step, f32) from the same weights with
     maxpool_impl="wf" (K8 once per step) and "xla": loss and every gradient
     norm within the train step's tolerance; both steps timed;
 14. a full-width SmallPETCNN train step: ladder (8, 16, 32), BatchNorm and
     dropout on, batch 8: finite loss, step ms;
 15. the entry points from disk: a synthetic split at 91x109x91 written by
     the port into a temporary directory (MMALZ_DATA_DIR, and the CWD),
     then train_anat for one epoch (memoised min-max: K2 alone in the
     step), run_training with the z-score (K3 in every train and
     validation step) for one epoch, and test_anat_cnn.main() on the best
     train_anat checkpoint over the paired three-modality test split, each
     with its launch counts, finite metrics and the checkpoint loaded back;
 16. the PET entry points on phase 15's split: train_pet_cnn.train and
     train_pet_resnet_cnn.train for one epoch each and test_pet_cnn.main()
     on the best train_pet_cnn checkpoint, with finite metrics, the
     checkpoints loaded back, and the PET training rows counted by class.
Any failed check raises, so the script exits non-zero without printing its
last line, {"ok": true, "device": {...}}. It needs one card and imports the
port only, and neither pandas, yaml nor the plotting packages: no confusion
image is rendered.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from multimodal_alzheimer_tpu_torch.data.pipeline import DataLoader
from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.data.synthetic import (
    ArrayDataset,
    make_labeled_volumes,
    write_synthetic_split,
)
from multimodal_alzheimer_tpu_torch.inference import (
    harness,
    test_anat_cnn,
    test_pet_cnn,
)
from multimodal_alzheimer_tpu_torch.inference.predictor import Predictor
from multimodal_alzheimer_tpu_torch.inference.server import BatchingServer
from multimodal_alzheimer_tpu_torch.losses.classification import (
    make_criterion,
)
from multimodal_alzheimer_tpu_torch.models.mri_models import train_anat_cnn
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.models.pet_models import (
    train_pet_cnn,
    train_pet_resnet_cnn,
)
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
    SmallPETCNN,
)
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_resnet_cnn import (
    PETResNetCNN,
)
from multimodal_alzheimer_tpu_torch.ops import (
    _native,
    hopper_bn,
    hopper_maxpool,
    hopper_norm,
)
from multimodal_alzheimer_tpu_torch.ops.maxpool import (
    NO_WINNER,
    max_pool3d_backward_plain,
    pool_forward,
    winner_offsets,
)
from multimodal_alzheimer_tpu_torch.ops.quantile import interpolate
from multimodal_alzheimer_tpu_torch.train.checkpoint import load_checkpoint
from multimodal_alzheimer_tpu_torch.train.driver import (
    attach_class_weights,
    build_datasets,
    run_training,
)
from multimodal_alzheimer_tpu_torch.train.logging import ExperimentLogger
from multimodal_alzheimer_tpu_torch.train.loop import Trainer
from multimodal_alzheimer_tpu_torch.train.optim import (
    build_optimizer,
    head_pretrained_label_fn,
    single_lr_optimizer,
)
from multimodal_alzheimer_tpu_torch.train.state import (
    TrainState,
    make_train_step,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

GRID = (91, 109, 91)
SEED = 0
QUANTILE = 0.99
MINMAX = {"per_scan_norm": "min_max"}
ZSCORE = {"per_scan_norm": "normalize"}
CSRC = "multimodal_alzheimer_tpu_torch/csrc/"
SOURCE = {"minmax_select": CSRC + "minmax_norm.cu",
          "minmax_apply": CSRC + "minmax_norm.cu",
          "zscore": CSRC + "zscore_norm.cu",
          "bn_stats": CSRC + "batch_norm.cu", "bn_apply": CSRC + "batch_norm.cu",
          "bn_grad_sum": CSRC + "batch_norm.cu", "bn_dx": CSRC + "batch_norm.cu",
          "maxpool_bwd": CSRC + "maxpool_bwd.cu"}
REPLACES = {"minmax_select": "multimodal_alzheimer_tpu/ops/pallas_norm.py:263",
            "minmax_apply": "multimodal_alzheimer_tpu/ops/pallas_norm.py:354",
            "zscore": "multimodal_alzheimer_tpu/ops/pallas_norm.py:63",
            "bn_stats": "multimodal_alzheimer_tpu/ops/pallas_bn.py:62",
            "bn_apply": "multimodal_alzheimer_tpu/ops/pallas_bn.py:75",
            "bn_grad_sum": "multimodal_alzheimer_tpu/ops/pallas_bn.py:82",
            "bn_dx": "multimodal_alzheimer_tpu/ops/pallas_bn.py:96",
            "maxpool_bwd": "multimodal_alzheimer_tpu/ops/pallas_maxpool.py:98"}
BN_KERNELS = ("bn_stats", "bn_apply", "bn_grad_sum", "bn_dx")
NORM_KERNELS = ("minmax_select", "minmax_apply", "zscore")
APPLY_TOL = 1e-6
# The z-score kernel against its plain version: |kernel - plain| <= ZSCORE_TOL
# * (1 + |plain|), NaN where the plain version has NaN. The kernel sums the
# statistics in double in another order, so the mean and std it rounds to
# f32 may differ from the plain version's by an ulp or two.
ZSCORE_TOL = 1e-5
# BatchNorm shapes of ResNet-18 (dilated) at 91x109x91, batch 8.
BN_SHAPES = {"stem": (8, 64, 46, 55, 46), "layer4": (8, 512, 12, 14, 12)}
BN_EPS = 1e-5
# Per-channel sums: |kernel - plain| <= SUM_TOL * sum of |terms| (the order
# of summation differs). batch_norm_train against F.batch_norm + autograd:
# y and dx within BN_TOL; dscale and dbias, sums of n terms of order 1,
# within rtol 1e-4 and atol 1e-6 n.
SUM_TOL = 1e-6
BN_TOL = dict(rtol=1e-4, atol=1e-5)
# One H100 SXM: 3.35 TB/s of HBM, 67 TFLOP/s f32 outside the tensor cores.
HBM_BYTES_PER_MS = 3.35e9
F32_FLOP_PER_MS = 67e9
# The flagship training configuration; each phase sets fused_bn.
TRAIN_HPARAMS = {"n_classes": 2, "resnet_depth": 18, "linear_out": (),
                 "lr": 1e-3, "lr_pretrained": 1e-5, "l2_reg": 1e-2,
                 "batch_size": 8, "max_epochs": 1}
BN_LAYERS = 20  # BatchNorms in the ResNet-18 backbone
# fused_bn="full" against fused_bn=False after one step from the same
# weights. Layer by layer both BatchNorms are within 2e-6 (variance) and
# 6e-7 (gradients) of float64 (tools/bn_precision.py), but the step
# amplifies any 1e-7 difference:
# ReLU signs and max-pool winners near a tie flip, and the earliest layers'
# gradients follow. The train-step phase measures that floor as False
# against False with the raw scans moved by one ulp (5.9e-4 of a gradient
# norm on an H100, as much as "full" against False); the tolerance is about
# 3x it.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_TOL = dict(rtol=2e-3, atol=1e-6)
# GPU (cuDNN, TF32 off) against CPU (oneDNN) sums every conv of 18 layers
# in another order; batch composition changes cuDNN's algorithm choice.
MODEL_TOL = dict(rtol=1e-3, atol=1e-4)
SERVE_TOL = dict(rtol=1e-4, atol=1e-5)
N_REQUESTS, N_CLIENTS = 40, 4
# The flagship z-score train step (bench.py build_step, in f32).
ZSCORE_HPARAMS = {"n_classes": 3, "resnet_depth": 18, "linear_out": (),
                  "batchnorm_begin": False, "lr": 1e-3,
                  "loss_class_weights": [0.4, 0.3, 0.3]}
# The split the entry points read: n_subjects (8, 4, 4) from seed 10 at
# 91x109x91 holds 15 training and 6 validation T1w rows of both binary
# classes and 5 paired three-modality test rows. (A training split of one
# class gives that class the weight 1 - 1 = 0, and the weighted loss of a
# batch of it is 0/0, as in the reference.)
SPLIT = {"n_subjects": (8, 4, 4), "seed": 10}
# A fixed trial for train_anat_cnn.sample_hparams: ResNet-18, batch 8.
TRIAL = {"lr": 1e-3, "freeze": False, "lr_pretrained": 1e-5,
         "batchnorm_begin": False, "batchnorm_dense": False, "batch_size": 8,
         "l2_reg": 1e-2, "norm_percentile": 0.99, "fl_gamma": None,
         "resnet_depth": 18, "linear_out": "()"}
# The stem pool's input in ResNet-18 at 91x109x91, batch 8 (NCDHW).
STEM = (8, 64, 46, 55, 46)
# K8 against aten's max_pool3d_with_indices_backward, which adds with
# atomics in another order: |kernel - aten| <= tol * (sum of |g| over the
# credited windows). At most 8 adds per element on each side, each rounding
# by at most 2^-24 (float32) or 2^-9 (bfloat16) of that sum.
POOL_LIBRARY_TOL = {torch.float32: 1e-6, torch.bfloat16: 1.0 / 32}
# The PET z-score constants of both PET entry points.
PET_NORM = {"mean": 0.5145, "std": 0.5383}
PET_RESNET_HPARAMS = {"n_classes": 2, "resnet_depth": 18, "linear_out": (),
                      "lr": 1e-3, "lr_pretrained": 1e-5, "l2_reg": 1e-2,
                      "batch_size": 8}
# A SmallPETCNN trial for train_pet_cnn.sample_hparams and the full-width
# step: the first conv_out ladder, its filter sizes, BatchNorm and both
# dropouts on, batch 8.
PET_TRIAL = {"learning_rate": 1e-4, "conv_out": "(8, 16, 32)",
             "filter_size": "(5, 5, 3, 3)", "batchnorm": True,
             "linear_out": 64, "batch_size": 8, "dropout_conv": True,
             "dropout_conv_p": 0.1, "dropout_dense": True,
             "dropout_dense_p": 0.3, "fl_gamma": None}


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
        f"(nvcc {' '.join(_native.COMPILE_FLAGS)}, one process per source: "
        f"{', '.join(src.name for src in _native.SOURCES)})")
    if fresh:
        for line in _native.build_log_path().read_text().splitlines():
            if "entry function" in line or "Used" in line:
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


def bn_operands(shape, generator, device):
    c = shape[1]
    x = torch.randn(shape, generator=generator, device=device) * 2 + 0.5
    g = torch.randn(shape, generator=generator, device=device)
    scale = torch.rand(c, generator=generator, device=device) + 0.5
    bias = torch.randn(c, generator=generator, device=device)
    return x, g, scale, bias


def _rows3(t):
    return t.reshape(t.shape[0], t.shape[1], -1)


def _sum_err(got, want, terms, what) -> float:
    err = (got - want).abs()
    check(bool((err <= SUM_TOL * terms).all()),
          f"{what}: sum error {err.max().item()} beyond {SUM_TOL} of the "
          f"sum of magnitudes")
    return err.max().item()


def bn_chain(x, g, scale, bias):
    """The kernels' inputs as batch_norm_train forms them: mean, inv, red."""
    n = x.numel() // x.shape[1]
    sums = hopper_bn.bn_stats_plain(_rows3(x))
    mean = sums[0] / n
    inv = torch.rsqrt(sums[1] / n - mean * mean + BN_EPS)
    red = hopper_bn.bn_grad_sum_plain(_rows3(g), _rows3(x), mean, inv) / n
    return mean, inv, red


def phase_bn_kernels(device, shapes=BN_SHAPES) -> dict:
    """Each BatchNorm kernel against its plain version, and batch_norm_train
    against F.batch_norm; returns max abs errors."""
    gen = make_generator(SEED + 4, device)
    err = dict.fromkeys(BN_KERNELS, 0.0)
    for name, shape in shapes.items():
        x, g, scale, bias = bn_operands(shape, gen, device)
        x3, g3 = _rows3(x), _rows3(g)
        mean, inv, red = bn_chain(x, g, scale, bias)
        xhat = (x3 - mean[None, :, None]) * inv[None, :, None]
        e = {
            "bn_stats": _sum_err(
                hopper_bn.bn_stats(x), hopper_bn.bn_stats_plain(x3),
                torch.stack([x3.abs().sum((0, 2)), (x3 * x3).sum((0, 2))]),
                f"{name} bn_stats"),
            "bn_apply": (hopper_bn.bn_apply(x, mean, inv, scale, bias)
                         - hopper_bn.bn_apply_plain(x3, mean, inv, scale,
                                                    bias).reshape(shape)
                         ).abs().max().item(),
            "bn_grad_sum": _sum_err(
                hopper_bn.bn_grad_sum(g, x, mean, inv),
                hopper_bn.bn_grad_sum_plain(g3, x3, mean, inv),
                torch.stack([g3.abs().sum((0, 2)),
                             (g3 * xhat).abs().sum((0, 2))]),
                f"{name} bn_grad_sum"),
            "bn_dx": (hopper_bn.bn_dx(g, x, mean, inv, scale, red)
                      - hopper_bn.bn_dx_plain(g3, x3, mean, inv, scale,
                                              red).reshape(shape)
                      ).abs().max().item(),
        }
        torch.cuda.synchronize()
        check(e["bn_apply"] == 0.0 and e["bn_dx"] == 0.0,
              f"{name}: apply and dx equal to their plain versions ({e})")
        for k in BN_KERNELS:
            err[k] = max(err[k], e[k])
        log(f"[bn] {name} {shape}: sums within {SUM_TOL} of the sum of "
            f"magnitudes, apply and dx exact; max abs err {e}")

        outs = []
        for fused in (True, False):
            xi = x.clone().requires_grad_(True)
            si = scale.clone().requires_grad_(True)
            bi = bias.clone().requires_grad_(True)
            if fused:
                y = hopper_bn.batch_norm_train(xi, si, bi, BN_EPS)[0]
            else:
                y = torch.nn.functional.batch_norm(
                    xi, None, None, si, bi, training=True, eps=BN_EPS)
            y.backward(g)
            outs.append((y.detach(), xi.grad, si.grad, bi.grad))
        torch.cuda.synchronize()
        n = x.numel() // shape[1]
        diffs = []
        for what, got, want in zip(("y", "dx", "dscale", "dbias"), *outs):
            tol = BN_TOL if what in ("y", "dx") else dict(rtol=1e-4,
                                                          atol=1e-6 * n)
            torch.testing.assert_close(got, want, **tol,
                                       msg=lambda m: f"{name} {what}: {m}")
            diffs.append(f"{what} {(got - want).abs().max().item():.3g}")
        log(f"[bn] {name}: batch_norm_train against F.batch_norm + autograd,"
            f" max abs err {', '.join(diffs)}")
        del x, g, x3, g3, xhat, outs
    return err


def phase_bn_times(device, shapes=BN_SHAPES) -> dict:
    """Kernel, plain and library times of each BatchNorm kernel, and of
    F.batch_norm's forward and backward, at each shape."""
    gen = make_generator(SEED + 5, device)
    times = {}
    for name, shape in shapes.items():
        x, g, scale, bias = bn_operands(shape, gen, device)
        x3, g3 = _rows3(x), _rows3(g)
        mean, inv, red = bn_chain(x, g, scale, bias)
        n = x.numel() // shape[1]
        count = torch.tensor([n], dtype=torch.int32, device=device)
        sum_dy, sum_dy_xmu = torch.batch_norm_backward_reduce(
            g, x, mean, inv, scale, True, True, True)[:2]
        cases = {
            "bn_stats": (lambda: hopper_bn.bn_stats(x),
                         lambda: hopper_bn.bn_stats_plain(x3),
                         lambda: torch.batch_norm_stats(x, BN_EPS)),
            "bn_apply": (lambda: hopper_bn.bn_apply(x, mean, inv, scale, bias),
                         lambda: hopper_bn.bn_apply_plain(x3, mean, inv,
                                                          scale, bias),
                         lambda: torch.batch_norm_elemt(x, scale, bias, mean,
                                                        inv, BN_EPS)),
            "bn_grad_sum": (lambda: hopper_bn.bn_grad_sum(g, x, mean, inv),
                            lambda: hopper_bn.bn_grad_sum_plain(g3, x3, mean,
                                                                inv),
                            lambda: torch.batch_norm_backward_reduce(
                                g, x, mean, inv, scale, True, True, True)),
            "bn_dx": (lambda: hopper_bn.bn_dx(g, x, mean, inv, scale, red),
                      lambda: hopper_bn.bn_dx_plain(g3, x3, mean, inv, scale,
                                                    red),
                      lambda: torch.batch_norm_backward_elemt(
                          g, x, mean, inv, scale, sum_dy, sum_dy_xmu, count)),
        }
        times[name] = {k: tuple(time_ms(fn) for fn in fns)
                       for k, fns in cases.items()}
        xg = x.detach().clone().requires_grad_(True)
        sg = scale.detach().clone().requires_grad_(True)
        bg = bias.detach().clone().requires_grad_(True)
        y = torch.nn.functional.batch_norm(xg, None, None, sg, bg,
                                           training=True, eps=BN_EPS)
        times[name]["F.batch_norm"] = (
            time_ms(lambda: torch.nn.functional.batch_norm(
                x, None, None, scale, bias, training=True, eps=BN_EPS)),
            time_ms(lambda: torch.autograd.grad(y, (xg, sg, bg), g,
                                                retain_graph=True)))
        bounds = bn_bounds(shape)
        for k in BN_KERNELS:
            ms, plain, library = times[name][k]
            log(f"[bn times] {k} {name} {shape}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, library {library:.4f} ms, bound "
                f"{bounds[k][0]:.4f} ms ({bounds[k][1]})")
        fwd, bwd = times[name]["F.batch_norm"]
        log(f"[bn times] {name}: F.batch_norm(training=True) forward "
            f"{fwd:.4f} ms, backward {bwd:.4f} ms; kernels K4+K5 "
            f"{times[name]['bn_stats'][0] + times[name]['bn_apply'][0]:.4f}"
            f" ms, K6+K7 "
            f"{times[name]['bn_grad_sum'][0] + times[name]['bn_dx'][0]:.4f}"
            f" ms")
        del x, g, x3, g3, xg, y
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
    with torch.no_grad():  # keeps the trailing ReLU off its floor
        model_cpu.head.cls.bias.fill_(1.0)
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
    for name in ("minmax_select", "minmax_apply"):
        check(launches[name] > 0, f"{name} launched during serving")
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


def train_model(fused_bn) -> AnatCNN:
    """The flagship ResNet-18 AnatCNN with seeded random weights. The
    classifier bias starts at 1 so the trailing ReLU on the logits passes
    gradient from the first step."""
    model = AnatCNN.from_hparams(TRAIN_HPARAMS, fused_bn=fused_bn,
                                 generator=make_generator(SEED))
    with torch.no_grad():
        model.head.cls.bias.fill_(1.0)
    return model


def train_optimizer(model):
    hp = TRAIN_HPARAMS
    return build_optimizer(
        {"head": hp["lr"], "pretrained": hp["lr_pretrained"]},
        head_pretrained_label_fn(("head",), hp["lr_pretrained"]), model,
        hp["l2_reg"])


def launch_counts() -> dict:
    return {**hopper_norm.LAUNCHES, **hopper_bn.LAUNCHES,
            **hopper_maxpool.LAUNCHES}


def reset_launch_counts() -> None:
    hopper_norm.reset_launches()
    hopper_bn.reset_launches()
    hopper_maxpool.reset_launches()


def phase_train_step(device, grid=GRID, timed_steps: int = 3) -> dict:
    """One step from the same weights with fused_bn="full" and False, and a
    control: False again with the raw scans moved by one ulp. Returns the
    median step ms of each mode after the compared step."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    data = make_labeled_volumes(TRAIN_HPARAMS["batch_size"], tuple(grid),
                                n_classes=2, seed=SEED + 6)
    batch = {k: torch.from_numpy(data[k]).to(device)
             for k in ("mri", "mri_mask", "label")}
    bumped = dict(batch, mri=torch.nextafter(
        batch["mri"], torch.full_like(batch["mri"], float("inf"))))
    preprocess = make_device_preprocess(normalize_mri=MINMAX,
                                        quantile=QUANTILE)
    weights = train_model(False).state_dict()
    results = {}
    for case, fused, inputs in (("full", "full", batch),
                                ("False", False, batch),
                                ("False +1 ulp", False, bumped)):
        model = train_model(fused)
        model.load_state_dict(weights)
        model.to(device)
        optimizer = train_optimizer(model)
        step = make_train_step(model, make_criterion(TRAIN_HPARAMS),
                               optimizer, preprocess)
        state = TrainState(model, optimizer)
        torch.cuda.synchronize()
        reset_launch_counts()
        start = time.perf_counter()
        state, aux = step(state, inputs)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - start
        launches = launch_counts()
        norms = {name: p.grad.norm().item()
                 for name, p in model.named_parameters()}
        results[case] = (aux["loss"].item(), norms, launches)
        line = (f"[train step] fused_bn={fused!r}"
                f"{', scans +1 ulp' if inputs is bumped else ''}: loss "
                f"{results[case][0]}, first step {first_s:.3f} s")
        if inputs is batch:
            step_s = []
            for _ in range(timed_steps):
                start = time.perf_counter()
                step(state, inputs)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - start)
            results[case] += (statistics.median(step_s) * 1e3,)
            line += (f", then median {results[case][3]:.2f} ms over "
                     f"{timed_steps} steps")
        log(f"{line}, launches {launches}")
        del model, optimizer, step, state, aux

    def worst_gap(norms, ref_norms):
        return max((abs(norms[k] - v) / max(abs(v), 1e-30), k)
                   for k, v in ref_norms.items())

    loss, norms, launches, full_ms = results["full"]
    loss_ref, norms_ref, launches_ref, plain_ms = results["False"]
    check(np.isfinite(loss) and abs(loss - loss_ref)
          <= STEP_LOSS_RTOL * abs(loss_ref),
          f"loss {loss} (full) against {loss_ref} (False) within rtol "
          f"{STEP_LOSS_RTOL}")
    for name, ref in norms_ref.items():
        got = norms[name]
        check(np.isfinite(got) and abs(got - ref) <= STEP_GRAD_TOL["atol"]
              + STEP_GRAD_TOL["rtol"] * abs(ref),
              f"{name}: grad norm {got} (full) against {ref} (False)")
    backbone = sum(v * v for k, v in norms.items()
                   if k.startswith("backbone.")) ** 0.5
    check(backbone > 0, "the backbone gradient is nonzero")
    want = {"minmax_select": 1, "minmax_apply": 1, "zscore": 0,
            "maxpool_bwd": 0, **dict.fromkeys(BN_KERNELS, BN_LAYERS)}
    check(launches == want, f"fused step launches {launches} == {want}")
    check(launches_ref == {**want, **dict.fromkeys(BN_KERNELS, 0)},
          f"fused_bn=False launches no BatchNorm kernel: {launches_ref}")
    gap, floor = worst_gap(norms, norms_ref), worst_gap(
        results["False +1 ulp"][1], norms_ref)
    log(f"[train step] full vs False: loss err {abs(loss - loss_ref):.3g}, "
        f"largest relative grad-norm err {gap[0]:.3g} ({gap[1]}) over "
        f"{len(norms_ref)} parameters (tolerance {STEP_GRAD_TOL}); False vs "
        f"False with the scans +1 ulp: loss err "
        f"{abs(results['False +1 ulp'][0] - loss_ref):.3g}, largest "
        f"{floor[0]:.3g} ({floor[1]}); backbone grad norm {backbone:.4g}; "
        f"step ms full {full_ms:.2f}, False {plain_ms:.2f}")
    return {"full": full_ms, False: plain_ms}


def phase_fit(device, grid=GRID, n_train: int = 16, n_val: int = 8) -> dict:
    """Trainer.fit for one epoch with fused_bn="full" (the main training
    path); returns the kernels' launch counts over the run."""
    hp = TRAIN_HPARAMS
    data = make_labeled_volumes(n_train + n_val, tuple(grid), n_classes=2,
                                seed=SEED + 7)
    split = {"train": {k: v[:n_train] for k, v in data.items()},
             "val": {k: v[n_train:] for k, v in data.items()}}
    model = train_model("full")
    preprocess = make_device_preprocess(normalize_mri=MINMAX,
                                        quantile=QUANTILE)
    with tempfile.TemporaryDirectory() as root:
        logger = ExperimentLogger(save_dir=root, name="chip_smoke")
        checkpoints = os.path.join(root, "checkpoints")
        trainer = Trainer(model, hp, train_optimizer(model),
                          make_criterion(hp), preprocess, logger=logger,
                          checkpoint_dir=checkpoints, seed=SEED,
                          log_confusion_images=False, device=device)
        train = DataLoader(ArrayDataset(split["train"]), hp["batch_size"],
                           shuffle=True, seed=SEED, device=device)
        val = DataLoader(ArrayDataset(split["val"]), hp["batch_size"],
                         device=device)
        torch.cuda.synchronize()
        reset_launch_counts()
        start = time.perf_counter()
        state, last = trainer.fit(trainer.init_state(), train, val)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = launch_counts()
        logger.close()
        record = json.loads((logger.log_dir / "metrics.jsonl").read_text())
        steps = n_train // hp["batch_size"]
        check(state.step == steps, f"{steps} train steps")
        check(all(np.isfinite(record[k]) for k in (
            "train_loss_epoch", "val_loss_epoch", "train_f1_epoch")),
            f"finite epoch metrics {record}")
        check(record["val_loss_epoch"] == last, "val loss returned")
        want = {"minmax_select": steps + n_val // hp["batch_size"],
                "minmax_apply": steps + n_val // hp["batch_size"],
                "zscore": 0, "maxpool_bwd": 0,
                **dict.fromkeys(BN_KERNELS, BN_LAYERS * steps)}
        check(launches == want, f"fit launches {launches} == {want}")
        names = sorted(os.listdir(checkpoints))
        check(len(names) == 2, f"two top-k checkpoints: {names}")
        state_dict, hparams, metrics = load_checkpoint(
            trainer.ckpt_managers[0].best_path)
        restored = train_model("full")
        restored.load_state_dict(state_dict)
        check(hparams["resnet_depth"] == 18
              and metrics["val_loss_epoch"] == last,
              "the checkpoint holds the hparams and the val loss")
        check(all(torch.equal(v.cpu(), restored.state_dict()[k])
                  for k, v in model.state_dict().items()),
              "the loaded checkpoint equals the trained model")
    log(f"[fit] 1 epoch, {n_train} train + {n_val} val scans at batch "
        f"{hp['batch_size']}: train loss {record['train_loss_epoch']:.6f}, "
        f"val loss {last:.6f}, train F1 {record['train_f1_epoch']:.4f}, "
        f"{seconds:.2f} s ({record['train_volumes_per_s']:.2f} train "
        f"volumes/s), checkpoints {names}, launches {launches}")
    return launches


def _zscore_err(got, want, what: str) -> float:
    """Max |got - want| over finite entries; raises unless NaN and inf sit
    where the plain version has them and every finite entry is within
    ZSCORE_TOL * (1 + |want|)."""
    nan = torch.isnan(want)
    check(torch.equal(torch.isnan(got), nan), f"{what}: NaN positions equal")
    inf = torch.isinf(want)
    check(torch.equal(torch.isinf(got), inf) and torch.equal(got[inf],
                                                            want[inf]),
          f"{what}: inf positions and signs equal")
    fin = ~(nan | inf)
    err = (got[fin] - want[fin]).abs()
    bad = err > ZSCORE_TOL * (1 + want[fin].abs())
    check(not bool(bad.any()), f"{what}: z-score error "
          f"{err.max().item()} beyond {ZSCORE_TOL} * (1 + |plain|)")
    return err.max().item()


def zscore_scans(batch: int, std: float, grid, generator, device):
    """N(900, std) scans and masks > 0.35 as make_labeled_volumes draws
    them, on the device."""
    shape = (batch,) + tuple(grid)
    vol = torch.randn(shape, generator=generator, device=device) * std + 900
    mask = torch.rand(shape, generator=generator, device=device) > 0.35
    return vol, mask.to(torch.float32)


def phase_zscore(device, batches=(8, 32), grid=GRID) -> tuple:
    """K3 against its plain version at each batch, on both intensity
    regimes, also with degenerate scans; then kernel and plain times.
    Returns (max abs error, {batch: (kernel ms, plain ms)})."""
    gen = make_generator(SEED + 8, device)
    err, times = 0.0, {}
    for batch in batches:
        for std in (400.0, 40.0):
            vol, mask = zscore_scans(batch, std, grid, gen, device)
            rows = _rows(vol, mask)
            e = _zscore_err(hopper_norm.per_scan_zscore(vol, mask),
                            hopper_norm.zscore_plain(*rows).reshape(vol.shape),
                            f"B={batch} N(900, {std:g})")
            if std == 400.0:
                times[batch] = (
                    time_ms(lambda: hopper_norm.per_scan_zscore(vol, mask)),
                    time_ms(lambda: hopper_norm.zscore_plain(*rows)))
            mask[1] = 0.0  # no valid voxel: NaN throughout
            mask[2] = 0.0
            mask[2].view(-1)[mask.shape[1] // 2] = 1.0  # one: std 0
            got = hopper_norm.per_scan_zscore(vol, mask)
            e_deg = _zscore_err(got, hopper_norm.zscore_plain(
                *_rows(vol, mask)).reshape(vol.shape),
                f"B={batch} N(900, {std:g}) degenerate")
            torch.cuda.synchronize()
            others = [0] + list(range(3, batch))
            check(bool(torch.isnan(got[1]).all())
                  and not bool(torch.isfinite(got[2]).any())
                  and bool(torch.isfinite(got[others]).all()),
                  "degenerate scans NaN or inf, the others finite")
            err = max(err, e, e_deg)
            log(f"[zscore] B={batch} N(900, {std:g}): max abs err {e} "
                f"(tolerance {ZSCORE_TOL} * (1 + |plain|)); with an empty and "
                f"a one-voxel scan {e_deg}, NaN and inf positions equal")
            del vol, mask, rows, got
        k, p = times[batch]
        n = batch * int(np.prod(grid))
        log(f"[zscore times] B={batch} at {grid}: kernel {k:.4f} ms, plain "
            f"{p:.4f} ms, bound {bound(12 * n, 5 * n)[0]:.4f} ms (function "
            f"bytes), {bound(20 * n, 5 * n)[0]:.4f} ms (this design's two "
            f"reads)")
    return err, times


def phase_zscore_step(device, grid=GRID, timed_steps: int = 3) -> float:
    """bench.py's flagship train step in f32: ResNet-18, 3 classes, batch 8
    of raw scans z-scored in the step (K3), single-lr Adam; returns the
    median step ms."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hp = ZSCORE_HPARAMS
    rng = np.random.default_rng(0)
    shape = (8,) + tuple(grid)
    batch = {"mri": rng.normal(900, 400, shape).astype(np.float32),
             "mri_mask": (rng.random(shape) > 0.35).astype(np.float32),
             "label": rng.integers(0, 3, 8).astype(np.int32)}
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    model = AnatCNN.from_hparams(hp, generator=make_generator(SEED)).to(
        device)
    optimizer = single_lr_optimizer(model, hp["lr"])
    step = make_train_step(model, make_criterion(hp), optimizer,
                           make_device_preprocess(normalize_mri=ZSCORE))
    state = TrainState(model, optimizer)
    torch.cuda.synchronize()
    reset_launch_counts()
    start = time.perf_counter()
    state, aux = step(state, batch)
    loss = aux["loss"].item()
    first_s = time.perf_counter() - start
    check(launch_counts() == {**dict.fromkeys(launch_counts(), 0),
                              "zscore": 1},
          f"one K3 launch and no other in the z-score step: "
          f"{launch_counts()}")
    check(np.isfinite(loss), f"finite z-score step loss {loss}")
    step_s = []
    for _ in range(timed_steps):
        start = time.perf_counter()
        state, aux = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - start)
    check(hopper_norm.LAUNCHES["zscore"] == 1 + timed_steps,
          "one K3 launch per step")
    ms = statistics.median(step_s) * 1e3
    log(f"[zscore step] ResNet-18, 3 classes, batch 8 at {grid}, f32, "
        f"z-score in the step: loss {loss}, first step {first_s:.3f} s, "
        f"then median {ms:.2f} ms over {timed_steps} steps, K3 launches "
        f"{hopper_norm.LAUNCHES['zscore']}")
    return ms


class FixedTrial:
    """An optuna-like trial that answers every suggestion from
    ``answers``."""

    def __init__(self, answers=TRIAL):
        self.answers = answers

    def suggest_float(self, name, low, high, log=False):
        return self.answers[name]

    def suggest_categorical(self, name, choices):
        value = self.answers[name]
        check(value in choices, f"{name}={value} in {choices}")
        return value


def _epoch_record(log_dir: str) -> dict:
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        record = json.loads(f.readline())
    check(all(np.isfinite(record[k]) for k in (
        "train_loss_epoch", "val_loss_epoch", "train_f1_epoch",
        "val_f1_epoch")), f"finite epoch metrics {record}")
    return record


def _load_back(checkpoint: str, model=None, model_cls=AnatCNN) -> None:
    """The checkpoint rebuilds its ``model_cls`` from its hparams and loads;
    equal to ``model``'s weights where given."""
    state_dict, hparams, metrics = load_checkpoint(checkpoint)
    restored = model_cls.from_hparams(hparams)
    restored.load_state_dict(state_dict)
    check(metrics is not None and np.isfinite(metrics["val_loss_epoch"]),
          f"{checkpoint}: finite val loss")
    if model is not None:
        check(all(torch.equal(v.cpu(), restored.state_dict()[k])
                  for k, v in model.state_dict().items()),
              f"{checkpoint} equals the trained model")


def _batches(n: int, batch: int) -> int:
    return math.ceil(n / batch)


@contextlib.contextmanager
def entry_split(grid=GRID):
    """A synthetic split at ``grid`` written by the port into a temporary
    directory, which is the CWD and ``MMALZ_DATA_DIR``'s root meanwhile."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        start = time.perf_counter()
        write_synthetic_split(os.path.join(root, "data"),
                              volume_shape=tuple(grid), **SPLIT)
        n_files = len(os.listdir(os.path.join(root, "data", "images")))
        log(f"[entry] wrote the split {SPLIT} at {grid}: {n_files} NIfTI "
            f"files in {time.perf_counter() - start:.2f} s")
        os.environ["MMALZ_DATA_DIR"] = os.path.join(root, "data")
        os.chdir(root)
        try:
            yield root
        finally:
            os.chdir(cwd)
            os.environ.pop("MMALZ_DATA_DIR", None)


def phase_entry_points(device, root) -> dict:
    """train_anat, a z-score run_training and test_anat_cnn.main() on the
    split in ``root`` (the CWD); returns each path's launch counts."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = {}
    hp = train_anat_cnn.sample_hparams(FixedTrial())
    hp["max_epochs"] = 1
    trainset, valset = build_datasets(hp, ["t1w"])
    n_train, n_val = len(trainset), len(valset)
    check(not np.isnan(trainset.get_label_distribution()[0]).any(),
          "every class in the training split")
    steps = _batches(n_train, hp["batch_size"])
    val_batches = _batches(n_val, hp["batch_size"])

    reset_launch_counts()
    start = time.perf_counter()
    last = train_anat_cnn.train_anat(
        hp, "chip_smoke_anat", log_confusion_images=False,
        device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches["train_anat"] = launch_counts()
    run_dir = os.path.join(root, train_anat_cnn.LOG_DIRECTORY,
                           "chip_smoke_anat", "version_0")
    record = _epoch_record(run_dir)
    check(record["val_loss_epoch"] == last, "val loss returned")
    want = {**dict.fromkeys(launch_counts(), 0),
            "minmax_apply": steps + val_batches}
    check(launches["train_anat"] == want,
          f"train_anat launches {launches['train_anat']} == {want}")
    best = sorted(glob.glob(os.path.join(run_dir, "checkpoints",
                                         "*val_loss=*")))
    check(len(best) == 1, f"one val-loss checkpoint: {best}")
    _load_back(best[0])
    log(f"[entry] train_anat: 1 epoch of {n_train} train + {n_val} "
        f"val scans from disk at batch {hp['batch_size']} "
        f"(ResNet-18, memoised min-max): {seconds:.2f} s in all, "
        f"epoch {record['epoch_time_s']:.2f} s, "
        f"{record['train_volumes_per_s']:.2f} train volumes/s, val "
        f"loss {last:.6f}, launches {launches['train_anat']}")

    hp_z = dict(hp)
    trainset, valset = build_datasets(hp_z, ["t1w"],
                                      normalize_mri=ZSCORE)
    attach_class_weights(hp_z, trainset)
    model = AnatCNN.from_hparams(hp_z,
                                 generator=make_generator(SEED))
    optimizer = train_anat_cnn.backbone_head_optimizer(hp_z, model)
    reset_launch_counts()
    start = time.perf_counter()
    trainer, state, last = run_training(
        model, hp_z, trainset, valset, "chip_smoke_zscore",
        optimizer=optimizer, log_confusion_images=False,
        device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches["zscore"] = launch_counts()
    record = _epoch_record(str(trainer.logger.log_dir))
    trainer.logger.close()
    want = {**dict.fromkeys(launch_counts(), 0),
            "zscore": steps + val_batches}
    check(state.step == steps, f"{steps} z-score train steps")
    check(launches["zscore"] == want,
          f"z-score run launches {launches['zscore']} == {want}")
    _load_back(trainer.ckpt_managers[0].best_path, model)
    log(f"[entry] run_training with the z-score: 1 epoch, "
        f"{seconds:.2f} s in all, epoch "
        f"{record['epoch_time_s']:.2f} s, "
        f"{record['train_volumes_per_s']:.2f} train volumes/s, val "
        f"loss {last:.6f}, launches {launches['zscore']}")

    with open("path_config.yaml", "w") as f:
        f.write("relative:\n"
                "  test_set_csv: 'data/test_path_data_labels.csv'\n"
                f"mri_cnn_2_class: '{best[0]}'\n")
    n_test = len(harness.build_testset(hp))
    check(n_test > 0, "the paired three-modality test set has rows")
    reset_launch_counts()
    start = time.perf_counter()
    metrics = test_anat_cnn.main(confusion_pngs=False,
                                 device=device)["mri_cnn_2_class"]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches["test"] = launch_counts()
    check(all(np.isfinite(v) for v in metrics.values()),
          f"finite test metrics {metrics}")
    want = {**dict.fromkeys(launch_counts(), 0),
            "minmax_apply": _batches(n_test, hp["batch_size"])}
    check(launches["test"] == want,
          f"test launches {launches['test']} == {want}")
    with open(os.path.join("lightning_logs", "test_set_mri_2_class",
                           "version_0", "confusion_matrix.json")) as f:
        counts = json.load(f)["counts"]
    check(sum(map(sum, counts)) == n_test,
          f"confusion counts {counts} over {n_test} test rows")
    log(f"[entry] test_anat_cnn.main(): {n_test} paired test rows in "
        f"{seconds:.2f} s, test loss {metrics['test_loss_epoch']:.6f}"
        f", F1 {metrics['test_f1_epoch']:.4f} (bootstrap "
        f"{metrics['test_f1_epoch_boot']:.4f} +- "
        f"{metrics['test_f1_epoch_ci']:.4f}), confusion counts "
        f"{counts}, launches {launches['test']}")
    return launches


def pool_bound(shape, dtype, winners=None) -> tuple:
    """K8's bound: x, y, g read once and dx written once; its operations
    are the winner compares this run makes (a window stops at its winner)
    and one add per credited window."""
    n_in = float(np.prod(shape))
    n_out = float(np.prod(shape[:2])) * float(np.prod(
        [(n - 1) // 2 + 1 for n in shape[2:]]))
    item = torch.tensor([], dtype=dtype).element_size()
    ops = 0.0
    if winners is not None:
        ops = float((winners.clamp(max=NO_WINNER - 1).to(torch.float64)
                     + 1).sum() + (winners < NO_WINNER).sum())
    return bound(item * (2 * n_in + 2 * n_out), ops)


def aten_pool_backward(g, x, indices):
    return torch.ops.aten.max_pool3d_with_indices_backward(
        g, x, [3, 3, 3], [2, 2, 2], [1, 1, 1], [1, 1, 1], False, indices)


def phase_maxpool(device, shape=STEM) -> dict:
    """K8 against its plain version and aten's backward at the stem, then
    kernel, plain and library times; returns per dtype (max abs error
    against plain, ms, plain ms, library ms, bound ms, bound by)."""
    gen = make_generator(SEED + 9, device)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.relu(torch.randn(shape, generator=gen, device=device)
                       - 0.8).to(dtype)  # ReLU-zero ties, as after the stem
        y, indices = torch.nn.functional.max_pool3d(x, 3, 2, 1,
                                                    return_indices=True)
        check(torch.equal(y, pool_forward(x)), "library pool forward")
        g = torch.randn(y.shape, generator=gen, device=device).to(dtype)
        got = hopper_maxpool.max_pool3d_backward(x, y, g)
        want = max_pool3d_backward_plain(x, y, g)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K8 {dtype} equals its plain version")
        err = (got.float() - want.float()).abs().max().item()
        library = aten_pool_backward(g, x, indices)
        credited = max_pool3d_backward_plain(x, y, g.abs()).float()
        lib_err = (got.float() - library.float()).abs()
        tol = POOL_LIBRARY_TOL[dtype]
        check(bool((lib_err <= tol * credited).all()),
              f"K8 {dtype} against aten within {tol} of the credited "
              f"magnitudes: {lib_err.max().item()}")
        winners = winner_offsets(x, y)
        bound_ms, bound_by = pool_bound(shape, dtype, winners)
        ms = time_ms(lambda: hopper_maxpool.max_pool3d_backward(x, y, g))
        plain_ms = time_ms(lambda: max_pool3d_backward_plain(x, y, g))
        library_ms = time_ms(lambda: aten_pool_backward(g, x, indices))
        out[dtype] = (err, ms, plain_ms, library_ms, bound_ms, bound_by)
        log(f"[maxpool] K8 {shape} {dtype}: equal to plain; against aten "
            f"max abs err {lib_err.max().item():.3g} (tolerance {tol} of the"
            f" credited magnitudes); {int((winners < NO_WINNER).sum())} of "
            f"{winners.numel()} windows have a winner; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by})")
        del x, y, g, got, want, library, credited, lib_err, winners, indices
    return out


def pet_batch(batch: int, grid, seed: int, device, n_classes: int = 2):
    """Raw PET volumes around the z-score constants, and labels of every
    class."""
    rng = np.random.default_rng(seed)
    pet = rng.normal(0.5, 0.5, (batch,) + tuple(grid)).astype(np.float32)
    labels = (np.arange(batch) % n_classes).astype(np.int32)
    return {"pet1451": torch.from_numpy(pet).to(device),
            "label": torch.from_numpy(labels).to(device)}


def _timed_steps(step, state, batch, n: int) -> float:
    times = []
    for _ in range(n):
        start = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    return statistics.median(times) * 1e3


def phase_pet_step(device, grid=GRID, timed_steps: int = 3) -> dict:
    """One PETResNetCNN step (ResNet-18 dilated, batch 8, PET z-score in
    the step) from the same weights with maxpool_impl "wf" and "xla";
    returns each one's launch counts and median step ms."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hp = PET_RESNET_HPARAMS
    batch = pet_batch(hp["batch_size"], grid, SEED + 10, device)
    preprocess = make_device_preprocess(normalize_pet=PET_NORM)
    weights = None
    results = {}
    for impl in ("wf", "xla"):
        model = PETResNetCNN.from_hparams(hp, maxpool_impl=impl,
                                          generator=make_generator(SEED))
        with torch.no_grad():
            model.head.cls.bias.fill_(1.0)  # the trailing ReLU passes
        if weights is None:
            weights = copy.deepcopy(model.state_dict())
        model.load_state_dict(weights)
        model.to(device)
        optimizer = train_optimizer(model)
        step = make_train_step(model, make_criterion(hp), optimizer,
                               preprocess)
        state = TrainState(model, optimizer)
        torch.cuda.synchronize()
        reset_launch_counts()
        state, aux = step(state, batch)
        torch.cuda.synchronize()
        launches = launch_counts()
        norms = {name: p.grad.norm().item()
                 for name, p in model.named_parameters()}
        ms = _timed_steps(step, state, batch, timed_steps)
        results[impl] = (aux["loss"].item(), norms, launches, ms)
        log(f"[pet step] PETResNetCNN ResNet-18 maxpool_impl={impl!r}, batch "
            f"{hp['batch_size']} at {grid}: loss {results[impl][0]}, median "
            f"{ms:.2f} ms over {timed_steps} steps, launches {launches}")
        del model, optimizer, step, state, aux
    loss, norms, launches, wf_ms = results["wf"]
    loss_ref, norms_ref, launches_ref, xla_ms = results["xla"]
    check(np.isfinite(loss) and abs(loss - loss_ref)
          <= STEP_LOSS_RTOL * abs(loss_ref),
          f"loss {loss} (wf) against {loss_ref} (xla)")
    gap = 0.0
    for name, ref in norms_ref.items():
        got = norms[name]
        check(np.isfinite(got) and abs(got - ref) <= STEP_GRAD_TOL["atol"]
              + STEP_GRAD_TOL["rtol"] * abs(ref),
              f"{name}: grad norm {got} (wf) against {ref} (xla)")
        gap = max(gap, abs(got - ref) / max(abs(ref), 1e-30))
    zero = dict.fromkeys(launches, 0)
    check(launches == {**zero, "maxpool_bwd": 1},
          f"the wf step launches K8 once and nothing else: {launches}")
    check(launches_ref == zero, f"the xla step launches nothing: "
          f"{launches_ref}")
    log(f"[pet step] wf vs xla: loss err {abs(loss - loss_ref):.3g}, largest "
        f"relative grad-norm err {gap:.3g} over {len(norms_ref)} parameters "
        f"(tolerance {STEP_GRAD_TOL}); step ms wf {wf_ms:.2f}, xla "
        f"{xla_ms:.2f}")
    return {"wf": launches, "wf_ms": wf_ms, "xla_ms": xla_ms}


def phase_small_pet_step(device, grid=GRID, timed_steps: int = 3) -> float:
    """One SmallPETCNN step at full width: the trial's ladder, BatchNorm and
    dropout on, batch 8, PET z-score in the step; returns the median ms."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hp = train_pet_cnn.sample_hparams(FixedTrial(PET_TRIAL), n_classes=2)
    hp["loss_class_weights"] = [0.5, 0.5]
    model = SmallPETCNN.from_hparams(hp, generator=make_generator(SEED)).to(
        device)
    optimizer = single_lr_optimizer(model, hp["lr"])
    step = make_train_step(model, make_criterion(hp), optimizer,
                           make_device_preprocess(normalize_pet=PET_NORM),
                           make_generator(SEED, device))
    batch = pet_batch(hp["batch_size"], grid, SEED + 11, device)
    state = TrainState(model, optimizer)
    start = time.perf_counter()
    state, aux = step(state, batch)
    loss = aux["loss"].item()
    first_s = time.perf_counter() - start
    check(np.isfinite(loss), f"finite SmallPETCNN loss {loss}")
    ms = _timed_steps(step, state, batch, timed_steps)
    log(f"[pet step] SmallPETCNN conv_out {hp['conv_out']}, filters "
        f"{hp['filter_size']}, batchnorm, dropout {hp['dropout_conv_p']}/"
        f"{hp['dropout_dense_p']}, batch {hp['batch_size']} at {grid}: loss "
        f"{loss}, first step {first_s:.3f} s, then median {ms:.2f} ms over "
        f"{timed_steps} steps")
    return ms


def phase_pet_entry_points(device, root) -> dict:
    """train_pet_cnn.train, train_pet_resnet_cnn.train and
    test_pet_cnn.main() on the split in ``root`` (the CWD); returns each
    one's seconds."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hp = train_pet_cnn.sample_hparams(FixedTrial(PET_TRIAL), n_classes=2)
    hp["max_epochs"] = 1
    trainset, valset = build_datasets(hp, ["pet1451"],
                                      normalize_pet=PET_NORM)
    counts = trainset.get_label_distribution()[0]
    log(f"[pet entry] PET rows: {len(trainset)} train (per class "
        f"{counts.tolist()}), {len(valset)} val")
    check(len(counts) == 2 and bool((counts > 0).all()),
          "both classes in the PET training rows")
    seconds = {}
    runs = (("train_pet_cnn", train_pet_cnn, hp, SmallPETCNN),
            ("train_pet_resnet_cnn", train_pet_resnet_cnn,
             dict(train_pet_resnet_cnn.sample_hparams(FixedTrial()),
                  max_epochs=1), PETResNetCNN))
    best = {}
    for name, module, run_hp, model_cls in runs:
        reset_launch_counts()
        start = time.perf_counter()
        last = module.train(run_hp, f"chip_smoke_{name}",
                            log_confusion_images=False, device=device)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - start
        launches = launch_counts()
        run_dir = os.path.join(root, module.LOG_DIRECTORY,
                               f"chip_smoke_{name}", "version_0")
        record = _epoch_record(run_dir)
        check(record["val_loss_epoch"] == last, "val loss returned")
        check(launches == dict.fromkeys(launches, 0),
              f"{name} launches no kernel: {launches}")
        best[name] = sorted(glob.glob(os.path.join(
            run_dir, "checkpoints", "*val_loss=*")))
        check(len(best[name]) == 1, f"one val-loss checkpoint: {best[name]}")
        _load_back(best[name][0], model_cls=model_cls)
        log(f"[pet entry] {name}.train: 1 epoch from disk at batch "
            f"{run_hp['batch_size']}: {seconds[name]:.2f} s in all, epoch "
            f"{record['epoch_time_s']:.2f} s, "
            f"{record['train_volumes_per_s']:.2f} train volumes/s, val loss "
            f"{last:.6f}")

    with open("path_config.yaml", "w") as f:
        f.write("relative:\n"
                "  test_set_csv: 'data/test_path_data_labels.csv'\n"
                f"pet_cnn_2_class: '{best['train_pet_cnn'][0]}'\n")
    n_test = len(harness.build_testset(hp))
    check(n_test > 0, "the paired three-modality test set has rows")
    start = time.perf_counter()
    metrics = test_pet_cnn.main(confusion_pngs=False,
                                device=device)["pet_cnn_2_class"]
    torch.cuda.synchronize()
    seconds["test_pet_cnn"] = time.perf_counter() - start
    check(all(np.isfinite(v) for v in metrics.values()),
          f"finite test metrics {metrics}")
    with open(os.path.join("lightning_logs", "test_set_pet_2_class",
                           "version_0", "confusion_matrix.json")) as f:
        confusion = json.load(f)["counts"]
    check(sum(map(sum, confusion)) == n_test,
          f"confusion counts {confusion} over {n_test} test rows")
    log(f"[pet entry] test_pet_cnn.main(): {n_test} paired test rows in "
        f"{seconds['test_pet_cnn']:.2f} s, test loss "
        f"{metrics['test_loss_epoch']:.6f}, F1 {metrics['test_f1_epoch']:.4f}"
        f", confusion counts {confusion}")
    return seconds


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
    err.update(phase_bn_kernels(device))
    bn_times = phase_bn_times(device)
    model, preprocess = phase_model(device)
    serve_launches = phase_serve(model, preprocess, device)
    del model
    phase_train_step(device)
    fit_launches = phase_fit(device)
    err["zscore"], zscore_times = phase_zscore(device)
    phase_zscore_step(device)
    pool = phase_maxpool(device)
    pet_step = phase_pet_step(device)
    phase_small_pet_step(device)
    with entry_split() as root:
        entry_launches = phase_entry_points(device, root)
        phase_pet_entry_points(device, root)

    n = 8 * int(np.prod(GRID))  # voxels of a batch of 8 scans
    kernels = []
    for name, nbytes, flops, launches, (ms, plain_ms) in (
            ("minmax_select", 4 * 2 * n, 0.0, serve_launches,
             times[8]["minmax_select"]),
            ("minmax_apply", 4 * 3 * n, 0.0, serve_launches,
             times[8]["minmax_apply"]),
            ("zscore", 4 * 3 * n, 5.0 * n, entry_launches["zscore"],
             zscore_times[8])):
        bound_ms, bound_by = bound(nbytes, flops)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], "batch": 8,
            "shape": [8, int(np.prod(GRID))], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    stem = BN_SHAPES["stem"]
    bounds = bn_bounds(stem)
    for name in BN_KERNELS:
        ms, plain_ms, library_ms = bn_times["stem"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": fit_launches[name],
            "max_abs_err": err[name], "batch": 8, "shape": list(stem),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1], "library_ms": library_ms})
    err_k8, ms, plain_ms, library_ms, bound_ms, bound_by = pool[torch.float32]
    kernels.append({
        "name": "maxpool_bwd", "route": "cuda", "source": SOURCE["maxpool_bwd"],
        "replaces": REPLACES["maxpool_bwd"],
        "launches": pet_step["wf"]["maxpool_bwd"], "max_abs_err": err_k8,
        "batch": 8, "shape": list(STEM), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms})
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
