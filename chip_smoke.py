"""Smoke run of the PyTorch port on one NVIDIA GPU: MRI serving, training and
the entry points from NIfTI files on disk, the PET family with the stem
max-pool backward kernel, TabPFN and the stage-2 fusions.

    python3 chip_smoke.py

Phases, each printing its lines:
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: compiles csrc/minmax_norm.cu, csrc/batch_norm.cu,
     csrc/zscore_norm.cu and csrc/maxpool_bwd.cu with nvcc for sm_90a, one
     process per source, all started together, into one library; prints
     ptxas register counts;
  3. min-max kernels against their plain PyTorch versions at the real
     91x109x91 grid, batch 8: order statistics equal (also with a scan of no
     valid voxel, +inf for it), apply within 1e-6; 10^6-voxel scans, too
     large for the select's one-cluster route, take its device-memory route,
     equal too;
  4. min-max times: at each serving rung (batch 8 and 32) the kernels are
     held to their plain versions again, order_stats and per_scan_minmax are
     checked to return while a spin queued ahead of them still runs (no
     host synchronisation), then both kernels are timed (K1 as its whole
     order_stats call). Every kernel and library time here is device time
     (tools/kernel_times.py): CUDA events around 40 back-to-back calls
     enqueued behind a spin kernel, median of 5 runs, with the time of one
     call between two events (the wrapper's host time included) beside it;
  5. BatchNorm kernels against their plain versions at the five BatchNorm
     shapes of the ResNet-18 train path, stem (8, 64, 46, 55, 46), layer1
     (8, 64, 23, 28, 23) and layers 2-4 (8, 128/256/512, 12, 14, 12), with
     float32 and with bfloat16 activations: sums within 1e-6 of the sum of
     magnitudes, apply and dx equal; batch_norm_train forward and backward
     against F.batch_norm(training=True) and autograd in float32; then
     kernel, plain and library times at each shape in both dtypes, with
     operands cycled past the L2;
  6. the ResNet-18 AnatCNN (dilated, f32, seeded random weights) on the GPU
     against the same model on the CPU, on 2 raw requests;
  7. serving: 40 raw requests from 4 client threads through BatchingServer
     -> Predictor (rungs 8/32) -> min-max preprocess (the kernels) ->
     AnatCNN, checked against single-sample predict_batch, with the kernels'
     launch counts over the run; then a bf16 AnatCNN with the same weights
     at rung 8 beside the f32 one: logits within 2e-2 of max(1, |logit|),
     argmax equal where the margin is clear, requests/s of each;
  8. a train step at full width: ResNet-18 AnatCNN, batch 8 of raw scans
     preprocessed in the step, from the same weights once with
     fused_bn="full" (the BatchNorm kernels) and once with fused_bn=False;
     loss and every parameter's gradient norm must agree, and the fused
     step must launch each BatchNorm kernel 20 times and K1+K2 once, its
     BatchNorms taking inputs of the five shapes 1, 4, 5, 5 and 5 times;
     then both steps are timed;
  9. training: Trainer.fit, one epoch over 16 training and 8 validation
     scans at batch 8 with fused_bn="full", from a DataLoader on the card,
     with its launch counts; a top-k checkpoint is loaded back;
 10. the z-score kernel (K3) against its plain version at batch 8 and 32,
     on N(900, 400) and N(900, 40) scans, with a scan that has no valid
     voxel and one with a single valid voxel: within 1e-5 * (1 + |plain|),
     NaN where the plain version has NaN; then kernel and plain times at
     both batches;
 11. the flagship z-score train step (bench.py's configuration in f32):
     ResNet-18, 3 classes, batch 8 of raw scans z-scored in the step, one
     K3 launch per step, finite loss, step ms; then bench.py's configuration
     exactly, in bfloat16 compute with float32 params, with fused_bn=False
     and "full" (K4-K7 in bf16, 80 launches, inputs counted by shape):
     "full" against False within twice what moving the scans by one bf16
     ulp opens, bf16 against f32 (loss within 5e-2, gradient norm within
     1e-1), step ms and train volumes/s beside f32's;
 12. the max-pool backward kernel (K8) against its plain version at the
     ResNet-18 stem (8, 64, 46, 55, 46), float32 and bfloat16, on ReLU-zero
     ties: equal; against aten's max_pool3d_with_indices_backward on
     NaN-free inputs: within 1e-6 (float32) and 1/32 (bfloat16) of the sum
     of the magnitudes of the credited terms (the adds run in another
     order); then kernel, plain and library times beside the bound;
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
     checkpoints loaded back, and the PET training rows counted by class;
 17. TabPFN at the width of tabpfn's published checkpoint (12 layers,
     emsize 512, nhid 1024, 100 features) on random weights, 1000 train and
     200 test rows of 9 features and 3 classes, 4 members: the port's
     predict_proba and embed on the card against a replica of the reference
     module built here from nn.TransformerEncoder (converted with
     convert_state_dict) and against the port on the CPU, both f32 with
     TF32 off, within 1e-4 of max(1, |ref|); bf16 against f32 (probabilities
     within 1e-2, the tap within 5e-2 of its largest value); the ms of
     fit + predict_proba + embed;
 18. the full-width TabularMRIFusion train step (ResNet-18 tower with
     fused_bn="full", TabularMLP (256, 1024), batch 8 of raw scans min-max
     normalised in the step) in f32 and bf16, frozen and unfrozen: K1 1, K2
     1, K4 and K5 20 each, K6 and K7 0 frozen and 20 unfrozen per step,
     finite loss, nonzero head gradients, frozen tower parameters unchanged
     while every running statistic moves; step ms; then one step fed
     phase 17's TabPFN embeddings as 'tabular_embedding';
 19. one full-width step each of AnatPETFusion and PETTabularFusion;
 20. on phase 15's split: train_tabular.train and test_tab.main() (the MLP
     checkpoint, and a depth-2 random-weight TabPFN checkpoint refit in
     context), the three stage-2 train() from the train_anat, train_pet_cnn
     and tabular checkpoints (K2 once per train and validation batch in the
     MRI ones; frozen towers kept) and their test mains.
The kernels line before the last lists every kernel with the launches of
the path that ran it, its error against its plain version, its device time,
per-call time, plain and library time and bound; K4-K7 also per shape and
in bfloat16 (launches from the bf16 "full" step); K1-K7 also the f32
fusion step's launches, frozen and unfrozen ("launches_fusion"). Any failed check raises,
so the script exits non-zero without printing its last line,
{"ok": true, "device": {...}}. It needs one card and imports the
port only, and neither pandas, yaml nor the plotting packages: no confusion
image is rendered.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import json
import math
import operator
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
    test_anat_pet_fusion,
    test_mri_tab_fusion,
    test_pet_cnn,
    test_pet_tab_fusion,
    test_tab,
)
from multimodal_alzheimer_tpu_torch.inference.predictor import Predictor
from multimodal_alzheimer_tpu_torch.inference.server import BatchingServer
from multimodal_alzheimer_tpu_torch.losses.classification import (
    make_criterion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models import (
    train_anat_pet_fusion,
    train_mrt_tabular_fusion,
    train_pet_tabular_fusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.anat_pet_fusion import (
    AnatPETFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.pet_tabular_fusion import (
    PETTabularFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.tabular_mri_fusion import (
    TabularMRIFusion,
)
from multimodal_alzheimer_tpu_torch.models.layers import FusedBatchNorm
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
from multimodal_alzheimer_tpu_torch.models.tabular_models import train_tabular
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabpfn import (
    TabPFNClassifier,
    TabPFNTransformer,
    _preprocess,
    convert_state_dict,
    model_from_state_dict,
)
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp import (
    TabularMLP,
    compute_feature_stats,
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
from multimodal_alzheimer_tpu_torch.tools.kernel_times import (
    BN_EPS,
    BN_KERNELS,
    BN_PER_STEP,
    BN_SHAPES,
    STEM,
    aten_pool_backward,
    bn_chain,
    bn_operands,
    bound,
    call_ms,
    device_ms,
    norm_bounds,
    time_bn,
    time_norm,
    time_pool,
)
from multimodal_alzheimer_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from multimodal_alzheimer_tpu_torch.train.driver import (
    attach_class_weights,
    build_datasets,
    fusion_optimizer,
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
from multimodal_alzheimer_tpu_torch.utils.path_config import load_path_config
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
NORM_KERNELS = ("minmax_select", "minmax_apply", "zscore")
APPLY_TOL = 1e-6
# The z-score kernel against its plain version: |kernel - plain| <= ZSCORE_TOL
# * (1 + |plain|), NaN where the plain version has NaN. The kernel sums the
# statistics in double in another order, so the mean and std it rounds to
# f32 may differ from the plain version's by an ulp or two.
ZSCORE_TOL = 1e-5
# Per-channel sums: |kernel - plain| <= SUM_TOL * sum of |terms| (the order
# of summation differs). batch_norm_train against F.batch_norm + autograd:
# y and dx within BN_TOL; dscale and dbias, sums of n terms of order 1,
# within rtol 1e-4 and atol 1e-6 n.
SUM_TOL = 1e-6
BN_TOL = dict(rtol=1e-4, atol=1e-5)
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
# bf16 compute against f32 on the same weights and batch, one train step:
# the loss within 5e-2 relative and the gradient's global norm within 1e-1
# (bf16 keeps 8 significant bits; the JAX package's own bf16 and f32
# models differ by 4.4e-3 of the largest logit in eval and 7.1e-2 of the
# largest backbone_gap entry in train, at depth 18 on a small volume).
BF16_STEP_TOL = {"loss": 5e-2, "grad_norm": 1e-1}
# fused_bn="full" against False in bf16: no more than twice the gap that
# moving the raw scans by one bf16 ulp opens between two False steps, plus
# 1e-3 (relative) for a control that happens to move little.
BF16_FLOOR_FACTOR, BF16_FLOOR_SLACK = 2.0, 1e-3
# A bf16 AnatCNN's serving logits against the f32 model's, same weights and
# requests: within 2e-2 of max(1, largest |f32 logit|).
BF16_SERVE_TOL = 2e-2
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

# TabPFN at the width of tabpfn's published prior-fitted checkpoint (the
# JAX defaults, tabpfn.py:111-117), on a seeded table of 1000 train and 200
# test rows of 9 features and 3 classes, 4 ensemble members (the fusion's,
# train_mrt_tabular_fusion.py:1-3).
TABPFN_WIDTH = {"emsize": 512, "nhead": 4, "nhid": 1024, "nlayers": 12,
                "n_out": 10, "max_features": 100}
TABPFN_DATA = {"n_train": 1000, "n_test": 200, "n_features": 9,
               "n_classes": 3, "ensemble_size": 4}
# The replica's decoder[2] weights are scaled by this, so the random model's
# class probabilities spread instead of sitting at 1/3.
TABPFN_LOGIT_SCALE = 4.0
# The port on the card against the replica of the reference module on the
# card (float32, TF32 off) and against the port on the CPU: probabilities
# and the decoder tap within TABPFN_TOL * max(1, largest |reference|), some
# hundred float32 roundings of the largest value, which 12 post-norm
# layers and 1200-term attention sums summed in other orders stay within.
TABPFN_TOL = 1e-4
# bf16 compute against f32, same weights and rows: probabilities within
# 1e-2, the decoder tap within 5e-2 of the largest |f32 tap| (bf16 keeps 8
# significant bits, about 4e-3 relative; twelve layers compound it).
TABPFN_BF16_TOL = {"probs": 1e-2, "decoder": 5e-2}
# The full-width MRI+tabular fusion step: the flagship ResNet-18 tower with
# fused_bn="full" and the TabularMLP (256, 1024) tower, batch 8 of raw scans
# min-max normalised in the step; frozen (lr_pretrained None) and unfrozen.
FUSION_HPARAMS = {"n_classes": 2, "lr": 1e-3, "l2_reg": 1e-2,
                  "loss_class_weights": [0.5, 0.5]}
TAB_HPARAMS = {"n_classes": 2, "hidden": (256, 1024), "dropout_p": 0.0}
# The fusion entry points on the entry split: (lr_pretrained, batch size)
# of each. The PET+tabular loaders drop the last partial batch, and the
# split's binary PET+tabular validation rows are 3 at 91x109x91: its batch
# is at most as many as those rows.
FUSION_ENTRY = {"mri_tab": (None, 8), "anat_pet": (1e-5, 8),
                "pet_tab": (None, 3)}


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
    check(int(n[batch // 2]) == 0 and torch.equal(lo, lo_p)
          and torch.equal(hi, hi_p),
          "a batch with a scan of no valid voxel: every statistic equal "
          "(+inf for that scan)")
    check(bool(torch.isfinite(out[keep]).all()), "finite min-max output")
    log(f"[kernels] batch with an all-zero scan: order statistics equal, "
        f"+inf for that scan")
    big = make_scans("normal", 2, (100, 100, 100), gen, device)
    n, lo, hi = hopper_norm.order_stats(*big, qs)
    n_p, lo_p, hi_p = hopper_norm.order_stats_plain(*_rows(*big), qs_t)
    check(_native.library().minmax_select_workspace_words(2, 10 ** 6, 2) > 0
          and torch.equal(n, n_p) and torch.equal(lo, lo_p)
          and torch.equal(hi, hi_p),
          "a scan of 10^6 voxels takes the device-memory route, exact")
    log(f"[kernels] 10^6-voxel scans (too large for one cluster): the "
        f"device-memory route, order statistics equal")
    return err


def kernel_times(kernel, plain) -> tuple:
    """(device ms, per-call ms) of a kernel's wrapper, and its plain
    version's ms (tools/kernel_times.py says how each is taken)."""
    return (device_ms([kernel]), call_ms([kernel]),
            device_ms([plain], spin=False))


def phase_times(device, err: dict, batches=(8, 32), grid=GRID) -> dict:
    """Kernel and plain times at each serving rung, after holding the
    kernels to their plain versions at that rung; updates ``err``. K1 is
    timed on the whole ``order_stats`` call (tools/kernel_times.time_norm),
    which enqueues without waiting for the card: checked here behind a
    spin."""
    lib = _native.library()
    n_vox = int(np.prod(grid))
    check(lib.minmax_select_workspace_words(8, n_vox, 2) == 0,
          "K1 at this grid: the one-launch route, no workspace")
    log(f"[times] K1: {lib.minmax_select_cluster_blocks(n_vox)} blocks a "
        f"cluster, {lib.minmax_select_active_clusters(n_vox, device.index)}"
        f" clusters resident at once on this card")
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
        torch.cuda.synchronize()
        torch.cuda._sleep(int(200 * 2.0e6))  # 100 ms or more
        hopper_norm.order_stats(vol, mask, qs)
        hopper_norm.per_scan_minmax(vol, mask, QUANTILE)
        check(not torch.cuda.current_stream().query(),
              "order_stats and per_scan_minmax return before a spin queued "
              "ahead of them ends: no host synchronisation")
        k1 = time_norm(batch, gen, device, ("minmax_select",))[
            "minmax_select"]
        times[batch] = {
            "minmax_select": (k1["ms"], k1["call_ms"], k1["plain_ms"]),
            "minmax_apply": kernel_times(
                lambda: hopper_norm.minmax_apply(vol, mask, qmin, qmax),
                lambda: hopper_norm.minmax_apply_plain(vol, mask, qmin,
                                                       qmax)),
        }
        for name, (k, c, p) in times[batch].items():
            log(f"[times] {name} B={batch} at {grid}: kernel {k:.4f} ms "
                f"(per call {c:.4f}), plain {p:.4f} ms")
        del vol, mask, rows
    return times


def _rows3(t):
    return t.reshape(t.shape[0], t.shape[1], -1)


def _sum_err(got, want, terms, what) -> float:
    err = (got - want).abs()
    check(bool((err <= SUM_TOL * terms).all()),
          f"{what}: sum error {err.max().item()} beyond {SUM_TOL} of the "
          f"sum of magnitudes")
    return err.max().item()


def phase_bn_kernels(device, shapes=BN_SHAPES,
                     dtypes=(torch.float32, torch.bfloat16)) -> dict:
    """Each BatchNorm kernel against its plain version in each activation
    dtype, and batch_norm_train against F.batch_norm in float32; returns
    max abs errors, per dtype."""
    gen = make_generator(SEED + 4, device)
    err = {dtype: dict.fromkeys(BN_KERNELS, 0.0) for dtype in dtypes}
    for dtype, name in ((d, s) for d in dtypes for s in shapes):
        shape = shapes[name]
        x, g, scale, bias = bn_operands(shape, gen, device, dtype)
        x3, g3 = _rows3(x), _rows3(g)
        xf, gf = x3.float(), g3.float()
        mean, inv, red = bn_chain(x, g)
        xhat = (xf - mean[None, :, None]) * inv[None, :, None]
        e = {
            "bn_stats": _sum_err(
                hopper_bn.bn_stats(x), hopper_bn.bn_stats_plain(x3),
                torch.stack([xf.abs().sum((0, 2)), (xf * xf).sum((0, 2))]),
                f"{name} bn_stats"),
            "bn_apply": (hopper_bn.bn_apply(x, mean, inv, scale, bias).float()
                         - hopper_bn.bn_apply_plain(x3, mean, inv, scale,
                                                    bias).reshape(shape)
                         ).abs().max().item(),
            "bn_grad_sum": _sum_err(
                hopper_bn.bn_grad_sum(g, x, mean, inv),
                hopper_bn.bn_grad_sum_plain(g3, x3, mean, inv),
                torch.stack([gf.abs().sum((0, 2)),
                             (gf * xhat).abs().sum((0, 2))]),
                f"{name} bn_grad_sum"),
            "bn_dx": (hopper_bn.bn_dx(g, x, mean, inv, scale, red).float()
                      - hopper_bn.bn_dx_plain(g3, x3, mean, inv, scale,
                                              red).reshape(shape)
                      ).abs().max().item(),
        }
        torch.cuda.synchronize()
        check(e["bn_apply"] == 0.0 and e["bn_dx"] == 0.0,
              f"{name} {dtype}: apply and dx equal to their plain versions "
              f"({e})")
        for k in BN_KERNELS:
            err[dtype][k] = max(err[dtype][k], e[k])
        log(f"[bn] {name} {shape} {dtype}: sums within {SUM_TOL} of the sum "
            f"of magnitudes, apply and dx exact; max abs err {e}")
        if dtype != torch.float32:
            del x, g, x3, g3, xf, gf, xhat
            continue

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


def phase_bn_times(device, shapes=BN_SHAPES, dtype=torch.float32) -> dict:
    """Kernel, plain and library times of each BatchNorm kernel, and of
    F.batch_norm's forward and backward, at each shape with ``dtype``
    activations (time_bn)."""
    gen = make_generator(SEED + 5, device)
    times = {}
    for name, shape in shapes.items():
        times[name] = time_bn(shape, gen, device, dtype=dtype)
        for k in BN_KERNELS:
            r = times[name][k]
            log(f"[bn times] {k} {name} {shape} {dtype}, "
                f"{BN_PER_STEP[name]} per "
                f"step: kernel {r['ms']:.4f} ms (per call "
                f"{r['call_ms']:.4f}), plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']:.4f} ms (per call "
                f"{r['library_call_ms']:.4f}), bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
        t = times[name]
        log(f"[bn times] {name}: F.batch_norm(training=True) forward "
            f"{t['F.batch_norm']['forward_ms']:.4f} ms, backward "
            f"{t['F.batch_norm']['backward_ms']:.4f} ms; kernels K4+K5 "
            f"{t['bn_stats']['ms'] + t['bn_apply']['ms']:.4f} ms, K6+K7 "
            f"{t['bn_grad_sum']['ms'] + t['bn_dx']['ms']:.4f} ms")
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
        bn_inputs = []
        hooks = [m.register_forward_hook(
            lambda mod, args, out: bn_inputs.append(tuple(args[0].shape)))
            for m in model.modules() if isinstance(m, FusedBatchNorm)]
        torch.cuda.synchronize()
        reset_launch_counts()
        start = time.perf_counter()
        state, aux = step(state, inputs)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - start
        launches = launch_counts()
        for hook in hooks:
            hook.remove()
        if fused == "full":
            per_shape = {name: bn_inputs.count(shape)
                         for name, shape in BN_SHAPES.items()}
            check(per_shape == BN_PER_STEP
                  and len(bn_inputs) == sum(BN_PER_STEP.values()),
                  f"BatchNorm inputs of the step {per_shape} against "
                  f"{BN_PER_STEP} ({len(bn_inputs)} in all)")
            log(f"[train step] the step's {len(bn_inputs)} BatchNorm inputs "
                f"per shape: {per_shape}")
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
    Returns (max abs error, {batch: (kernel ms, per-call ms, plain
    ms)})."""
    gen = make_generator(SEED + 8, device)
    err, times = 0.0, {}
    for batch in batches:
        for std in (400.0, 40.0):
            vol, mask = zscore_scans(batch, std, grid, gen, device)
            rows = _rows(vol, mask)
            e = _zscore_err(hopper_norm.per_scan_zscore(vol, mask),
                            hopper_norm.zscore_plain(*rows).reshape(vol.shape),
                            f"B={batch} N(900, {std:g})")
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
        r = time_norm(batch, gen, device, ("zscore",))["zscore"]
        times[batch] = (r["ms"], r["call_ms"], r["plain_ms"])
        log(f"[zscore times] B={batch} at {grid}: kernel {r['ms']:.4f} ms "
            f"(per call {r['call_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
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


def bench_batch(grid, device, seed: int = 0) -> dict:
    """bench.py's flagship batch: 8 raw N(900, 400) scans, masks > 0.35,
    3-class labels."""
    rng = np.random.default_rng(seed)
    shape = (8,) + tuple(grid)
    batch = {"mri": rng.normal(900, 400, shape).astype(np.float32),
             "mri_mask": (rng.random(shape) > 0.35).astype(np.float32),
             "label": rng.integers(0, 3, 8).astype(np.int32)}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def phase_bf16_step(device, f32_ms: float, grid=GRID,
                    timed_steps: int = 3) -> dict:
    """bench.py's flagship train step exactly: ResNet-18 dilated,
    linear_out=(), batchnorm_begin=False, lr 1e-3, class weights [0.4, 0.3,
    0.3], batch 8, the z-score in the step (K3), bfloat16 compute with
    float32 params, fused_bn=False; and the same with fused_bn="full" (K4-K7
    in bf16, 80 launches, the BatchNorm inputs counted by shape). From one
    set of weights: "full" against False within a floor measured by False
    with the scans one bf16 ulp up, and bf16 against the same step in f32
    within BF16_STEP_TOL. Returns the step ms and the "full" step's
    launches."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hp = ZSCORE_HPARAMS
    batch = bench_batch(grid, device)
    raw = batch["mri"].cpu().to(torch.bfloat16)
    bumped = dict(batch, mri=torch.nextafter(
        raw, torch.full_like(raw, float("inf"))).to(device, torch.float32))
    weights = AnatCNN.from_hparams(
        hp, generator=make_generator(SEED)).state_dict()
    # the classifier bias at 1 keeps the trailing ReLU on the logits open,
    # so the step has a gradient to compare (train_model does the same)
    weights["head.cls.bias"].fill_(1.0)
    bf16 = torch.bfloat16
    results = {}
    for case, dtype, fused, inputs in (
            ("bf16 False", bf16, False, batch),
            ("bf16 full", bf16, "full", batch),
            ("bf16 False, scans +1 bf16 ulp", bf16, False, bumped),
            ("f32 False", torch.float32, False, batch)):
        model = AnatCNN.from_hparams(hp, dtype=dtype, fused_bn=fused)
        model.load_state_dict(weights)
        model.to(device)
        optimizer = single_lr_optimizer(model, hp["lr"])
        step = make_train_step(model, make_criterion(hp), optimizer,
                               make_device_preprocess(normalize_mri=ZSCORE))
        state = TrainState(model, optimizer)
        bn_inputs = []
        hooks = [m.register_forward_hook(
            lambda mod, args, out: bn_inputs.append(
                (tuple(args[0].shape), args[0].dtype)))
            for m in model.modules() if isinstance(m, FusedBatchNorm)]
        torch.cuda.synchronize()
        reset_launch_counts()
        start = time.perf_counter()
        state, aux = step(state, inputs)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - start
        launches = launch_counts()
        for hook in hooks:
            hook.remove()
        norms = {name: p.grad.norm().item()
                 for name, p in model.named_parameters()}
        r = {"loss": aux["loss"].item(), "norms": norms,
             "launches": launches,
             "grad_norm": sum(v * v for v in norms.values()) ** 0.5}
        check(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
              and r["grad_norm"] > 0, f"{case}: finite loss and a nonzero "
              f"finite gradient")
        check(aux["logits"].dtype == torch.float32
              and all(p.dtype == torch.float32 for p in model.parameters()),
              f"{case}: float32 logits and parameters")
        want = {**dict.fromkeys(launches, 0), "zscore": 1}
        if fused == "full":
            per_shape = {name: bn_inputs.count((shape, bf16))
                         for name, shape in BN_SHAPES.items()}
            check(per_shape == BN_PER_STEP
                  and len(bn_inputs) == sum(BN_PER_STEP.values()),
                  f"bf16 BatchNorm inputs of the step {per_shape} against "
                  f"{BN_PER_STEP}")
            want.update(dict.fromkeys(BN_KERNELS, BN_LAYERS))
        check(launches == want, f"{case}: launches {launches} == {want}")
        line = (f"[bf16 step] {case}: loss {r['loss']}, gradient norm "
                f"{r['grad_norm']:.6g}, first step {first_s:.3f} s")
        if inputs is batch and dtype == bf16:
            step_s = []
            for _ in range(timed_steps):
                start = time.perf_counter()
                step(state, inputs)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - start)
            r["ms"] = statistics.median(step_s) * 1e3
            line += (f", then median {r['ms']:.2f} ms over {timed_steps} "
                     f"steps ({8e3 / r['ms']:.1f} train volumes/s)")
        log(f"{line}, launches {launches}")
        results[case] = r
        del model, optimizer, step, state, aux

    def gaps(a, b):
        loss = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        worst = max((abs(a["norms"][k] - v) / max(abs(v), 1e-30), k)
                    for k, v in b["norms"].items())
        return loss, worst

    ref = results["bf16 False"]
    full_loss, full_worst = gaps(results["bf16 full"], ref)
    ctl_loss, ctl_worst = gaps(results["bf16 False, scans +1 bf16 ulp"], ref)
    check(full_loss <= BF16_FLOOR_FACTOR * ctl_loss + BF16_FLOOR_SLACK
          and full_worst[0] <= BF16_FLOOR_FACTOR * ctl_worst[0]
          + BF16_FLOOR_SLACK,
          f"bf16 full vs False: loss {full_loss:.3g}, grad norm "
          f"{full_worst[0]:.3g} ({full_worst[1]}) within "
          f"{BF16_FLOOR_FACTOR} x the one-ulp control's ({ctl_loss:.3g}, "
          f"{ctl_worst[0]:.3g}) + {BF16_FLOOR_SLACK}")
    f32 = results["f32 False"]
    d_loss = abs(ref["loss"] - f32["loss"]) / abs(f32["loss"])
    d_norm = abs(ref["grad_norm"] - f32["grad_norm"]) / f32["grad_norm"]
    bf_worst = gaps(ref, f32)[1]
    check(d_loss <= BF16_STEP_TOL["loss"]
          and d_norm <= BF16_STEP_TOL["grad_norm"],
          f"bf16 vs f32 step: loss {d_loss:.3g}, gradient norm {d_norm:.3g} "
          f"within {BF16_STEP_TOL}")
    log(f"[bf16 step] full vs False: loss {full_loss:.3g}, largest "
        f"relative grad-norm gap {full_worst[0]:.3g} ({full_worst[1]}); "
        f"control (scans +1 bf16 ulp): loss {ctl_loss:.3g}, largest "
        f"{ctl_worst[0]:.3g} ({ctl_worst[1]}); bf16 vs f32: loss "
        f"{d_loss:.3g}, gradient norm {d_norm:.3g}, largest per-parameter "
        f"{bf_worst[0]:.3g} ({bf_worst[1]}) (tolerance {BF16_STEP_TOL})")
    log(f"[bf16 step] step ms: bf16 False {ref['ms']:.2f}, bf16 full "
        f"{results['bf16 full']['ms']:.2f}, f32 False {f32_ms:.2f} (the "
        f"z-score step phase); train volumes/s {8e3 / ref['ms']:.1f} / "
        f"{8e3 / results['bf16 full']['ms']:.1f} / {8e3 / f32_ms:.1f}")
    return {"ms": {False: ref["ms"], "full": results["bf16 full"]["ms"]},
            "launches": results["bf16 full"]["launches"]}


def phase_bf16_serve(model, preprocess, device, grid=GRID,
                     reps: int = 5) -> dict:
    """A bf16 AnatCNN served by Predictor at rung 8 beside the f32 model
    with the same weights (phase 6's): logits within BF16_SERVE_TOL, the
    argmax equal wherever the f32 margin exceeds it, the backbone_gap
    finite; and requests/s of a full rung of 8 raw requests, each model."""
    model_bf16 = AnatCNN(n_classes=3, resnet_depth=18, dilated=True,
                         dtype=torch.bfloat16)
    model_bf16.load_state_dict(model.state_dict())
    model_bf16.to(device).eval()
    batch = _stack(make_requests(8, grid, SEED + 9))
    outs, rate = {}, {}
    for name, m in (("f32", model), ("bf16", model_bf16)):
        predictor = Predictor(m, batch_size=8, ladder=(8,), device=device,
                              preprocess=preprocess)
        predictor.warmup(batch)
        reset_launch_counts()
        outs[name] = predictor.predict_batch(batch)
        launches = launch_counts()
        check(launches["minmax_select"] == 1
              and launches["minmax_apply"] == 1,
              f"{name} serving batch: K1 and K2 once each ({launches})")
        times = []
        for _ in range(reps):
            start = time.perf_counter()
            predictor.predict_batch(batch)
            times.append(time.perf_counter() - start)
        rate[name] = 8 / statistics.median(times)
    l32, l16 = outs["f32"]["logits"], outs["bf16"]["logits"]
    gap16 = outs["bf16"]["embeddings"]["backbone_gap"]
    tol = BF16_SERVE_TOL * max(1.0, float(np.abs(l32).max()))
    err = float(np.abs(l16 - l32).max())
    top2 = np.sort(l32, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * tol
    check(l16.shape == (8, 3) and np.isfinite(l16).all()
          and gap16.shape == (8, 512) and np.isfinite(gap16).all(),
          "bf16 serving: finite (8, 3) logits and (8, 512) backbone_gap")
    check(err <= tol, f"bf16 logits {err} from f32's, tolerance {tol}")
    check(bool((l16.argmax(1) == l32.argmax(1))[clear].all()),
          "bf16 argmax equal to f32's where the f32 margin exceeds 2x tol")
    log(f"[bf16 serve] rung 8: bf16 logits max abs err {err:.4g} from f32's "
        f"(tolerance {tol:.4g}), argmax equal on {int(clear.sum())} clear "
        f"requests; {rate['bf16']:.2f} requests/s bf16, {rate['f32']:.2f} "
        f"f32 (median of {reps} batches of 8 raw requests)")
    return rate


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


def phase_entry_points(device, root) -> tuple:
    """train_anat, a z-score run_training and test_anat_cnn.main() on the
    split in ``root`` (the CWD); returns each path's launch counts and the
    train_anat checkpoint."""
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
    return launches, best[0]


def phase_maxpool(device, shape=STEM) -> dict:
    """K8 against its plain version and aten's backward at the stem, then
    kernel, plain and library times; returns per dtype (max abs error
    against plain, time_pool's record)."""
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
        r = time_pool(x, y, indices, g)
        out[dtype] = (err, r)
        log(f"[maxpool] K8 {shape} {dtype}: equal to plain; against aten "
            f"max abs err {lib_err.max().item():.3g} (tolerance {tol} of the"
            f" credited magnitudes); {int((winners < NO_WINNER).sum())} of "
            f"{winners.numel()} windows have a winner; kernel {r['ms']:.4f} "
            f"ms (per call {r['call_ms']:.4f}), plain {r['plain_ms']:.4f} ms,"
            f" library {r['library_ms']:.4f} ms (per call "
            f"{r['library_call_ms']:.4f}), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
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


def phase_pet_entry_points(device, root) -> tuple:
    """train_pet_cnn.train, train_pet_resnet_cnn.train and
    test_pet_cnn.main() on the split in ``root`` (the CWD); returns each
    one's seconds and the train_pet_cnn checkpoint."""
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
    return seconds, best["train_pet_cnn"][0]


class ReferenceTabPFN(torch.nn.Module):
    """Replica of the tabpfn TransformerModel whose ``model[2]`` state dict
    the reference saves (tabular_models/dl_approach.py:44), built from
    torch's own modules as tests/test_tabpfn.py:25 builds it: Linear
    ``encoder`` and ``y_encoder``, a ``transformer_encoder`` of post-norm
    GELU layers under the PFN mask, the ``decoder`` Sequential; one
    sequence, sequence-first."""

    def __init__(self, emsize, nhead, nhid, nlayers, n_out, max_features):
        super().__init__()
        nn = torch.nn
        self.encoder = nn.Linear(max_features, emsize)
        self.y_encoder = nn.Linear(1, emsize)
        layer = nn.TransformerEncoderLayer(emsize, nhead, nhid, dropout=0.0,
                                           activation="gelu")
        self.transformer_encoder = nn.TransformerEncoder(
            layer, nlayers, enable_nested_tensor=False)
        self.decoder = nn.Sequential(nn.Linear(emsize, nhid), nn.GELU(),
                                     nn.Linear(nhid, n_out))

    def forward(self, x, y_train, n_train: int):
        """(the test rows' logits, their ``decoder[0]`` activations)"""
        src = self.encoder(x)
        src = torch.cat([src[:n_train] + self.y_encoder(y_train[:, None]),
                         src[n_train:]])
        cols = torch.arange(x.shape[0], device=x.device)
        allowed = (cols[None, :] < n_train) | (cols[None, :] == cols[:, None])
        mask = torch.zeros(allowed.shape, device=x.device).masked_fill(
            ~allowed, float("-inf"))
        out = self.transformer_encoder(src.unsqueeze(1), mask=mask)
        dec = self.decoder[0](out.squeeze(1)[n_train:])
        return self.decoder[2](self.decoder[1](dec)), dec


def tabpfn_table(seed: int):
    """A seeded table: (x_train, y_train, x_test, y_test), features with a
    class signal, one of them on an age-like scale."""
    d = TABPFN_DATA
    n_train = d["n_train"]
    rng = np.random.default_rng(seed)
    y = rng.integers(0, d["n_classes"], n_train + d["n_test"])
    x = rng.normal(size=(len(y), d["n_features"])) + 0.5 * y[:, None]
    x[:, 0] = 70.0 + 8.0 * x[:, 0]
    x = x.astype(np.float32)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def reference_ensemble(replica, clf, x_test, device):
    """The members' mean probabilities and decoder tap through the replica,
    one call per member as the reference loops them (dl_approach.py:71-78),
    with the classifier's rotations and preprocessing."""
    x_all = torch.cat([clf.x_train, torch.from_numpy(x_test).to(device)])
    n_train, n_used = clf.x_train.shape[0], x_all.shape[1]
    n_c = len(clf.classes_)
    probs, decs = [], []
    with torch.inference_mode():
        for c, f in zip(clf.class_shifts.tolist(),
                        clf.feature_shifts.tolist()):
            cols = (torch.arange(n_used, device=device) + f) % n_used
            xs = _preprocess(x_all[:, cols], n_train, n_used,
                             TABPFN_WIDTH["max_features"])
            logits, dec = replica(xs, (clf.y_train + c) % n_c, n_train)
            p = torch.softmax(logits[:, :n_c], dim=-1)
            probs.append(p[:, (torch.arange(n_c, device=device) + c) % n_c])
            decs.append(dec)
    return (torch.stack(probs).mean(0).cpu().numpy(),
            torch.stack(decs).mean(0).cpu().numpy())


def _gap(got, want) -> float:
    """max |got - want| / max(1, max |want|)"""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(1.0, float(np.abs(want).max())))


def phase_tabpfn(device, timed_runs: int = 3) -> dict:
    """TabPFN at its published width on random weights: the port's
    classifier on the card against the replica of the reference module and
    against the port on the CPU (float32, TF32 off), bf16 against f32, and
    the ms of fit + predict_proba + embed; returns the f32 embeddings."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    d = TABPFN_DATA
    torch.manual_seed(SEED + 12)
    replica = ReferenceTabPFN(**TABPFN_WIDTH)
    with torch.no_grad():  # spread the class probabilities
        replica.decoder[2].weight.mul_(TABPFN_LOGIT_SCALE)
    converted = convert_state_dict(replica.state_dict())
    replica = replica.to(device).eval()
    x_tr, y_tr, x_te, y_te = tabpfn_table(SEED + 13)
    runs = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        clf = TabPFNClassifier(
            state_dict=converted,
            model=model_from_state_dict(converted, dtype=dtype),
            ensemble_size=d["ensemble_size"], device=device)
        times = []
        for _ in range(timed_runs + 1):  # the first one warms up
            torch.cuda.synchronize()
            start = time.perf_counter()
            clf.fit(x_tr, y_tr)
            probs = clf.predict_proba(x_te)
            emb = clf.embed(x_te)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
        runs[name] = (clf, probs, emb, statistics.median(times[1:]) * 1e3)
    clf, probs, emb, ms = runs["f32"]
    check(probs.shape == (d["n_test"], d["n_classes"])
          and emb.shape == (d["n_test"], TABPFN_WIDTH["nhid"])
          and np.isfinite(probs).all() and np.isfinite(emb).all(),
          f"TabPFN outputs {probs.shape} {emb.shape}, finite")
    check(np.abs(probs.sum(-1) - 1.0).max() < 1e-5, "probabilities sum to 1")
    gaps = {}
    ref_probs, ref_dec = reference_ensemble(replica, clf, x_te, device)
    gaps["replica probs"] = _gap(probs, ref_probs)
    gaps["replica decoder"] = _gap(emb, ref_dec)
    cpu = TabPFNClassifier(state_dict=converted,
                           model=model_from_state_dict(converted),
                           ensemble_size=d["ensemble_size"],
                           device="cpu").fit(x_tr, y_tr)
    start = time.perf_counter()
    cpu_probs, cpu_emb = cpu.predict_proba(x_te), cpu.embed(x_te)
    cpu_s = time.perf_counter() - start
    gaps["cpu probs"] = _gap(probs, cpu_probs)
    gaps["cpu decoder"] = _gap(emb, cpu_emb)
    for what, gap in gaps.items():
        check(gap <= TABPFN_TOL, f"TabPFN {what}: {gap:.3g} > {TABPFN_TOL}")
    _, bf_probs, bf_emb, bf_ms = runs["bf16"]
    bf_gap = {"probs": float(np.abs(bf_probs - probs).max()),
              "decoder": float(np.abs(bf_emb - emb).max()
                               / np.abs(emb).max())}
    for what, gap in bf_gap.items():
        check(np.isfinite(gap) and gap <= TABPFN_BF16_TOL[what],
              f"TabPFN bf16 {what} {gap:.3g} > {TABPFN_BF16_TOL[what]}")
    accuracy = float((clf.classes_[probs.argmax(1)] == y_te).mean())
    log(f"[tabpfn] {TABPFN_WIDTH}, {d}: fit + predict_proba + embed median "
        f"{ms:.2f} ms f32, {bf_ms:.2f} ms bf16 (of {timed_runs} after a "
        f"warm-up); against the replica and the CPU (relative to max(1, "
        f"|ref|), tolerance {TABPFN_TOL}): "
        + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
        + f"; bf16 against f32: probs {bf_gap['probs']:.3g}, decoder "
        f"{bf_gap['decoder']:.3g} of max |tap| (tolerance {TABPFN_BF16_TOL}"
        f"); CPU predict_proba + embed {cpu_s:.2f} s; winning probability "
        f"{probs.max(1).min():.3f} to {probs.max(1).max():.3f}, test "
        f"accuracy {accuracy:.3f} (random weights)")
    return {"embed": emb, "ms": ms, "bf16_ms": bf_ms}


def fusion_batch(modalities, grid, seed: int, device) -> tuple:
    """(a batch of 8 raw samples of both classes on the device, feature
    statistics of its tabular rows or None)"""
    data = make_labeled_volumes(8, tuple(grid), n_classes=2, seed=seed,
                                modalities=modalities)
    data["label"] = (np.arange(8) % 2).astype(np.int32)
    stats = (compute_feature_stats(data["tabular"])
             if "tabular" in data else None)
    return {k: torch.from_numpy(v).to(device) for k, v in data.items()}, stats


def _tower_changes(before: dict, after: dict, towers) -> tuple:
    """(parameters kept, parameters in all, running statistics moved,
    running statistics in all) of the towers' state dict entries."""
    keys = [k for k in before if k.split(".")[0] in towers]
    stats = [k for k in keys if k.endswith(("running_mean", "running_var"))]
    params = [k for k in keys if k not in stats]
    return (sum(torch.equal(after[k], before[k]) for k in params),
            len(params),
            sum(not torch.equal(after[k], before[k]) for k in stats),
            len(stats))


def phase_fusion_step(device, embeddings, grid=GRID,
                      timed_steps: int = 3) -> dict:
    """The full-width TabularMRIFusion train step (ResNet-18 tower with
    fused_bn="full", TabularMLP (256, 1024), batch 8 of raw scans min-max
    normalised in the step) in f32 and bf16, frozen and unfrozen, with its
    launch counts, then one step fed phase 1's TabPFN embeddings; returns
    the f32 steps' launch counts."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch, (mean, std) = fusion_batch(("mri", "tabular"), grid, SEED + 14,
                                      device)
    tab_hp = dict(TAB_HPARAMS, feature_mean=mean, feature_std=std)
    preprocess = make_device_preprocess(normalize_mri=MINMAX,
                                        quantile=QUANTILE)
    heads = train_mrt_tabular_fusion.HEAD_NAMES
    towers = ("mri_model", "tab_model")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for frozen in (True, False):
            hp = dict(FUSION_HPARAMS, lr_pretrained=None if frozen else 1e-5)
            gen = make_generator(SEED)
            model = TabularMRIFusion(
                2, AnatCNN.from_hparams(TRAIN_HPARAMS, fused_bn="full",
                                        freeze_backbone=False, dtype=dtype,
                                        generator=gen),
                TabularMLP.from_hparams(tab_hp, dtype=dtype, generator=gen),
                freeze_towers=frozen, dtype=dtype, generator=gen).to(device)
            optimizer = fusion_optimizer(hp, heads, model)
            step = make_train_step(model, make_criterion(hp), optimizer,
                                   preprocess)
            state = TrainState(model, optimizer)
            before = {k: v.clone() for k, v in model.state_dict().items()}
            torch.cuda.synchronize()
            reset_launch_counts()
            state, aux = step(state, batch)
            torch.cuda.synchronize()
            launches = launch_counts()
            loss = aux["loss"].item()
            backward = 0 if frozen else BN_LAYERS
            want = {"minmax_select": 1, "minmax_apply": 1, "zscore": 0,
                    "maxpool_bwd": 0, "bn_stats": BN_LAYERS,
                    "bn_apply": BN_LAYERS, "bn_grad_sum": backward,
                    "bn_dx": backward}
            what = (f"TabularMRIFusion {str(dtype)[6:]} "
                    f"{'frozen' if frozen else 'unfrozen'}")
            check(launches == want, f"{what} launches {launches} == {want}")
            check(np.isfinite(loss), f"{what}: finite loss {loss}")
            head_norms = [p.grad.norm().item()
                          for n, p in model.named_parameters()
                          if n.split(".")[0] in heads]
            check(all(np.isfinite(v) and v > 0 for v in head_norms),
                  f"{what}: nonzero head gradients {head_norms}")
            kept, n_params, moved, n_stats = _tower_changes(
                before, model.state_dict(), towers)
            check(moved == n_stats == 2 * BN_LAYERS,
                  f"{what}: {moved} of {n_stats} running statistics moved")
            check(kept == n_params if frozen else kept < n_params // 10,
                  f"{what}: {kept} of {n_params} tower parameters kept")
            ms = _timed_steps(step, state, batch, timed_steps)
            out[(dtype, frozen)] = launches
            log(f"[fusion step] {what}, batch 8 at {grid}: loss {loss}, "
                f"median {ms:.2f} ms over {timed_steps} steps, launches "
                f"{launches}; tower parameters kept {kept}/{n_params}, "
                f"running statistics moved {moved}/{n_stats}")
            if dtype == torch.float32 and frozen:
                emb = torch.from_numpy(embeddings[:8]).to(device)
                captured = {}
                hook = model.tab_model.register_forward_hook(
                    lambda m, args, result: captured.update(
                        decoder=result["embeddings"]["decoder"]))
                reset_launch_counts()
                state, aux = step(state, dict(batch, tabular_embedding=emb))
                torch.cuda.synchronize()
                hook.remove()
                check(torch.equal(captured["decoder"], emb),
                      "the TabPFN embeddings are the tabular tap")
                check(np.isfinite(aux["loss"].item())
                      and launch_counts() == want,
                      f"the embedding step: loss {aux['loss'].item()}, "
                      f"launches {launch_counts()}")
                log(f"[fusion step] the same step fed TabPFN's 1024-d "
                    f"embeddings (tabular_embedding): loss "
                    f"{aux['loss'].item()}, launches {launch_counts()}")
            del model, optimizer, step, state, aux, before
    return {"frozen": out[(torch.float32, True)],
            "unfrozen": out[(torch.float32, False)]}


def phase_fusion_pair_steps(device, grid=GRID, timed_steps: int = 3) -> dict:
    """One full-width step each of AnatPETFusion (ResNet-18 and SmallPETCNN
    towers unfrozen, min-max and PET z-score in the step) and
    PETTabularFusion (towers frozen, simple_dim_red); returns the step
    ms."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pet_hp = train_pet_cnn.sample_hparams(FixedTrial(PET_TRIAL), n_classes=2)
    zero = dict.fromkeys(launch_counts(), 0)
    out = {}
    for name in ("anat_pet", "pet_tab"):
        gen = make_generator(SEED)
        if name == "anat_pet":
            batch, _ = fusion_batch(("mri", "pet1451"), grid, SEED + 15,
                                    device)
            hp = dict(FUSION_HPARAMS, lr_pretrained=1e-5)
            model = AnatPETFusion.from_hparams(hp, pet_hp, TRAIN_HPARAMS,
                                               generator=gen)
            preprocess = make_device_preprocess(PET_NORM, MINMAX, QUANTILE)
            heads = train_anat_pet_fusion.HEAD_NAMES
            want = dict(zero, minmax_select=1, minmax_apply=1)
        else:
            batch, (mean, std) = fusion_batch(("pet1451", "tabular"), grid,
                                              SEED + 16, device)
            hp = dict(FUSION_HPARAMS, lr_pretrained=None,
                      simple_dim_red=True)
            model = PETTabularFusion.from_hparams(
                hp, pet_hp, dict(TAB_HPARAMS, feature_mean=mean,
                                 feature_std=std), generator=gen)
            preprocess = make_device_preprocess(normalize_pet=PET_NORM)
            heads = train_pet_tabular_fusion.HEAD_NAMES
            want = zero
        model.to(device)
        optimizer = fusion_optimizer(hp, heads, model)
        step = make_train_step(model, make_criterion(hp), optimizer,
                               preprocess, make_generator(SEED, device))
        state = TrainState(model, optimizer)
        torch.cuda.synchronize()
        reset_launch_counts()
        state, aux = step(state, batch)
        torch.cuda.synchronize()
        launches = launch_counts()
        loss = aux["loss"].item()
        check(np.isfinite(loss) and launches == want,
              f"{name} step: loss {loss}, launches {launches} == {want}")
        out[name] = _timed_steps(step, state, batch, timed_steps)
        log(f"[fusion step] {type(model).__name__} "
            f"({'unfrozen' if hp['lr_pretrained'] else 'frozen'}), batch 8 "
            f"at {grid}: loss {loss}, median {out[name]:.2f} ms over "
            f"{timed_steps} steps, launches {launches}")
        del model, optimizer, step, state, aux
    return out


# A fixed trial for train_tabular.sample_hparams: the (256, 1024) MLP.
TAB_TRIAL = {"lr": 1e-3, "batch_size": 16, "hidden": "(256, 1024)",
             "dropout_p": 0.1, "l2_reg": 1e-3, "fl_gamma": None}


def _fusion_trial(lr_pretrained) -> FixedTrial:
    return FixedTrial({"lr": 1e-3, "freeze": lr_pretrained is None,
                       "lr_pretrained": lr_pretrained, "batch_size": 8,
                       "l2_reg": 1e-2, "fl_gamma": None,
                       "simple_dim_red": True})


def phase_fusion_entry_points(device, root, mri_checkpoint: str,
                              pet_checkpoint: str) -> dict:
    """train_tabular.train and test_tab.main() (the MLP checkpoint and a
    random-weight TabPFN checkpoint at depth 2, refit in context), the
    three stage-2 train() from the MRI, PET and tabular checkpoints, and
    their test mains, on the split in ``root`` (the CWD); returns each
    one's seconds."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    zero = dict.fromkeys(launch_counts(), 0)
    seconds = {}

    hp = train_tabular.sample_hparams(FixedTrial(TAB_TRIAL), n_classes=2)
    hp["max_epochs"] = 1
    reset_launch_counts()
    start = time.perf_counter()
    last = train_tabular.train(hp, "chip_smoke_tabular",
                               log_confusion_images=False, device=device)
    torch.cuda.synchronize()
    seconds["train_tabular"] = time.perf_counter() - start
    run_dir = os.path.join(root, train_tabular.LOG_DIRECTORY,
                           "chip_smoke_tabular", "version_0")
    record = _epoch_record(run_dir)
    check(record["val_loss_epoch"] == last and launch_counts() == zero,
          f"train_tabular: val loss returned, launches {launch_counts()}")
    tab_checkpoint = sorted(glob.glob(os.path.join(run_dir, "checkpoints",
                                                   "*val_loss=*")))[0]
    _load_back(tab_checkpoint, model_cls=TabularMLP)
    tabpfn_checkpoint = os.path.join(root, "tabpfn_depth2")
    save_checkpoint(tabpfn_checkpoint, TabPFNTransformer(
        **dict(TABPFN_WIDTH, nlayers=2),
        generator=make_generator(SEED)).state_dict(), {})
    with open("path_config.yaml", "w") as f:
        f.write("relative:\n"
                "  test_set_csv: 'data/test_path_data_labels.csv'\n"
                "  train_set_csv: 'data/train_path_data_labels.csv'\n"
                f"tabular_mlp_2_class: '{tab_checkpoint}'\n"
                f"tabpfn_2_class: '{tabpfn_checkpoint}'\n")
    start = time.perf_counter()
    results = test_tab.main(confusion_pngs=False, device=device)
    torch.cuda.synchronize()
    seconds["test_tab"] = time.perf_counter() - start
    check(set(results) == {"tabular_mlp_2_class", "tabpfn_2_class"}
          and all(np.isfinite(v) for r in results.values()
                  for k, v in r.items() if k != "tabular_baseline_F1"),
          f"finite test_tab metrics {results}")
    log(f"[fusion entry] train_tabular.train: 1 epoch of "
        f"{len(build_datasets(hp, ['tabular'])[0])} train rows at batch "
        f"{hp['batch_size']}, {seconds['train_tabular']:.2f} "
        f"s, val loss {last:.6f}; test_tab.main() {seconds['test_tab']:.2f} "
        f"s: MLP F1 {results['tabular_mlp_2_class']['test_f1_epoch']:.4f}, "
        f"TabPFN (depth 2, random weights, refit on the train split) F1 "
        f"{results['tabpfn_2_class']['test_f1_epoch']:.4f}")

    paths = {"path_mri": mri_checkpoint, "path_pet": pet_checkpoint,
             "path_tabular": tab_checkpoint}
    stage2 = (("mri_tab", train_mrt_tabular_fusion, test_mri_tab_fusion,
               ("path_mri", "path_tabular"), ["tabular", "t1w"]),
              ("anat_pet", train_anat_pet_fusion, test_anat_pet_fusion,
               ("path_pet", "path_mri"), ["pet1451", "t1w"]),
              ("pet_tab", train_pet_tabular_fusion, test_pet_tab_fusion,
               ("path_pet", "path_tabular"), ["pet1451", "tabular"]))
    best = {}
    for name, module, tester, keys, modalities in stage2:
        lr_pretrained, batch = FUSION_ENTRY[name]
        hp = module.sample_hparams(_fusion_trial(lr_pretrained), n_classes=2,
                                   **{k: paths[k] for k in keys})
        trainset, valset = build_datasets(dict(hp, n_classes=2), modalities)
        check(not np.isnan(trainset.get_label_distribution()[0]).any(),
              f"{name}: both classes in the training rows")
        count = _batches
        if name == "pet_tab":  # its loaders drop the last partial batch
            batch, count = min(batch, len(valset)), operator.floordiv
        hp.update(max_epochs=1, batch_size=batch)
        steps, val_batches = count(len(trainset), batch), count(len(valset),
                                                                batch)
        reset_launch_counts()
        start = time.perf_counter()
        last = module.train(hp, f"chip_smoke_{name}",
                            log_confusion_images=False, device=device)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - start
        launches = launch_counts()
        want = (dict(zero, minmax_apply=steps + val_batches)
                if "t1w" in modalities else zero)
        check(launches == want, f"{name} launches {launches} == {want}")
        run_dir = os.path.join(root, module.LOG_DIRECTORY,
                               f"chip_smoke_{name}", "version_0")
        record = _epoch_record(run_dir)
        check(record["val_loss_epoch"] == last, "val loss returned")
        found = sorted(glob.glob(os.path.join(run_dir, "checkpoints",
                                              "*val_loss=*")))
        check(len(found) == 1, f"one val-loss checkpoint: {found}")
        best[name] = found[0]
        model, state_dict = tester.load_fusion(found[0])[:2]
        model.load_state_dict(state_dict)
        kept = []
        for key in keys:
            tower = {"path_mri": "mri_model", "path_pet": "pet_model",
                     "path_tabular": "tab_model"}[key]
            stage1, _, _ = load_checkpoint(paths[key])
            kept.append(all(torch.equal(state_dict[f"{tower}.{k}"], v)
                            for k, v in stage1.items()
                            if "running" not in k))
        check(all(kept) == (lr_pretrained is None),
              f"{name}: tower parameters kept {kept}, lr_pretrained "
              f"{lr_pretrained}")
        log(f"[fusion entry] {module.__name__.rsplit('.', 1)[1]}.train "
            f"({'frozen' if lr_pretrained is None else 'unfrozen'}): 1 "
            f"epoch of {len(trainset)} train + {len(valset)} val rows at "
            f"batch {batch}, {seconds[name]:.2f} s in all, epoch "
            f"{record['epoch_time_s']:.2f} s, val loss {last:.6f}, launches "
            f"{launches}")

    with open("path_config.yaml", "w") as f:
        f.write("relative:\n"
                "  test_set_csv: 'data/test_path_data_labels.csv'\n"
                f"mri_tab_2_class: '{best['mri_tab']}'\n"
                f"pet_mri_2_class: '{best['anat_pet']}'\n"
                f"pet_tab_2_class: '{best['pet_tab']}'\n")
    n_test = len(harness.build_testset({"n_classes": 2}))
    check(n_test > 0, "the paired three-modality test set has rows")
    for name, _, tester, keys, modalities in stage2:
        key = {"mri_tab": "mri_tab_2_class", "anat_pet": "pet_mri_2_class",
               "pet_tab": "pet_tab_2_class"}[name]
        batch = load_checkpoint(best[name])[1]["batch_size"]
        reset_launch_counts()
        start = time.perf_counter()
        metrics = tester.main(confusion_pngs=False, device=device)[key]
        torch.cuda.synchronize()
        seconds[f"test_{name}"] = time.perf_counter() - start
        launches = launch_counts()
        want = (dict(zero, minmax_apply=_batches(n_test, batch))
                if "t1w" in modalities else zero)
        check(all(np.isfinite(v) for v in metrics.values())
              and launches == want,
              f"{key}: finite metrics {metrics}, launches {launches} == "
              f"{want}")
        with open(os.path.join("lightning_logs", f"test_set_{key}",
                               "version_0", "confusion_matrix.json")) as f:
            counts = json.load(f)["counts"]
        check(sum(map(sum, counts)) == n_test,
              f"confusion counts {counts} over {n_test} test rows")
        log(f"[fusion entry] {tester.__name__.rsplit('.', 1)[1]}.main(): "
            f"{n_test} paired test rows in {seconds[f'test_{name}']:.2f} s, "
            f"test loss {metrics['test_loss_epoch']:.6f}, F1 "
            f"{metrics['test_f1_epoch']:.4f}, launches {launches}")
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
    bn_err = phase_bn_kernels(device)
    err.update(bn_err[torch.float32])
    bn_times = phase_bn_times(device)
    bn_times_bf16 = phase_bn_times(device, dtype=torch.bfloat16)
    model, preprocess = phase_model(device)
    serve_launches = phase_serve(model, preprocess, device)
    phase_bf16_serve(model, preprocess, device)
    del model
    phase_train_step(device)
    fit_launches = phase_fit(device)
    err["zscore"], zscore_times = phase_zscore(device)
    f32_ms = phase_zscore_step(device)
    bf16_step = phase_bf16_step(device, f32_ms)
    pool = phase_maxpool(device)
    pet_step = phase_pet_step(device)
    phase_small_pet_step(device)
    tabpfn = phase_tabpfn(device)
    fusion_launches = phase_fusion_step(device, tabpfn["embed"])
    phase_fusion_pair_steps(device)
    with entry_split() as root:
        entry_launches, mri_checkpoint = phase_entry_points(device, root)
        _, pet_checkpoint = phase_pet_entry_points(device, root)
        phase_fusion_entry_points(device, root, mri_checkpoint,
                                  pet_checkpoint)

    n = 8 * int(np.prod(GRID))  # voxels of a batch of 8 scans
    norm_bound = norm_bounds(8, int(np.prod(GRID)))
    kernels = []
    for name, (bound_ms, bound_by), launches, (ms, per_call, plain_ms) in (
            ("minmax_select", norm_bound["minmax_select"], serve_launches,
             times[8]["minmax_select"]),
            ("minmax_apply", bound(4 * 3 * n, 0.0), serve_launches,
             times[8]["minmax_apply"]),
            ("zscore", norm_bound["zscore"], entry_launches["zscore"],
             zscore_times[8])):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], "batch": 8,
            "launches_fusion": {k: v[name] for k, v in
                                fusion_launches.items()},
            "shape": [8, int(np.prod(GRID))], "ms": ms, "call_ms": per_call,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None})
    keys = ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    for name in BN_KERNELS:
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": fit_launches[name],
            "launches_fusion": {k: v[name] for k, v in
                                fusion_launches.items()},
            "max_abs_err": err[name], "batch": 8,
            "shape": list(BN_SHAPES["stem"]),
            **{k: bn_times["stem"][name][k] for k in keys},
            "per_shape": {
                shape: {"dims": list(BN_SHAPES[shape]),
                        "launches_per_step": BN_PER_STEP[shape],
                        **{k: bn_times[shape][name][k] for k in keys}}
                for shape in BN_SHAPES},
            "bfloat16": {
                "launches": bf16_step["launches"][name],
                "max_abs_err": bn_err[torch.bfloat16][name],
                **{k: bn_times_bf16["stem"][name][k] for k in keys},
                "per_shape": {
                    shape: {k: bn_times_bf16[shape][name][k] for k in keys}
                    for shape in BN_SHAPES}}})
    err_k8, k8 = pool[torch.float32]
    kernels.append({
        "name": "maxpool_bwd", "route": "cuda", "source": SOURCE["maxpool_bwd"],
        "replaces": REPLACES["maxpool_bwd"],
        "launches": pet_step["wf"]["maxpool_bwd"], "max_abs_err": err_k8,
        "batch": 8, "shape": list(STEM), **{k: k8[k] for k in keys},
        "bfloat16": {k: pool[torch.bfloat16][1][k] for k in keys}})
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
