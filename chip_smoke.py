"""Smoke run of the PyTorch port on one NVIDIA GPU: MRI serving (float, bf16,
BN-folded and int8 through the int8 convolution kernel, exported
artifacts, dataset-level quality), training and the entry points from
NIfTI files on disk, the PET family with the stem max-pool backward
kernel, TabPFN, the stage-2 fusions, stage 3 (int8 too), the two fusion
baselines, the hyperparameter search (K-trial trainer, seed screen,
shared-tower fusion search, the entry points' studies), and data
provisioning from a raw ADNI layout through the native NIfTI decoder.

    python3 chip_smoke.py

Phases, each printing its lines:
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: compiles csrc/minmax_norm.cu, csrc/batch_norm.cu,
     csrc/zscore_norm.cu, csrc/maxpool_bwd.cu, csrc/int8_conv3d.cu and
     csrc/narrow_conv3d.cu with nvcc for sm_90a, one
     process per source, all started together, into one library; prints
     ptxas register counts; then the native NIfTI decoder
     (csrc/host/nifti_io.cc, g++ with the JAX package's flags), which must
     load: the data path has no fallback to the plain reader here;
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
  7b. the int8 convolution (K9) against its plain version, bit for bit, in
     every epilogue mode (float32 out with scale 1 and bias 0, then random
     scale and bias; ReLU and int8 out; a float32 or int8 residual, ReLU,
     int8 or float32 out) at all 11 convolution shapes of the int8
     ResNet-18 at batch 2 and at kernel_times.INT8_GEOMETRIES (the C_in=2
     stem, depth-50 1^3 convs, the PET tower's pads, ragged tails, long K
     at C not a multiple of 16, the CPU tests' geometries);
     then bit for bit again and its device times at batch 8 and 32, per
     shape in float32-out mode and in each mode the graph runs there,
     against the mode's bound (int8 dense tensor cores at 1,979 TOP/s or
     3.35 TB/s), with torch._int_mm on im2col columns of the same M, N, K
     (the GEMM only) and cuDNN's bf16 conv3d of each shape beside it as
     context; the host microseconds per call of K1, K2, K3 and K9 through
     their custom ops and straight into the ctypes launch;
  7c. the serving extras on phase 6's model: the four serve cores of
     tools/cases.py (float32, bf16, BN-folded bf16, int8 calibrated on 2
     raw batches); per batch of 8 raw requests K1 and K2 once each and K9
     20 times (int8 only); int8 drift from the float32 model within JAX's
     bounds (argmax agreement 1.0, probabilities within 0.01); folded
     logits within 2e-2 of max(1, |f32 logit|) of f32's and twice that of
     the bf16 model's, argmax equal to the bf16 model's where the f32
     margin exceeds 4x that; then the int8 core behind
     Predictor(serve_fn=..., ladder=(8,), batch_size=32) and BatchingServer
     over phase 7's 40 requests (every count set to 0 before, read after;
     K9 20 per served batch); requests/s of the four cores at rungs 8 and
     32;
  7d. the int8 and folded cores through export_serve_fn -> bytes ->
     load_exported: outputs bit for bit the eager core's, K1/K2 (and K9 20
     times) launched inside the loaded program;
  7e. compare_serve_cores over the float32, folded and int8 cores on 32
     labeled synthetic volumes (bootstrap 200), printed with
     format_comparison;
  7e'. the int8 ResNet-18 graph on one batch of 8 through K9's fused
     epilogue and through the unfused composition (float32 out, then
     torch's add, ReLU and requant; a context subclass here): every
     requant site's carrier, the feature map and the logits equal bit for
     bit, K9 20 launches a fused batch, drift within JAX's bounds;
  7f. int8 stage 3: quantize_all_modalities_fusion on tools/cases.py's
     stage-3 case (shared towers), K9 20 and K1/K2 once per batch,
     probabilities within 0.01 of the float fusion's and the argmax equal
     where its margin is clear; ms per batch of each;
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
     the volumes decode through the native decoder, and train_anat runs
     four times, native decoder and plain reader in turns (N P P N), their
     epoch times printed side by side;
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
     MRI ones; frozen towers kept) and their test mains;
 21. the full-width AllModalitiesFusion step (two ResNet-18 MRI towers with
     fused_bn="full", SmallPETCNN at its defaults, TabularMLP (256, 1024),
     batch 8 of raw scans normalised in the step) in f32 and bf16: frozen,
     so the towers are shared (K1 1, K2 1, K4/K5 20, K6/K7 0; its eval
     logits within 1e-6 of max(1, |logit|) of the unshared model's on the
     same synced weights; tower parameters kept, the canonical MRI tower's
     statistics moved, the duplicate's not), and towers trained, unshared
     (K4-K7 40 each); K10 none in f32, in bf16 fprop 2 frozen and fprop 4,
     dgrad 2, wgrad 4 trained; step ms;
 21b. K10 (ops/narrow_conv.py), the PET towers' 1 -> 8 and 8 -> 16 blocks
     at a stage-3 tower's batch of 32 on the stage-3 shapes: each direction
     (fprop, dgrad of 8 -> 16, wgrad with db) against its plain version
     (cuDNN's bfloat16 conv and backward) on the operands it is timed on,
     the relative L2 distance within twice a bfloat16 rounding; the wgrad's
     bits repeat; device times beside cuDNN's and the bound;
 22. one step each of PETMRIEarlyFusion at BEST_HPARAMS (batch 64) under the
     per-scan min-max (K1 and K2 once) and the all-scan z-score (no kernel)
     and PETMRIFeatureMapFusion at BEST_MAXOUT_HPARAMS (batch 32) in maxout
     and concatenate, f32 and bf16: finite loss and gradients, step ms;
 23. on phase 15's split: a frozen train_anat_pet_fusion run, then one epoch
     of train_all_modalities_fusion.train over the three frozen stage-2
     checkpoints (shared towers; the checkpoint loads back through
     test_all_mod_fusion.load_fusion, duplicate towers equal to their
     canonical copies, running statistics moved), of
     train_early_fusion.train under both MRI normalisations and of
     train_anat_pet_featuremapfusion.train in maxout and concatenate (K2
     once per train and validation batch where the MRI takes the min-max),
     and the four test mains (test_all_mod_fusion,
     test_early_fusion_samenorm, test_early_fusion_differentnorm,
     test_featuremap_fusion) on a registry naming those checkpoints;
 24. on phase 15's split, train_anat_fast (ResNet-18 dilated=False, bf16):
     a K=2 seed screen of 1 epoch, then 1 epoch of the checkpointed
     continuation, which must start from the screen winner's snapshot;
 24b. provisioning: a raw ADNI layout at 91x109x91 in a temporary directory
     (data/synthetic.write_synthetic_adni: 40 subjects, T1w sessions with
     brain masks, tau-PET for some, Adni_merged, tau status and DXSUM
     tables with the manifest builder's edge cases), then
     tools/prepare_data's main: the split sizes (round(0.1 n) to test,
     then to val), no leakage, each split's T1w, PET and tabular rows
     against a count from the files and tables, check_manifest_shapes;
     every train-split T1w and mask decoded three ways (native_io.decode
     one by one, decode_batch on 8 threads, load_nifti), bit for bit
     equal, with volumes/s and bench_host's line; train_anat for one epoch
     on prepare_data's manifests (K2 once per train step and val batch),
     four times with the native decoder and the plain reader in turns
     (N P P N), then once more with one train step inside
     utils.profiling.trace, whose trace must hold K2's device event
     (minmax_apply_kernel); the epoch times, train
     volumes/s and the decode share (native ms per T1w + mask x the scans
     of the epoch / the epoch time); test_anat_cnn.main() on the test
     manifest (K2 once per test batch); soft_vote over the three runs'
     models on a val batch on the card, equal to the CPU's;
 25. the MRI search at full width: percentile_normalizer at q=0.99 over 16
     train + 8 val raw scans (K1 and K2 once per split, none for the
     resident q again), then run_parallel_trials with K=2 flagship AnatCNN
     trials (ResNet-18, dilated, f32, batch 8, 2 epochs), one with
     lr_pretrained traced to 0.0: its backbone parameters bit for bit
     unchanged, its running means moved, every val loss finite, each
     trial against the same trial alone within rtol 2e-3; ms per
     trial-epoch;
 26. fusion_hpo.run_frozen_fusion_trials for TabularMRIFusion: K=4 heads
     over one ResNet-18 fused_bn="full" MRI tower and the TabularMLP (256,
     1024) tower at full width, batch 8 of raw scans, f32 and bf16: per
     train step K1 1, K2 1, K4/K5 20 (not 20 x K) and K6/K7 0; step ms;
 27. at 48x56x48 (the TPE's first proposals are ResNet-50s with 20-epoch
     budgets): train_anat_cnn.optuna_optimization(n_trials=2, parallel=2)
     (K1/K2 twice per percentile) and a frozen
     train_mrt_tabular_fusion.optuna_optimization(n_trials=2, parallel=2)
     over random-weight checkpoints (K2 alone), on a split of 114 T1w and
     89 MRI+tabular training rows, so that every proposal's batch (up to
     64) takes a step an epoch: each study holds 2 finite values and
     some trial's val loss moves between epochs;
 28. the deployment chain: a reference-layout Anat_CNN (MedicalNet
     ResNet-18 dilated, conv_seg head, 3 classes; a replica built here,
     seeded weights, BatchNorm statistics of one batch of raw scans) saved
     as a Lightning-style .ckpt and converted by tools/convert_reference's
     main; the port checkpoint's logits at 91x109x91, batch 8, f32 with
     TF32 off, within CONVERT_TOL of the replica's;
 29. tools/export_artifact's main on that checkpoint in float, folded and
     int8 (a --calib npz of 8 raw scans), --batch 8: each artifact
     reloaded bit for bit the eager core the tool builds, folded and int8
     within the drift gates of float (argmax agreement 1.0, probabilities
     within 0.01), one int8 artifact call launching K9 20 times and K1, K2
     once; export seconds and artifact MB;
 30. tools/quality_eval's main at 91x109x91, depth 18, cut to
     QUALITY_EVAL, then --fusion alone at 48x56x48: every core finite over
     the eval set, folded agreeing with float;
 31. [dp] data parallelism (parallel/), a correctness run on the one card,
     no speed-up: (a) one nccl rank: Trainer(mesh=make_mesh()) SGD steps of
     the flagship AnatCNN at batch 8 of raw scans, fused_bn="full" and
     False, bit for bit the mesh-free steps, with step ms of both and the
     collectives per step; (b) two gloo ranks sharing the card (spawned,
     4 rows each): 3 SGD steps with fused_bn "full", False and "hybrid"
     against the one-process batch-8 run within JAX's DP tolerances (loss
     rtol 1e-5, state rtol 2e-4 atol 1e-5), one bf16 "full" step's loss
     within 1e-2, per-rank launches per step (K1 1, K2 1, K4-K7 20 each,
     K8 1: the [dp] steps are deterministic, cuDNN's deterministic
     algorithms and the stem pool's backward through K8);
     Predictor(mesh=) at rung 8 over the float32 and int8 cores (K9 20 a
     rank per call) within rtol 1e-3, atol 1e-3 of the one-process
     predictor with the argmax equal, and a BatchingServer round trip of
     8 requests on rank 0 while rank 1 follows; run_parallel_trials with
     the K=2 trials of phase 25 sharded (1 epoch), val history within rtol
     2e-3 of the unsharded run; TabPFNClassifier with its 4 members split,
     probabilities within 1e-5; (c) two nccl ranks on the one card: the
     outcome printed (NCCL refuses a GPU twice in one communicator);
 32. [tp] tensor and spatial parallelism (parallel/tp.py), a correctness
     run on the one card: (a) a (1, 1, 1) mesh over one nccl rank: its
     gathers (all_gather_into_tensor, reduce_scatter_tensor) give back
     their inputs, then the flagship SGD steps at global batch 4 of raw
     scans z-scored in the step (stem pool through K8) bit for bit the
     mesh-free steps, and 12 steps of each timed in turns (median, min,
     max), then one step of each profiled (wall, device and host time,
     the mesh step's collectives by host time; its kernels too above a
     5% gap); (b) a (1, 2, 2) mesh
     of four gloo ranks sharing the card at 91x109x91 (channels halved,
     depth 46 + 45): 2 steps "full", 2 False, 1 "full" with
     maxpool_impl="wf", each within JAX's tp tolerances (loss rtol 1e-5,
     gather_state's parameters and running statistics rtol 2e-4 atol
     1e-5) of the one-process run, and 1 bf16 "wf" step whose loss and
     update norms are within twice the gaps a one-bf16-ulp move of the
     scans opens in one process, plus 1e-3, and the same step with a
     planted fault (spatial rank 1 drops the halo planes it receives)
     failed by that rule; per-rank launches (K3 split
     1 + 1, K4-K7 20, K8 1 on spatial rank 0 and its window entry on rank
     1) and collectives by kind; (c) a (2, 2, 2) mesh of eight gloo ranks,
     depth 10 at 48x56x48, one "full" step within the same tolerances;
     then zscore_partials (within 1e-12 of plain), the split statistics
     (within 2e-6 of the whole scan's), zscore_apply and K8's depth
     windows of the 2- and 4-slab splits in float32 and bfloat16 (bit for
     bit) at the [tp] shapes, with device and plain times and bounds (K3s
     at batch 4 and 1 beside an empty launch of its grid, K8w at the
     interior and edge windows in both dtypes, with its slab plan);
 33. [fast mode]: tools/fast_mode_study.py's main at 48x56x48 (depth 10, 2
     seeds, 2 epochs): its JSON line complete and finite.
The kernels line before the last lists every kernel with the launches of
the path that ran it, its error against its plain version, its device time,
per-call time, plain and library time and bound; K4-K7 also per shape and
in bfloat16 (launches from the bf16 "full" step); K1-K7 also the f32
fusion step's launches, frozen and unfrozen ("launches_fusion"), the f32
stage-3 step's, frozen and towers trained ("launches_stage3"), the f32
early-fusion step's under both normalisations ("launches_early_fusion"),
and every kernel the HPO phases' launches ("launches_hpo": the seed
screen's run, the MRI search's normalization, the shared-tower fusion
search per train step in f32, and the two entry-point studies), and the
provisioning phase's train_anat run plus its test ("launches_provision");
every kernel the [dp] phase's per-rank launches of one "full" train step
and of one int8 predictor call on a two-rank mesh ("launches_dp"); K4-K8
and the [tp] entry points (zscore_partials, zscore_apply,
maxpool_bwd_window, each an entry of its own) the per-rank launches of
[tp] (b)'s "full" (K8: "wf") step ("launches_tp"), the entry points also
its collectives by kind ("collectives_tp"), K8w also the bf16 "wf" step's
("launches_bf16"), its bf16 and edge-window times and its slab plan, K3s
its batch-1 times and the empty launch of its grid;
K1-K3 also their host microseconds per call through the custom op and
direct.
K9's entry: launches from phase 7c's server run, per batch of the int8
serve, int8 stage 3, the exported program, the fused route and one
call of phase 29's int8 artifact ("launches_int8"; K1 and K2 carry the
same keys), the largest |kernel - plain| over the batch-8 shapes
and modes, device and bound ms summed over one forward's 20 convolutions
in the graph's modes at batch 8 (and 32), the same in float32-out mode
with per-call and plain ms, library_ms the torch._int_mm GEMMs of the
same shapes (not the same function), each shape's and mode's times, and
cuDNN's bf16 time as context. The BatchNorm kernels' entries carry
per-step totals (launches x time, launches x bound and launches x
aten's time over the five shapes, f32 and bf16). K10's entry: launches
of the bf16 stage-3 step with every tower trained, and of each stage-3
step by dtype and regime ("launches_stage3"), the largest |kernel - plain|
and relative L2 distance over its directions at batch 32, device, plain
(cuDNN's, the library call) and bound ms summed over a stage-3 step's K10
work (two towers), and each layer's and direction's ("per_shape").
Any failed check raises,
so the script exits non-zero without printing its last line,
{"ok": true, "device": {...}}. It needs one card and imports the
port only, and neither pandas, yaml nor the plotting packages: no confusion
image is rendered.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import io
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

from multimodal_alzheimer_tpu_torch.data import native_io
from multimodal_alzheimer_tpu_torch.data.csv_table import read_csv_rows
from multimodal_alzheimer_tpu_torch.data.nifti import load_nifti
from multimodal_alzheimer_tpu_torch.data.pipeline import DataLoader
from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.data.synthetic import (
    ArrayDataset,
    make_labeled_volumes,
    write_synthetic_adni,
    write_synthetic_split,
)
from multimodal_alzheimer_tpu_torch.inference import (
    harness,
    quantize,
    test_all_mod_fusion,
    test_anat_cnn,
    test_anat_pet_fusion,
    test_early_fusion_differentnorm,
    test_early_fusion_samenorm,
    test_featuremap_fusion,
    test_mri_tab_fusion,
    test_pet_cnn,
    test_pet_tab_fusion,
    test_tab,
)
from multimodal_alzheimer_tpu_torch.inference.export import (
    export_serve_fn,
    load_exported,
)
from multimodal_alzheimer_tpu_torch.inference.predictor import Predictor
from multimodal_alzheimer_tpu_torch.inference.quality import (
    compare_serve_cores,
    format_comparison,
)
from multimodal_alzheimer_tpu_torch.inference.quantize import (
    quantization_error,
    quantize_all_modalities_fusion,
)
from multimodal_alzheimer_tpu_torch.inference.server import BatchingServer
from multimodal_alzheimer_tpu_torch.losses.classification import (
    make_criterion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models import (
    train_all_modalities_fusion,
    train_anat_pet_featuremapfusion,
    train_anat_pet_fusion,
    train_early_fusion,
    train_mrt_tabular_fusion,
    train_pet_tabular_fusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.anat_pet_fusion import (
    AnatPETFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.early_fusion import (
    PETMRIEarlyFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.featuremap_fusion import (
    PETMRIFeatureMapFusion,
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
    int8_conv,
    narrow_conv,
)
from multimodal_alzheimer_tpu_torch.ops.maxpool import (
    NO_WINNER,
    max_pool3d_backward_plain,
    pool_forward,
    winner_offsets,
)
from multimodal_alzheimer_tpu_torch.ops.quantile import interpolate
from multimodal_alzheimer_tpu_torch.parallel import make_mesh
from multimodal_alzheimer_tpu_torch.parallel import tp
from multimodal_alzheimer_tpu_torch.parallel.launch import run_ranks
from multimodal_alzheimer_tpu_torch.tools.kernel_times import (
    BN_EPS,
    BN_KERNELS,
    BN_PER_STEP,
    BN_SHAPES,
    INT8_CONV_SHAPES,
    INT8_FORWARD,
    INT8_GEOMETRIES,
    INT8_MODES,
    INT8_OPS_PER_MS,
    NARROW_BATCH,
    NARROW_CALLS_PER_STEP,
    NARROW_LAYERS,
    STEM,
    TP_POOL,
    TP_ZSCORE,
    aten_pool_backward,
    bn_chain,
    bn_operands,
    bound,
    call_ms,
    device_ms,
    int8_conv_operands,
    int8_fused_operands,
    int8_fused_plain,
    int8_geometry_operands,
    norm_bounds,
    time_bn,
    time_int8_conv,
    time_narrow,
    time_norm,
    time_pool,
    time_tp,
)
from multimodal_alzheimer_tpu_torch.tools import (
    bench_host,
    convert_reference,
    export_artifact,
    fast_mode_study,
    prepare_data,
    quality_eval,
)
from multimodal_alzheimer_tpu_torch.tools.cases import (
    BASELINES,
    FUSION_HPARAMS,
    GRID,
    MINMAX,
    PET_NORM,
    QUANTILE,
    SEED,
    SERVE_CORES,
    calibration_batches,
    STAGE3_REGIMES,
    TAB_HPARAMS,
    baseline_batch,
    baseline_case,
    raw_batch,
    serve_core,
    serve_model,
    serve_preprocess,
    serve_requests,
    stage3_batch,
    stage3_model,
    stage3_preprocess,
)
from multimodal_alzheimer_tpu_torch.train import (
    fusion_hpo,
    hpo,
    loop,
    seed_screen,
    vmap_hpo,
)
from multimodal_alzheimer_tpu_torch.train.checkpoint import (
    TOWER_DUPLICATES,
    assert_tower_duplicates_equal,
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
from multimodal_alzheimer_tpu_torch.utils import profiling
from multimodal_alzheimer_tpu_torch.utils.majority_voting import soft_vote
from multimodal_alzheimer_tpu_torch.utils.plots_dataset import (
    check_manifest_shapes,
    check_no_subject_leakage,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

ZSCORE = {"per_scan_norm": "normalize"}
CSRC = "multimodal_alzheimer_tpu_torch/csrc/"
SOURCE = {"minmax_select": CSRC + "minmax_norm.cu",
          "minmax_apply": CSRC + "minmax_norm.cu",
          "zscore": CSRC + "zscore_norm.cu",
          "bn_stats": CSRC + "batch_norm.cu", "bn_apply": CSRC + "batch_norm.cu",
          "bn_grad_sum": CSRC + "batch_norm.cu", "bn_dx": CSRC + "batch_norm.cu",
          "maxpool_bwd": CSRC + "maxpool_bwd.cu",
          "int8_conv3d": CSRC + "int8_conv3d.cu",
          "narrow_conv3d": CSRC + "narrow_conv3d.cu"}
REPLACES = {"minmax_select": "multimodal_alzheimer_tpu/ops/pallas_norm.py:263",
            "minmax_apply": "multimodal_alzheimer_tpu/ops/pallas_norm.py:354",
            "zscore": "multimodal_alzheimer_tpu/ops/pallas_norm.py:63",
            "bn_stats": "multimodal_alzheimer_tpu/ops/pallas_bn.py:62",
            "bn_apply": "multimodal_alzheimer_tpu/ops/pallas_bn.py:75",
            "bn_grad_sum": "multimodal_alzheimer_tpu/ops/pallas_bn.py:82",
            "bn_dx": "multimodal_alzheimer_tpu/ops/pallas_bn.py:96",
            "maxpool_bwd": "multimodal_alzheimer_tpu/ops/pallas_maxpool.py:98",
            "int8_conv3d":
                "multimodal_alzheimer_tpu/inference/quantize.py:125",
            # no Pallas kernel: XLA's bf16 conv of flax nn.Conv
            "narrow_conv3d": "none: multimodal_alzheimer_tpu/models/"
                             "layers.py:403"}
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
# The entry points only a depth-sharded step launches (the [tp] phase).
TP_KERNELS = ("zscore_partials", "zscore_apply", "maxpool_bwd_window")
NO_TP_LAUNCHES = dict.fromkeys(TP_KERNELS, 0)
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
# The raw ADNI layout the provisioning phase writes at 91x109x91
# (data/synthetic.write_synthetic_adni): 40 subjects split 32 / 4 / 4 by
# prepare_data, one or two T1w sessions each, tau-PET for the val and test
# subjects and every third training subject.
PROVISION = {"n_subjects": 40, "seed": 13}
DECODE_THREADS = 8
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
    fresh = not native_io.library_path().exists()
    start = time.perf_counter()
    native_io.build()  # raises with the compiler's output
    seconds = time.perf_counter() - start
    check(native_io.available(), f"the native decoder loads: "
          f"{native_io.build_log()}")
    log(f"[build] {native_io.library_path().name} "
        f"{'built' if fresh else 'found'} in {seconds:.2f} s "
        f"({native_io.CXX} {' '.join(native_io.CXXFLAGS)} "
        f"{' '.join(native_io.LDFLAGS)}: {native_io.SOURCE.name})")


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
    """Raw serving requests: ``mri`` and ``mri_mask``, no memoised bounds
    (tools/cases.py)."""
    return serve_requests(n, seed, grid)


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
    model_cpu = serve_model()  # tools/cases.py: seed SEED, cls bias 1.0
    model = copy.deepcopy(model_cpu).to(device)
    preprocess = serve_preprocess()
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


def drive_server(predictor, requests, what: str) -> tuple:
    """``requests`` from N_CLIENTS client threads through a BatchingServer
    over ``predictor``, every launch count set to 0 just before and read
    just after; each result checked finite and equal to single-sample
    ``predict_batch`` within SERVE_TOL. Returns (results, launch counts,
    requests/s)."""
    n = len(requests)
    submitted, done = [0.0] * n, [0.0] * n
    futures = [None] * n

    def client(indices):
        for i in indices:
            submitted[i] = time.perf_counter()
            futures[i] = server.submit(requests[i])
            futures[i].add_done_callback(
                lambda _, i=i: done.__setitem__(i, time.perf_counter()))

    torch.cuda.synchronize()
    reset_launch_counts()
    server = BatchingServer(predictor, max_wait_s=0.05)
    try:
        threads = [threading.Thread(target=client,
                                    args=(range(k, n, N_CLIENTS),))
                   for k in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            check(not t.is_alive(), "client thread finished")
        results = [f.result(timeout=300) for f in futures]
        torch.cuda.synchronize()
        launches = launch_counts()
    finally:
        server.close()
    wall = max(done) - min(submitted)
    latency = [d - s for s, d in zip(submitted, done)]
    log(f"[{what}] {n} requests from {N_CLIENTS} clients: batch "
        f"histogram {dict(sorted(server.batch_histogram.items()))}, "
        f"{n / wall:.2f} requests/s, p50 latency "
        f"{statistics.median(latency) * 1e3:.1f} ms, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    check(server.samples_served == n, "every request served")
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
    log(f"[{what}] all {n} results finite and equal to single-sample "
        f"predict_batch within {SERVE_TOL}")
    return results, launches, n / wall


def phase_serve(model, preprocess, device, grid=GRID) -> dict:
    predictor = Predictor(model, batch_size=32, ladder=(8,), device=device,
                          preprocess=preprocess)
    requests = make_requests(N_REQUESTS, grid, SEED + 3)
    start = time.perf_counter()
    predictor.warmup(_stack(requests[:1]), parts=True)
    log(f"[serve] warmup of rungs {predictor.ladder} in "
        f"{time.perf_counter() - start:.2f} s")
    _, launches, _ = drive_server(predictor, requests, "serve")
    for name in ("minmax_select", "minmax_apply"):
        check(launches[name] > 0, f"{name} launched during serving")
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
            **hopper_maxpool.LAUNCHES, **int8_conv.LAUNCHES}


def reset_launch_counts() -> None:
    hopper_norm.reset_launches()
    hopper_bn.reset_launches()
    hopper_maxpool.reset_launches()
    int8_conv.reset_launches()


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
            "maxpool_bwd": 0, "int8_conv3d": 0, **NO_TP_LAUNCHES,
            **dict.fromkeys(BN_KERNELS, BN_LAYERS)}
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
                "zscore": 0, "maxpool_bwd": 0, "int8_conv3d": 0,
                **NO_TP_LAUNCHES,
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
def entry_split(grid=GRID, split=SPLIT):
    """A synthetic split at ``grid`` written by the port into a temporary
    directory, which is the CWD and ``MMALZ_DATA_DIR``'s root meanwhile."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        start = time.perf_counter()
        write_synthetic_split(os.path.join(root, "data"),
                              volume_shape=tuple(grid), **split)
        n_files = len(os.listdir(os.path.join(root, "data", "images")))
        log(f"[entry] wrote the split {split} at {grid}: {n_files} NIfTI "
            f"files in {time.perf_counter() - start:.2f} s")
        os.environ["MMALZ_DATA_DIR"] = os.path.join(root, "data")
        os.chdir(root)
        try:
            yield root
        finally:
            os.chdir(cwd)
            os.environ.pop("MMALZ_DATA_DIR", None)


@contextlib.contextmanager
def plain_reader():
    """The dataset and the volume cache decode with the plain reader
    (data/nifti.load_nifti) meanwhile, as they did before the native
    decoder was on their path."""
    decode = native_io.decode
    native_io.decode = load_nifti
    try:
        yield
    finally:
        native_io.decode = decode


def run_train_anat(device, root, hp: dict, name: str, want: dict) -> tuple:
    """train_anat as experiment ``name`` in ``root`` (the CWD), its launch
    counts checked against ``want``; returns (seconds, the epoch record,
    the launch counts, the val-loss checkpoint, the last val loss)."""
    reset_launch_counts()
    start = time.perf_counter()
    last = train_anat_cnn.train_anat(hp, name, log_confusion_images=False,
                                     device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = launch_counts()
    run_dir = os.path.join(root, train_anat_cnn.LOG_DIRECTORY, name,
                           "version_0")
    record = _epoch_record(run_dir)
    check(record["val_loss_epoch"] == last, f"{name}: val loss returned")
    check(launches == want, f"{name} launches {launches} == {want}")
    best = sorted(glob.glob(os.path.join(run_dir, "checkpoints",
                                         "*val_loss=*")))
    check(len(best) == 1, f"{name}: one val-loss checkpoint: {best}")
    return seconds, record, launches, best[0], last


def decoder_turns(device, root, hp: dict, name: str, want: dict) -> tuple:
    """train_anat four times on one split, the native decoder and the
    plain reader in turns (native, plain, plain, native), each checked
    against ``want``; returns the first run's ``run_train_anat`` tuple and
    the epoch records of each way."""
    records = {"native": [], "plain": []}
    first = None
    for i, way in enumerate(("native", "plain", "plain", "native")):
        with plain_reader() if way == "plain" else contextlib.nullcontext():
            run = run_train_anat(device, root, hp,
                                 name if i == 0 else f"{name}_{way}{i}",
                                 want)
        first = first or run
        records[way].append(run[1])
    return first, records["native"], records["plain"]


def _epochs(records: list, key: str = "epoch_time_s") -> str:
    return " / ".join(f"{r[key]:.4f}" for r in records)


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

    want = {**dict.fromkeys(launch_counts(), 0),
            "minmax_apply": steps + val_batches}
    (seconds, record, launches["train_anat"], best, last), native, plain = \
        decoder_turns(device, root, hp, "chip_smoke_anat", want)
    _load_back(best)
    log(f"[entry] train_anat: 1 epoch of {n_train} train + {n_val} "
        f"val scans from disk at batch {hp['batch_size']} "
        f"(ResNet-18, memoised min-max, native decoder): {seconds:.2f} s "
        f"in all, epoch {record['epoch_time_s']:.2f} s, "
        f"{record['train_volumes_per_s']:.2f} train volumes/s, val "
        f"loss {last:.6f}, launches {launches['train_anat']}")
    log(f"[entry] train_anat epochs, native decoder / plain reader (the "
        f"decoding before the native decoder) in turns N P P N on the same "
        f"split: native "
        f"{_epochs(native)} s, plain {_epochs(plain)} s; train volumes/s "
        f"native {_epochs(native, 'train_volumes_per_s')}, plain "
        f"{_epochs(plain, 'train_volumes_per_s')}")

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
                f"mri_cnn_2_class: '{best}'\n")
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
    return launches, best


@contextlib.contextmanager
def provision_root(grid=GRID, layout=PROVISION):
    """A raw ADNI layout at ``grid`` (data/synthetic.write_synthetic_adni)
    in a temporary directory, which is the CWD, with ``MMALZ_DATA_DIR`` at
    its ``data/`` meanwhile; yields (root, the layout's paths)."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        start = time.perf_counter()
        tables = write_synthetic_adni(os.path.join(root, "raw"),
                                      volume_shape=tuple(grid), **layout)
        n_files = sum(len(files) for _, _, files in
                      os.walk(tables["bids_root"]))
        log(f"[provision] wrote the raw ADNI layout {layout} at {grid}: "
            f"{n_files} files under bids/ and three tables in "
            f"{time.perf_counter() - start:.2f} s")
        os.environ["MMALZ_DATA_DIR"] = os.path.join(root, "data")
        os.chdir(root)
        try:
            yield root, tables
        finally:
            os.chdir(cwd)
            os.environ.pop("MMALZ_DATA_DIR", None)


def _expected_rows(tables: dict, subjects: list, dropped: set) -> dict:
    """Manifest rows the layout holds for ``subjects``, counted from the
    files and tables: T1w sessions (less the subjects whose diagnosis is
    missing or too far), tau rows, and tabular rows without a gap."""
    bids = tables["bids_root"]
    mri = sum(len(glob.glob(os.path.join(bids, sub, "anat", "ses-*",
                                         "*_reg_ants2_MNI_2mm.nii.gz")))
              for sub in subjects if sub not in dropped)
    pet = sum(r["ID"] in subjects for r in read_csv_rows(
        tables["tau_status"]))
    tab = sum(r["RID"] in subjects and all(
        v is not None for k, v in r.items() if k != "VISCODE")
        for r in read_csv_rows(tables["adni_merged"]))
    return {"t1w": mri, "pet1451": pet, "tabular": tab}


def _bits_equal(a, b) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype == np.float32
            and np.array_equal(a.view(np.uint32), b.view(np.uint32)))


@contextlib.contextmanager
def traced_step(log_dir: str, step: int = 1):
    """The ``step``-th train step (from 0) of every Trainer built meanwhile
    runs inside utils.profiling.trace(log_dir), the card synchronised
    before the trace stops."""
    make = loop.make_train_step

    def traced_make(*args, **kwargs):
        train_step, calls = make(*args, **kwargs), [0]

        def traced(state, batch):
            calls[0] += 1
            if calls[0] != step + 1:
                return train_step(state, batch)
            with profiling.trace(log_dir):
                out = train_step(state, batch)
                torch.cuda.synchronize()
            return out
        return traced

    loop.make_train_step = traced_make
    try:
        yield
    finally:
        loop.make_train_step = make


def phase_provision(device, root, tables: dict, grid=GRID) -> dict:
    """prepare_data on the raw layout, the train split decoded three ways,
    train_anat (native decoder, plain reader, one step traced) and
    test_anat_cnn.main() on its manifests, soft_vote on the card; returns
    the launch counts of the native run and the test."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    check(native_io.available(), "the native decoder is on the data path")
    printed = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        paths = prepare_data.main([
            "--adni-merged", tables["adni_merged"],
            "--bids-root", tables["bids_root"],
            "--tau-status", tables["tau_status"],
            "--diagnosis", tables["diagnosis"],
            "--out-dir", "data", "--split-json", "data_set_split.json"])
    seconds = time.perf_counter() - start
    for line in printed.getvalue().splitlines():
        log(f"[provision] prepare_data: {line}")
    with open("data_set_split.json") as f:
        split = json.load(f)
    n = len({r["RID"] for r in read_csv_rows(tables["adni_merged"])})
    n_test = round(0.1 * n)
    sizes = {"train": n - n_test - round(0.1 * (n - n_test)),
             "val": round(0.1 * (n - n_test)), "test": n_test}
    check({k: len(v) for k, v in split.items()} == sizes,
          f"split sizes {[len(v) for v in split.values()]} == {sizes}")
    check_no_subject_leakage(split)
    rows = {mode: read_csv_rows(path) for mode, path in paths.items()}
    # the layout's first two training subjects have no diagnosis within
    # 150 days of their scans (write_synthetic_adni)
    dropped = set(split["train"][:2])
    for mode, got in rows.items():
        want = _expected_rows(tables, split[mode], dropped)
        counts = {"t1w": sum(r["path_anat"] is not None for r in got),
                  "pet1451": sum(r["path_pet1451"] is not None for r in got),
                  "tabular": sum(r["AGE"] is not None for r in got)}
        check(counts == want and len(got) == sum(want.values()),
              f"{mode} manifest rows {counts} == {want}")
        check_manifest_shapes(got, expected_shape=tuple(grid))
        log(f"[provision] {mode}: {len(split[mode])} subjects, rows "
            f"{counts}, shapes {tuple(grid)}")
    log(f"[provision] prepare_data.main in {seconds:.2f} s, no leakage")

    # decode only: every train-split T1w and mask, three ways
    t1w = [r["path_anat"] for r in rows["train"] if r["path_anat"]]
    masks = [r["path_anat_mask"] for r in rows["train"] if r["path_anat"]]
    times, decoded = {}, {}
    for way, fn in (
            ("native", lambda ps: [native_io.decode(p) for p in ps]),
            ("native_batch", lambda ps: list(native_io.decode_batch(
                ps, tuple(grid), DECODE_THREADS))),
            ("plain", lambda ps: [load_nifti(p) for p in ps])):
        for kind, files in (("t1w", t1w), ("mask", masks)):
            start = time.perf_counter()
            decoded[way, kind] = fn(files)
            times[way, kind] = time.perf_counter() - start
    for kind in ("t1w", "mask"):
        check(all(_bits_equal(a, b) and _bits_equal(a, c)
                  for a, b, c in zip(decoded["native", kind],
                                     decoded["native_batch", kind],
                                     decoded["plain", kind])),
              f"{kind}: the three decodes equal")
    n_files = len(t1w)
    for way in ("native", "native_batch", "plain"):
        threads = f" ({DECODE_THREADS} threads)" * (way == "native_batch")
        log(f"[provision] decode {way}{threads}: {n_files} T1w in "
            f"{times[way, 't1w']:.4f} s ({n_files / times[way, 't1w']:.2f} "
            f"volumes/s), {n_files} masks in {times[way, 'mask']:.4f} s "
            f"({n_files / times[way, 'mask']:.2f} volumes/s)")
    log(f"[provision] the three decodes equal bit for bit "
        f"({2 * n_files} volumes at {tuple(grid)}; T1w "
        f"{os.path.getsize(t1w[0]) / 2 ** 20:.2f} MiB gzipped, mask "
        f"{os.path.getsize(masks[0]) / 2 ** 20:.3f} MiB)")
    host = io.StringIO()
    with contextlib.redirect_stdout(host):
        bench_host.main()
    log(f"[provision] host: {host.getvalue().strip()}")
    del decoded

    hp = train_anat_cnn.sample_hparams(FixedTrial())
    hp["max_epochs"] = 1
    trainset, valset = build_datasets(hp, ["t1w"])
    n_train, n_val = len(trainset), len(valset)
    check(not np.isnan(trainset.get_label_distribution()[0]).any(),
          "every class in the training split")
    steps = _batches(n_train, hp["batch_size"])
    val_batches = _batches(n_val, hp["batch_size"])
    want = {**dict.fromkeys(launch_counts(), 0),
            "minmax_apply": steps + val_batches}
    launches = {}
    (seconds, record, launches["train_anat"], best, last), native, plain = \
        decoder_turns(device, root, hp, "provision_anat", want)
    # decode share: ms per T1w + mask (one thread) x the scans an epoch
    # decodes (train and val) / the epoch's time, each way's mean epoch
    shares = {}
    for way, records in (("native", native), ("plain", plain)):
        ms = 1e3 * (times[way, "t1w"] + times[way, "mask"]) / n_files
        epoch = statistics.mean(r["epoch_time_s"] for r in records)
        shares[way] = (ms, epoch, ms * (n_train + n_val) / (1e3 * epoch))
    log(f"[provision] train_anat: 1 epoch of {n_train} train + {n_val} val "
        f"scans from prepare_data's manifests at batch {hp['batch_size']}: "
        f"{seconds:.2f} s in all, val loss {last:.6f}, launches "
        f"{launches['train_anat']}; epochs in turns N P P N: native "
        f"{_epochs(native)} s, plain {_epochs(plain)} s; train volumes/s "
        f"native {_epochs(native, 'train_volumes_per_s')}, plain "
        f"{_epochs(plain, 'train_volumes_per_s')}")
    for way, (ms, epoch, share) in shares.items():
        log(f"[provision] decode share, {way}: {ms:.3f} ms a T1w + mask "
            f"(one thread) x {n_train + n_val} scans / {epoch:.4f} s (mean "
            f"epoch) = {share:.4f}")

    trace_dir = os.path.join(root, "trace")
    with traced_step(trace_dir):
        run_train_anat(device, root, hp, "provision_anat_traced", want)
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    check(len(files) == 1, f"one trace written: {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    k2 = [e for e in events if e.get("cat") == "kernel"
          and "minmax_apply_kernel" in e.get("name", "")]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    check(len(k2) == 1, f"the traced step holds one K2 device event "
          f"(csrc/minmax_norm.cu minmax_apply_kernel): {len(k2)} of "
          f"{kernels} kernel events")
    log(f"[provision] one train step traced by utils.profiling.trace: "
        f"{os.path.getsize(files[0]) / 2 ** 20:.2f} MiB, {kernels} kernel "
        f"events, K2 (name, us) {[(e['name'][:48], e['dur']) for e in k2]}")

    with open("path_config.yaml", "w") as f:
        f.write("relative:\n"
                "  test_set_csv: 'data/test_path_data_labels.csv'\n"
                f"mri_cnn_2_class: '{best}'\n")
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
    log(f"[provision] test_anat_cnn.main(): {n_test} paired test rows in "
        f"{seconds:.2f} s, test loss {metrics['test_loss_epoch']:.6f}, F1 "
        f"{metrics['test_f1_epoch']:.4f}, launches {launches['test']}")

    # soft vote over the three runs' models on a val batch, on the card
    preprocess = valset.get_device_preprocess()
    batch = preprocess(_stack([valset[i] for i in range(min(n_val, 8))],
                              device))
    logits = []
    for name in ("provision_anat", "provision_anat_plain1",
                 "provision_anat_traced"):
        checkpoint = glob.glob(os.path.join(
            root, train_anat_cnn.LOG_DIRECTORY, name, "version_0",
            "checkpoints", "*val_loss=*"))[0]
        state_dict, hparams, _ = load_checkpoint(checkpoint)
        model = AnatCNN.from_hparams(hparams).to(device).eval()
        model.load_state_dict(state_dict)
        with torch.inference_mode():
            logits.append(model(batch)["logits"].float())
    for weights in (None, [0.9, 0.6, 0.75]):
        got = soft_vote(logits, weights)
        want = soft_vote([l.cpu() for l in logits], weights)
        check(got.device.type == "cuda" and torch.equal(got.cpu(), want),
              f"soft_vote on the card {got.tolist()} == CPU {want.tolist()}")
    log(f"[provision] soft_vote of 3 models' logits over {len(got)} val "
        f"scans on the card equals the CPU's, unweighted and weighted: "
        f"{got.tolist()}")
    return {k: launches["train_anat"][k] + launches["test"][k]
            for k in launches["test"]}


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
    batch, (mean, std) = raw_batch(("mri", "tabular"), grid, SEED + 14,
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
                    "maxpool_bwd": 0, "int8_conv3d": 0, **NO_TP_LAUNCHES,
                    "bn_stats": BN_LAYERS,
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
            batch, _ = raw_batch(("mri", "pet1451"), grid, SEED + 15,
                                    device)
            hp = dict(FUSION_HPARAMS, lr_pretrained=1e-5)
            model = AnatPETFusion.from_hparams(hp, pet_hp, TRAIN_HPARAMS,
                                               generator=gen)
            preprocess = make_device_preprocess(PET_NORM, MINMAX, QUANTILE)
            heads = train_anat_pet_fusion.HEAD_NAMES
            want = dict(zero, minmax_select=1, minmax_apply=1)
        else:
            batch, (mean, std) = raw_batch(("pet1451", "tabular"), grid,
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
                              pet_checkpoint: str) -> tuple:
    """train_tabular.train and test_tab.main() (the MLP checkpoint and a
    random-weight TabPFN checkpoint at depth 2, refit in context), the
    three stage-2 train() from the MRI, PET and tabular checkpoints, and
    their test mains, on the split in ``root`` (the CWD); returns each
    one's seconds and the checkpoints ('path_tabular' and each stage-2
    one's name)."""
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
    return seconds, dict(best, path_tabular=tab_checkpoint)


# Stage 3 at full width: AllModalitiesFusion over the flagship ResNet-18 MRI
# towers (dilated, fused_bn="full"), SmallPETCNN at its defaults and the
# TabularMLP (256, 1024) towers, batch 8 of raw scans normalised in the
# step. "frozen": every stage-2 model and stage 3 frozen, so the towers are
# shared; "trained": lr_pretrained at stage 2 and stage 3, unshared, both
# MRI towers trained.
# Shared against unshared eval logits on the same synced weights: the same
# kernels on the same inputs, so equal unless cuDNN picks another
# algorithm; held within 1e-6 of max(1, largest |logit|).
SHARE_TOL = 1e-6
# K10's launches in a stage-3 step by the rule: none in float32; in
# bfloat16 the forward of the PET towers' blocks 0 and 1 (frozen, the
# towers shared: one tower), trained also their weight gradients and block
# 1's input gradients, in both towers
STAGE3_K10 = {"float32 frozen": {"fprop": 0, "dgrad": 0, "wgrad": 0},
              "float32 trained": {"fprop": 0, "dgrad": 0, "wgrad": 0},
              "bfloat16 frozen": {"fprop": 2, "dgrad": 0, "wgrad": 0},
              "bfloat16 trained": {"fprop": 4, "dgrad": 2, "wgrad": 4}}


def phase_stage3_step(device, grid=GRID, timed_steps: int = 3) -> tuple:
    """The full-width stage-3 train step in f32 and bf16, frozen (shared
    towers; first its eval logits against the unshared model's on the same
    weights) and towers trained, with launch counts and the tower
    parameters and statistics that moved; K10 launched by the rule alone
    (``STAGE3_K10``); returns the f32 steps' launch counts and every step's
    K10 launches ({"<dtype> <regime>": counts})."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch, (mean, std) = stage3_batch(device, grid)
    tab_hp = dict(TAB_HPARAMS, feature_mean=mean, feature_std=std)
    preprocess = stage3_preprocess()
    heads = train_all_modalities_fusion.HEAD_NAMES
    zero = dict.fromkeys(launch_counts(), 0)
    towers = tuple(p + "." for pair in TOWER_DUPLICATES for p in pair)
    duplicates = tuple(d + "." for _, d in TOWER_DUPLICATES)
    out, k10 = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for regime, lr_pretrained in STAGE3_REGIMES.items():
            frozen = lr_pretrained is None
            run = f"{str(dtype)[6:]} {regime}"
            what = f"AllModalitiesFusion {run}"
            hp = dict(FUSION_HPARAMS, lr_pretrained=lr_pretrained)
            model = stage3_model(dtype, lr_pretrained, tab_hp,
                                 device=device)
            check(model.share_towers == frozen and model.freeze_towers
                  == frozen, f"{what}: share_towers {model.share_towers}")
            if frozen:
                twin = stage3_model(dtype, None, tab_hp, share_towers=False,
                                    device=device)
                with torch.inference_mode():
                    x = preprocess(batch)
                    got = model.eval()(x)["logits"]
                    want = twin.eval()(x)["logits"]
                gap = (got - want).abs().max().item()
                tol = SHARE_TOL * max(1.0, want.abs().max().item())
                check(gap <= tol, f"{what}: shared logits {gap} from the "
                      f"unshared model's (tolerance {tol})")
                log(f"[stage3 step] {what}: shared eval logits against "
                    f"the unshared model on the same synced weights: max "
                    f"abs err {gap:.3g} (tolerance {tol:.3g})")
                del twin, x, got, want
            optimizer = fusion_optimizer(hp, heads, model)
            step = make_train_step(model, make_criterion(hp), optimizer,
                                   preprocess)
            state = TrainState(model, optimizer)
            before = {k: v.clone() for k, v in model.state_dict().items()}
            torch.cuda.synchronize()
            reset_launch_counts()
            narrow_conv.reset_launches()
            state, aux = step(state, batch)
            torch.cuda.synchronize()
            launches = launch_counts()
            k10[run] = dict(narrow_conv.LAUNCHES)
            check(k10[run] == STAGE3_K10[run], f"{what} K10 launches "
                  f"{k10[run]} == {STAGE3_K10[run]}")
            loss = aux["loss"].item()
            n_fwd = BN_LAYERS * (1 if frozen else 2)
            n_bwd = 0 if frozen else 2 * BN_LAYERS
            want = dict(zero, minmax_select=1, minmax_apply=1,
                        bn_stats=n_fwd, bn_apply=n_fwd, bn_grad_sum=n_bwd,
                        bn_dx=n_bwd)
            check(launches == want, f"{what} launches {launches} == {want}")
            check(np.isfinite(loss), f"{what}: finite loss {loss}")
            head_norms = [p.grad.norm().item()
                          for n, p in model.named_parameters()
                          if n.split(".")[0] in heads]
            check(all(np.isfinite(v) and v > 0 for v in head_norms),
                  f"{what}: nonzero head gradients {head_norms}")
            after = model.state_dict()
            keys = [k for k in before if k.startswith(towers)]
            stats = [k for k in keys if "running" in k]
            params = [k for k in keys if k not in stats]
            kept = sum(torch.equal(after[k], before[k]) for k in params)
            moved = {k for k in stats if not torch.equal(after[k],
                                                         before[k])}
            moved_dup = sum(k.startswith(duplicates) for k in moved)
            n_dup = sum(k.startswith(duplicates) for k in stats)
            check(len(stats) == 2 * 2 * BN_LAYERS,
                  f"{what}: running statistics of two MRI towers")
            if frozen:
                check(kept == len(params) and moved_dup == 0
                      and len(moved) == len(stats) - n_dup,
                      f"{what}: {kept} of {len(params)} tower parameters "
                      f"kept, {len(moved)} statistics moved, {moved_dup} "
                      f"of them in duplicate towers")
            else:
                check(kept < len(params) // 10 and len(moved) == len(stats),
                      f"{what}: {kept} of {len(params)} tower parameters "
                      f"kept, {len(moved)} of {len(stats)} statistics moved")
            ms = _timed_steps(step, state, batch, timed_steps)
            out[(dtype, regime)] = launches
            log(f"[stage3 step] {what} (share_towers "
                f"{model.share_towers}), batch 8 at {grid}: loss {loss}, "
                f"median {ms:.2f} ms over {timed_steps} steps, launches "
                f"{launches}, K10 {k10[run]}; tower parameters kept {kept}/{len(params)}, "
                f"running statistics moved {len(moved)}/{len(stats)} "
                f"({moved_dup} in duplicate towers)")
            del model, optimizer, step, state, aux, before, after
    return {regime: out[(torch.float32, regime)]
            for regime in STAGE3_REGIMES}, k10


def phase_narrow_conv(device) -> dict:
    """K10 at a stage-3 tower's batch of 32 on the stage-3 shapes: each
    direction (fprop, dgrad of 8 -> 16, wgrad with db) against its plain
    version (cuDNN's bfloat16 conv and backward) on the operands it is
    timed on, the wgrad's bits on two calls, the device times beside
    cuDNN's and the bound; returns {layer: {direction: time_narrow's
    record}}."""
    gen = make_generator(SEED + 60, device)
    out, step_ms = {}, {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for layer in NARROW_LAYERS:
        out[layer] = time_narrow(layer, gen, device)
        for direction, r in out[layer].items():
            gaps = {direction: r["rel_l2"]}
            if direction == "wgrad":
                gaps["db"] = r["db"]["rel_l2"]
                check(r["repeats"], f"K10 {layer} wgrad repeats its bits "
                      f"at B={NARROW_BATCH}")
            for what, gap in gaps.items():
                # each is one bfloat16 rounding (2^-9 relative at most) of
                # a float32 sum of the same products
                check(gap <= 2.0 ** -8, f"K10 {layer} {what} at "
                      f"B={NARROW_BATCH}: relative distance {gap} to "
                      f"cuDNN within 2^-8")
            for key in step_ms:
                step_ms[key] += NARROW_CALLS_PER_STEP * r[key]
            log(f"[narrow conv] K10 {layer} {r['shape']} {direction} "
                f"B={NARROW_BATCH}: kernel {r['ms']:.4f} ms (per call "
                f"{r['call_ms']:.4f}), plain and library (cuDNN) "
                f"{r['library_ms']:.4f} ms (per call "
                f"{r['library_call_ms']:.4f}), bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), share {r['bound_ms'] / r['ms']:.3f}; "
                + ", ".join(f"{what} relative L2 distance to cuDNN "
                            f"{gap:.3g}" for what, gap in gaps.items())
                + f", max abs err {r['max_abs_err']:.3g}")
    log(f"[narrow conv] a stage-3 step's K10 work (two towers at "
        f"B={NARROW_BATCH}): kernel {step_ms['ms']:.3f} ms, cuDNN "
        f"{step_ms['library_ms']:.3f} ms, bound {step_ms['bound_ms']:.3f} "
        f"ms")
    return out


def phase_baseline_steps(device, grid=GRID, timed_steps: int = 2) -> dict:
    """One train step each of early fusion at BEST_HPARAMS (batch 64) under
    the per-scan min-max (K1 and K2 once) and the all-scan z-score (no
    kernel), and feature-map fusion at BEST_MAXOUT_HPARAMS (batch 32) in
    maxout and concatenate, in f32 and bf16, raw scans normalised in the
    step; returns the f32 early-fusion steps' launch counts."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    zero = dict.fromkeys(launch_counts(), 0)
    batch_max = baseline_batch(device, grid)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, (model_cls, _, _, k12) in BASELINES.items():
            model, hp, preprocess = baseline_case(name, dtype, device)
            n = hp["batch_size"]
            batch = {k: v[:n] for k, v in batch_max.items()}
            what = f"{model_cls.__name__} {name.split()[1]} {str(dtype)[6:]}"
            optimizer = single_lr_optimizer(model, hp["lr"])
            step = make_train_step(model, make_criterion(hp), optimizer,
                                   preprocess, make_generator(SEED, device))
            state = TrainState(model, optimizer)
            torch.cuda.synchronize()
            reset_launch_counts()
            start = time.perf_counter()
            state, aux = step(state, batch)
            loss = aux["loss"].item()
            first_s = time.perf_counter() - start
            launches = launch_counts()
            want = dict(zero, minmax_select=k12, minmax_apply=k12)
            check(launches == want, f"{what} launches {launches} == {want}")
            norms = [p.grad.norm().item() for p in model.parameters()]
            check(np.isfinite(loss) and all(np.isfinite(norms))
                  and norms[-1] > 0, f"{what}: finite loss {loss} and "
                  f"gradients, nonzero at the classifier")
            ms = _timed_steps(step, state, batch, timed_steps)
            if dtype == torch.float32 and model_cls is PETMRIEarlyFusion:
                out[name.split()[1]] = launches
            log(f"[baseline step] {what}, batch {n} at {grid}: loss {loss}, "
                f"first step {first_s:.3f} s, then median {ms:.2f} ms over "
                f"{timed_steps} steps ({n / ms * 1e3:.1f} train volumes/s), "
                f"launches {launches}")
            del model, optimizer, step, state, aux
    return out


def _entry_run(root, name: str, module, hp: dict, want: dict,
               device) -> tuple:
    """``module.train(hp)`` for one epoch on the split in ``root``, its
    launches checked against ``want``; returns (checkpoint, seconds, epoch
    record, launches)."""
    reset_launch_counts()
    start = time.perf_counter()
    last = module.train(dict(hp, max_epochs=1), f"chip_smoke_{name}",
                        log_confusion_images=False, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = launch_counts()
    check(launches == want, f"{name} launches {launches} == {want}")
    run_dir = os.path.join(root, module.LOG_DIRECTORY, f"chip_smoke_{name}",
                           "version_0")
    record = _epoch_record(run_dir)
    check(record["val_loss_epoch"] == last, "val loss returned")
    found = sorted(glob.glob(os.path.join(run_dir, "checkpoints",
                                          "*val_loss=*")))
    check(len(found) == 1, f"one val-loss checkpoint: {found}")
    return found[0], seconds, record, launches


def phase_stage3_entry_points(device, root, mri_checkpoint: str,
                              pet_checkpoint: str, stage2: dict) -> dict:
    """On the split in ``root`` (the CWD): a frozen PET+MRI stage-2 run, so
    that all three stage-2 checkpoints freeze their towers; then one epoch
    of train_all_modalities_fusion.train (frozen, shared towers: its
    checkpoint loads back through test_all_mod_fusion.load_fusion with its
    duplicate towers equal to their canonical copies), of
    train_early_fusion.train under both MRI normalisations and of
    train_anat_pet_featuremapfusion.train in maxout and concatenate; then
    the four test mains on a registry naming those checkpoints. Returns
    each run's seconds."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    zero = dict.fromkeys(launch_counts(), 0)
    seconds = {}
    paths = {"path_mri": mri_checkpoint, "path_pet": pet_checkpoint,
             "path_tabular": stage2["path_tabular"]}

    def k2_per_batch(hp, modalities) -> dict:
        trainset, valset = build_datasets(hp, modalities)
        check(not np.isnan(trainset.get_label_distribution()[0]).any(),
              f"both classes in the {modalities} training rows")
        return dict(zero, minmax_apply=_batches(len(trainset),
                                                hp["batch_size"])
                    + _batches(len(valset), hp["batch_size"]))

    hp = train_anat_pet_fusion.sample_hparams(
        _fusion_trial(None), n_classes=2, path_pet=pet_checkpoint,
        path_mri=mri_checkpoint)
    anat_pet, seconds["anat_pet_frozen"], _, _ = _entry_run(
        root, "anat_pet_frozen", train_anat_pet_fusion, hp,
        k2_per_batch(hp, ["pet1451", "t1w"]), device)
    hp = train_all_modalities_fusion.sample_hparams(
        _fusion_trial(None), n_classes=2, path_anat_pet=anat_pet,
        path_anat_tab=stage2["mri_tab"], path_pet_tab=stage2["pet_tab"],
        **paths)
    modalities = ["pet1451", "t1w", "tabular"]
    rows = [len(d) for d in build_datasets(hp, modalities)]
    stage3, seconds["stage3"], record, launches = _entry_run(
        root, "stage3", train_all_modalities_fusion, hp,
        k2_per_batch(hp, modalities), device)
    model, state_dict = test_all_mod_fusion.load_fusion(stage3)[:2]
    model.load_state_dict(state_dict)
    check(model.share_towers and model.freeze_towers,
          "the frozen stage-3 checkpoint shares its towers")
    assert_tower_duplicates_equal(state_dict)
    mri_sd = load_checkpoint(mri_checkpoint)[0]
    moved = {k: not torch.equal(state_dict[f"{dup}.{k}"], v)
             for dup in ("model_anat_pet.mri_model",
                         "model_anat_tab.mri_model")
             for k, v in mri_sd.items()}
    check(all(v == ("running" in k) for k, v in moved.items()),
          "both MRI tower copies: the stage-1 parameters kept, the running "
          "statistics moved and synced")
    log(f"[stage3 entry] train_all_modalities_fusion.train (frozen, shared "
        f"towers): 1 epoch of {rows[0]} train + {rows[1]} val rows at batch "
        f"{hp['batch_size']}, {seconds['stage3']:.2f} s in all, epoch "
        f"{record['epoch_time_s']:.2f} s, val loss "
        f"{record['val_loss_epoch']:.6f}, launches {launches}; its "
        f"checkpoint loads back through load_fusion with the duplicate "
        f"towers equal to their canonical copies, running statistics moved")

    best = {"all_mod_2_class": stage3}
    runs = (("early_fusion_same_norm_2_class", "early_samenorm",
             train_early_fusion, train_early_fusion.BEST_HPARAMS, False,
             PETMRIEarlyFusion),
            ("early_fusion_different_norm_2_class", "early_differentnorm",
             train_early_fusion,
             dict(train_early_fusion.BEST_HPARAMS,
                  mri_norm_style="per_scan", norm_percentile=QUANTILE),
             True, PETMRIEarlyFusion),
            ("featuremap_fusion_maxout_2_class", "featuremap_maxout",
             train_anat_pet_featuremapfusion,
             train_anat_pet_featuremapfusion.BEST_MAXOUT_HPARAMS, False,
             PETMRIFeatureMapFusion),
            ("featuremap_fusion_concat_2_class", "featuremap_concat",
             train_anat_pet_featuremapfusion,
             dict(train_anat_pet_featuremapfusion.BEST_MAXOUT_HPARAMS,
                  fusion_mode="concatenate"), False, PETMRIFeatureMapFusion))
    for key, name, module, hp, minmax, model_cls in runs:
        want = (k2_per_batch(hp, ["pet1451", "t1w"]) if minmax else zero)
        best[key], seconds[name], record, launches = _entry_run(
            root, name, module, hp, want, device)
        _load_back(best[key], model_cls=model_cls)
        log(f"[stage3 entry] {module.__name__.rsplit('.', 1)[1]}.train "
            f"({name.split('_', 1)[1]}): 1 epoch at batch "
            f"{hp['batch_size']}, {seconds[name]:.2f} s in all, epoch "
            f"{record['epoch_time_s']:.2f} s, val loss "
            f"{record['val_loss_epoch']:.6f}, launches {launches}")

    with open("path_config.yaml", "w") as f:
        f.write("relative:\n"
                "  test_set_csv: 'data/test_path_data_labels.csv'\n"
                + "".join(f"{k}: '{v}'\n" for k, v in best.items()))
    n_test = len(harness.build_testset({"n_classes": 2}))
    check(n_test > 0, "the paired three-modality test set has rows")
    mains = ((test_all_mod_fusion, {"all_mod_2_class":
                                    "test_set_all_mod_2_class"}, 8),
             (test_early_fusion_samenorm, {
                 "early_fusion_same_norm_2_class":
                     "test_set_early_fusion_samenorm"}, None),
             (test_early_fusion_differentnorm, {
                 "early_fusion_different_norm_2_class":
                     "test_set_early_fusion_differentnorm"},
              train_early_fusion.BEST_HPARAMS["batch_size"]),
             (test_featuremap_fusion, {
                 "featuremap_fusion_maxout_2_class": "test_set_fmf_maxout",
                 "featuremap_fusion_concat_2_class": "test_set_fmf_concat"},
              None))
    for tester, keys, k2_batch in mains:
        name = tester.__name__.rsplit(".", 1)[1]
        reset_launch_counts()
        start = time.perf_counter()
        results = tester.main(confusion_pngs=False, device=device)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - start
        launches = launch_counts()
        want = (dict(zero, minmax_apply=_batches(n_test, k2_batch))
                if k2_batch else zero)
        check(set(results) == set(keys) and launches == want,
              f"{name}: results for {sorted(results)}, launches {launches} "
              f"== {want}")
        for key, experiment in keys.items():
            metrics = results[key]
            check(all(np.isfinite(v) for v in metrics.values()),
                  f"{key}: finite metrics {metrics}")
            with open(os.path.join("lightning_logs", experiment,
                                   "version_0",
                                   "confusion_matrix.json")) as f:
                counts = json.load(f)["counts"]
            check(sum(map(sum, counts)) == n_test,
                  f"{key}: confusion counts {counts} over {n_test} rows")
            log(f"[stage3 entry] {name}.main() {key}: {n_test} paired test "
                f"rows, test loss {metrics['test_loss_epoch']:.6f}, F1 "
                f"{metrics['test_f1_epoch']:.4f}")
        log(f"[stage3 entry] {name}.main(): {seconds[name]:.2f} s, "
            f"launches {launches}")
    return seconds


# The HPO phases: the K-trial trainer at full width.
HPO_TRIALS = ({"lr": 1e-3, "lr_pretrained": 1e-5, "l2_reg": 1e-2,
               "fl_gamma": None, "trial_seed": 1},
              {"lr": 1e-3, "lr_pretrained": None, "l2_reg": 1e-2,
               "fl_gamma": 2, "trial_seed": 2})
# Each trial of the K=2 run against the same trial run alone: val losses
# within rtol 2e-3, the step floor of ROADMAP.md section C (one-ulp input
# moves open 6e-4 of a gradient norm at full width).
HPO_SOLO_RTOL = 2e-3
# The entry-point phase's grid: optuna_optimization's TPE draws ResNet-50
# and batch 32 in its first proposals with 20 epochs of budget, minutes at
# 91x109x91 (the full-width HPO checks are the three phases before it).
HPO_ENTRY_GRID = (48, 56, 48)
# n_subjects (96, 8, 8) from seed 3 at that grid: 114 training T1w rows
# and 89 MRI+tabular ones, so that the largest batch the spaces draw (64)
# takes a step every epoch (the phase logs each bucket's batch and rows;
# the writer draws the volumes and the manifest from one generator, so
# the counts hold for this grid only).
HPO_ENTRY_SPLIT = {"n_subjects": (96, 8, 8), "seed": 3}


class _RawSplit:
    """The quantile and device preprocess of an in-memory raw split, the
    two things ``percentile_normalizer`` reads of a dataset."""

    quantile = QUANTILE

    def get_device_preprocess(self):
        return make_device_preprocess(normalize_mri=MINMAX,
                                      quantile=self.quantile)


def _raw_split(n, grid, seed, modalities=("mri",)) -> dict:
    data = make_labeled_volumes(n, tuple(grid), n_classes=2, seed=seed,
                                modalities=modalities)
    data["label"] = (np.arange(n) % 2).astype(np.int32)
    return data


def _live_init(model, generator, example, shared_example):
    """The K-trial trainer's default init with the classifier bias at 1, as
    ``train_model`` sets it: the trailing ReLU on the logits passes
    gradient from the first step."""
    trial = vmap_hpo._default_init(model, generator, example, shared_example)
    with torch.no_grad():
        trial.head.cls.bias.fill_(1.0)
    return trial


class _StepClock:
    """Wraps a shared_fn: the host time between consecutive train-mode
    calls of one epoch, each one train step of every trial (the card
    synchronised at each call)."""

    def __init__(self, shared_fn, steps_per_epoch: int):
        self.shared_fn = shared_fn
        self.per_epoch = steps_per_epoch
        self.stamps = []

    def __call__(self, carry, batch, train):
        if train:
            torch.cuda.synchronize()
            self.stamps.append(time.perf_counter())
        return self.shared_fn(carry, batch, train)

    def step_ms(self) -> float:
        gaps = [(b - a) * 1e3 for i, (a, b) in enumerate(
            zip(self.stamps, self.stamps[1:])) if (i + 1) % self.per_epoch]
        return statistics.median(gaps)


def phase_hpo_mri(device, grid=GRID, n_train: int = 16, n_val: int = 8,
                  epochs: int = 2) -> dict:
    """The MRI search at full width: percentile_normalizer at q=0.99 over a
    raw split of 16 train + 8 val scans (K1 and K2 once per split), then
    run_parallel_trials with K=2 flagship AnatCNN trials (ResNet-18,
    dilated, f32) at batch 8 for 2 epochs, one with lr_pretrained traced to
    0.0 (its backbone parameters kept bit for bit, its BatchNorm statistics
    moved); each trial against the same trial alone. Returns the launches
    of the normalization."""
    torch.backends.cudnn.allow_tf32 = False
    data = _raw_split(n_train + n_val, grid, SEED + 21)
    train_raw = {k: v[:n_train] for k, v in data.items()}
    val_raw = {k: v[n_train:] for k, v in data.items()}
    torch.cuda.synchronize()
    reset_launch_counts()
    normalized = train_anat_cnn.percentile_normalizer(
        _RawSplit(), train_raw, val_raw, device)
    train, val = normalized(QUANTILE)
    torch.cuda.synchronize()
    norm_launches = launch_counts()
    want = dict(dict.fromkeys(norm_launches, 0), minmax_select=2,
                minmax_apply=2)
    check(norm_launches == want,
          f"percentile_normalizer launches {norm_launches} == {want}")
    check(normalized(QUANTILE)[0] is train and launch_counts() == want,
          "the resident percentile is reused without a launch")
    model = AnatCNN.from_hparams(TRAIN_HPARAMS, freeze_backbone=False)
    hp = vmap_hpo.stack_trial_hparams(HPO_TRIALS,
                                      extra_keys=("lr_pretrained",))
    kwargs = dict(batch_size=8, max_epochs=epochs, patience=epochs,
                  class_weights=[0.5, 0.5], seed=SEED,
                  apply_fn=vmap_hpo.plain_apply, init_fn=_live_init,
                  lr_select=train_anat_cnn.head_backbone_lr,
                  return_state=True, device=device)
    reset_launch_counts()
    start = time.perf_counter()
    last, info = vmap_hpo.run_parallel_trials(model, hp, train, val,
                                              **kwargs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    check(launch_counts() == dict.fromkeys(norm_launches, 0),
          f"no kernel inside the trials (normalised split, fused_bn=False):"
          f" {launch_counts()}")
    history = info["val_history"]
    check(history.shape == (epochs, 2) and np.isfinite(history).all(),
          f"finite val losses {history.tolist()}")
    params, stats, _ = info["carry"]
    init = _live_init(model, make_generator(
        vmap_hpo.trial_generator_seed(SEED, 2, 0)), None, None).state_dict()
    backbone = [k for k in params if k.startswith("backbone.")]
    kept = sum(torch.equal(params[k][1].cpu(), init[k]) for k in backbone)
    check(kept == len(backbone),
          f"frozen trial: {kept} of {len(backbone)} backbone parameters kept")
    head_moved = sum(not torch.equal(params[k][1].cpu(), init[k])
                     for k in params if k.startswith("head."))
    check(head_moved > 0, "frozen trial: its head moved")
    bn = [k for k in stats if k.endswith("running_mean")]
    moved = sum(not torch.equal(stats[k][1].cpu(), init[k]) for k in bn)
    check(moved == len(bn),
          f"frozen trial: {moved} of {len(bn)} running means moved")
    gap = param_gap = 0.0
    for i, row in enumerate(HPO_TRIALS):
        _, solo = vmap_hpo.run_parallel_trials(
            model, vmap_hpo.stack_trial_hparams(
                [row], extra_keys=("lr_pretrained",)), train, val, **kwargs)
        gap = max(gap, float(np.max(np.abs(
            solo["val_history"][:, 0] - history[:, i])
            / np.abs(history[:, i]))))
        check(gap <= HPO_SOLO_RTOL, f"trial {i} stacked vs solo: val "
              f"{history[:, i].tolist()} vs "
              f"{solo['val_history'][:, 0].tolist()}")
        param_gap = max([param_gap] + [float(
            (params[k][i] - solo["carry"][0][k][0]).abs().max())
            for k in params])
    epoch_ms = seconds * 1e3 / epochs / 2
    log(f"[hpo mri] percentile_normalizer q={QUANTILE}: {n_train} + {n_val}"
        f" scans at {grid}, launches {norm_launches}; K=2 ResNet-18 trials"
        f" (f32, batch 8, {epochs} epochs, {n_train // 8} steps an epoch):"
        f" {seconds:.2f} s, {epoch_ms:.1f} ms per trial-epoch (train and "
        f"val; PR 6: a ~200 ms f32 step), val {history.tolist()}, stop "
        f"{info['stopped_epoch'].tolist()}; frozen trial: backbone kept "
        f"{kept}/{len(backbone)}, running means moved {moved}/{len(bn)}; "
        f"each trial stacked vs solo: val rel gap {gap:.3g}, largest "
        f"parameter gap {param_gap:.3g}")
    return norm_launches


def phase_hpo_screen(device, root) -> dict:
    """train_anat_fast on the entry split (91x109x91, bf16, dilated=False):
    a K=2 seed screen of 1 epoch, then 1 epoch of the continuation, which
    must start from the winner's snapshot; returns its launches."""
    screens, starts = [], []
    real_screen, real_run = seed_screen.screen_seeds, \
        train_anat_cnn.run_training

    def screen(*args, **kwargs):
        out = real_screen(*args, **kwargs)
        screens.append(dict(out))
        return out

    def run(model, hparams, *args, variables_transform, **kwargs):
        starts.append(variables_transform(model.state_dict()))
        return real_run(model, hparams, *args,
                        variables_transform=variables_transform, **kwargs)

    hp = train_anat_cnn.sample_hparams(FixedTrial())
    hp.update(max_epochs=1, best_k_checkpoints=1)
    seed_screen.screen_seeds, train_anat_cnn.run_training = screen, run
    try:
        reset_launch_counts()
        start = time.perf_counter()
        last, out = train_anat_cnn.train_anat_fast(
            hp, "chip_smoke_fast", screen_k=2, screen_epochs=1,
            log_confusion_images=False, device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    finally:
        seed_screen.screen_seeds, train_anat_cnn.run_training = \
            real_screen, real_run
    launches = launch_counts()
    winner = screens[0]["winner_variables"]
    check(np.isfinite(last) and np.isfinite(out["best_val"]).all(),
          f"finite screen and fit: {out['best_val'].tolist()}, {last}")
    check(set(starts[0]) == set(winner) and all(
        torch.equal(starts[0][k], v) for k, v in winner.items()),
        "the continuation starts from the winner's snapshot")
    log(f"[hpo screen] train_anat_fast (ResNet-18 dilated=False, bf16, "
        f"batch 8): screen K=2 x 1 epoch {out['screen_wall_s']} s, winner "
        f"seed {out['winner_seed']} (best val {out['best_val'].tolist()}), "
        f"continuation 1 epoch {out['fit_wall_s']} s from the winner's "
        f"snapshot, val loss {last:.6f}; {seconds:.2f} s in all, launches "
        f"{launches}")
    return launches


def phase_hpo_fusion(device, grid=GRID, k: int = 4, steps: int = 3,
                     epochs: int = 2) -> dict:
    """fusion_hpo.run_frozen_fusion_trials for TabularMRIFusion: K=4 heads
    over one ResNet-18 fused_bn="full" MRI tower and the TabularMLP (256,
    1024) tower at full width, batch 8 of raw scans (K1 and K2 per step,
    bounds not memoised), f32 and bf16: per train step K1 1, K2 1, K4/K5
    20 and K6/K7 0, not K times that; returns the f32 launches per step."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    data = _raw_split(8 * steps + 8, grid, SEED + 22, ("mri", "tabular"))
    train = {key: v[:8 * steps] for key, v in data.items()}
    val = {key: v[8 * steps:] for key, v in data.items()}
    mean, std = compute_feature_stats(train["tabular"])
    rows = [{"lr": lr, "l2_reg": 1e-2, "fl_gamma": gamma, "trial_seed": i}
            for i, (lr, gamma) in enumerate(((1e-3, None), (3e-3, 2),
                                             (1e-2, None), (3e-4, 5)))][:k]
    per_step = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = make_generator(SEED)
        mri = AnatCNN.from_hparams(TRAIN_HPARAMS, fused_bn="full",
                                   freeze_backbone=False, dtype=dtype,
                                   generator=gen)
        tab = TabularMLP.from_hparams(dict(TAB_HPARAMS, feature_mean=mean,
                                           feature_std=std), dtype=dtype,
                                      generator=gen)
        head = TabularMRIFusion(2, copy.deepcopy(mri), copy.deepcopy(tab),
                                freeze_towers=True, dtype=dtype)
        shared_fn, carry0 = fusion_hpo.make_shared_towers_fn(
            {"mri": mri, "tab": tab},
            {"mri": mri.state_dict(), "tab": tab.state_dict()},
            make_device_preprocess(normalize_mri=MINMAX, quantile=QUANTILE),
            device)
        clock = _StepClock(shared_fn, steps)
        torch.cuda.synchronize()
        reset_launch_counts()
        start = time.perf_counter()
        _, info = fusion_hpo.run_shared_trials(
            head, clock, carry0, vmap_hpo.stack_trial_hparams(rows), train,
            val, batch_size=8, max_epochs=epochs, patience=epochs,
            class_weights=[0.5, 0.5], seed=SEED, return_state=True,
            device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = launch_counts()
        n_steps = steps * epochs
        n_eval = 1 + epochs  # the shape probe and one val batch an epoch
        want = {"minmax_select": n_steps + n_eval,
                "minmax_apply": n_steps + n_eval, "zscore": 0,
                "maxpool_bwd": 0, "int8_conv3d": 0, **NO_TP_LAUNCHES,
                "bn_stats": BN_LAYERS * n_steps,
                "bn_apply": BN_LAYERS * n_steps, "bn_grad_sum": 0,
                "bn_dx": 0}
        what = f"K={k} TabularMRIFusion heads {str(dtype)[6:]}"
        check(launches == want, f"{what} launches {launches} == {want}")
        check(np.isfinite(info["val_history"]).all(),
              f"{what}: finite val losses {info['val_history'].tolist()}")
        check(set(info["carry"][0]) == {
            f"{m}.{p}" for m in train_mrt_tabular_fusion.HEAD_NAMES
            for p in ("weight", "bias")}, f"{what}: only heads train")
        step = {key: (v - (n_eval if key.startswith("minmax") else 0))
                / n_steps for key, v in launches.items()}
        per_step[dtype] = step
        pr7 = {torch.float32: 49.61, torch.bfloat16: 21.47}[dtype]
        log(f"[hpo fusion] {what}, batch 8 at {grid}, {steps} steps x "
            f"{epochs} epochs: {seconds:.2f} s, median step "
            f"{clock.step_ms():.2f} ms (towers once + {k} head steps; PR 7's"
            f" single frozen TabularMRIFusion step {pr7} ms), launches per "
            f"train step {step}, val {info['val_history'].tolist()}")
        del head, mri, tab, shared_fn, carry0, info, clock
    return per_step[torch.float32]


def _frozen_study(module, n_classes, **paths):
    """A TPE study of the port whose first two proposals are frozen (the
    shared-tower path), found by seed."""
    for seed in range(200):
        study = hpo.TPEStudy(seed=seed)
        if all(module.sample_hparams(study.ask(), n_classes=n_classes,
                                     **paths)["lr_pretrained"] is None
               for _ in range(2)):
            return hpo.TPEStudy(seed=seed), seed
    raise RuntimeError("no seed below 200 gives two frozen proposals")


@contextlib.contextmanager
def _recorded_buckets():
    """Records each bucket the K-trial trainer runs: its batch size, its
    training rows and its val history (epochs, K)."""
    buckets, real = [], vmap_hpo.run_parallel_trials

    def run(model, hp, train_data, val_data, **kwargs):
        values, info = real(model, hp, train_data, val_data, **kwargs)
        buckets.append((kwargs["batch_size"], len(train_data["label"]),
                        info["val_history"]))
        return values, info

    vmap_hpo.run_parallel_trials = run
    try:
        yield buckets
    finally:
        vmap_hpo.run_parallel_trials = real


def _shapes(buckets) -> list:
    return [(batch, n, len(history)) for batch, n, history in buckets]


def _check_study(what: str, study, buckets) -> list:
    """Two finite values, every bucket a step an epoch, and some trial's
    val loss moving between epochs (a search that trains nothing, or
    only dead trials, holds each val loss at its init value)."""
    values = [v for v, _ in study.trials]
    check(len(values) == 2 and np.isfinite(values).all(),
          f"the {what} study holds 2 finite values: {values}")
    check(all(n >= batch for batch, n, _ in buckets),
          f"every {what} bucket takes a step an epoch: (batch, rows, "
          f"epochs) {_shapes(buckets)}")
    moved = [float(np.ptp(history[np.isfinite(history[:, i]), i]))
             for _, _, history in buckets
             for i in range(history.shape[1])]
    check(max(moved) > 0, f"some {what} trial's val loss moves: spreads "
          f"{moved}")
    return moved


def phase_hpo_entry_points(device, grid=HPO_ENTRY_GRID) -> dict:
    """train_anat_cnn.optuna_optimization(n_trials=2, parallel=2) and a
    frozen train_mrt_tabular_fusion.optuna_optimization(n_trials=2,
    parallel=2) from files on disk at HPO_ENTRY_GRID: 2 finite values
    each, some trial's val loss moving, K1/K2 twice per percentile (train
    and val split) in the MRI search, K2 alone (memoised bounds) in the
    fusion search."""
    out = {}
    with entry_split(grid, HPO_ENTRY_SPLIT) as root:
        reset_launch_counts()
        start = time.perf_counter()
        with _recorded_buckets() as buckets:
            study = train_anat_cnn.optuna_optimization(
                n_trials=2, parallel=2, device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = launch_counts()
        values = [v for v, _ in study.trials]
        qs = {p["norm_percentile"] for _, p in study.trials}
        moved = _check_study("MRI", study, buckets)
        want = dict(dict.fromkeys(launches, 0),
                    minmax_select=2 * len(qs), minmax_apply=2 * len(qs))
        check(launches == want, f"MRI study launches {launches} == {want}")
        out["mri"] = launches
        proposals = [(p["resnet_depth"], p["batch_size"],
                      p["norm_percentile"]) for _, p in study.trials]
        log(f"[hpo entry] train_anat_cnn.optuna_optimization(n_trials=2, "
            f"parallel=2) at {grid}: {seconds:.2f} s, values {values}, "
            f"proposals {proposals} (depth, batch, q), val-loss spreads "
            f"{moved}, buckets (batch, rows, epochs) {_shapes(buckets)}, "
            f"launches {launches}")

        mri_hp = dict(TRAIN_HPARAMS, norm_percentile=QUANTILE)
        tab_hp = dict(TAB_HPARAMS, feature_mean=[0.0] * 9,
                      feature_std=[1.0] * 9)
        paths = {}
        for name, model in (
                ("mri_cnn_2_class", AnatCNN.from_hparams(
                    mri_hp, generator=make_generator(SEED))),
                ("tabular_mlp_2_class", TabularMLP.from_hparams(
                    tab_hp, generator=make_generator(SEED)))):
            paths[name] = os.path.join(root, name)
            save_checkpoint(paths[name], model.state_dict(),
                            mri_hp if name.startswith("mri") else tab_hp)
        with open("path_config.yaml", "w") as f:
            f.write("".join(f"{k}: '{v}'\n" for k, v in paths.items()))
        frozen, seed = _frozen_study(
            train_mrt_tabular_fusion, 2, path_mri=paths["mri_cnn_2_class"],
            path_tabular=paths["tabular_mlp_2_class"])
        real_create = hpo.create_study
        hpo.create_study = lambda **_: frozen
        reset_launch_counts()
        start = time.perf_counter()
        try:
            with _recorded_buckets() as buckets:
                study = train_mrt_tabular_fusion.optuna_optimization(
                    n_trials=2, parallel=2, device=device)
            torch.cuda.synchronize()
        finally:
            hpo.create_study = real_create
        seconds = time.perf_counter() - start
        launches = launch_counts()
        values = [v for v, _ in study.trials]
        moved = _check_study("fusion", study, buckets)
        check(launches["minmax_select"] == 0 and launches["minmax_apply"] > 0
              and all(launches[k] == 0 for k in BN_KERNELS),
              f"fusion study launches {launches}: K2 alone")
        out["mri_tab"] = launches
        log(f"[hpo entry] frozen train_mrt_tabular_fusion.optuna_optimization"
            f"(n_trials=2, parallel=2) at {grid} (TPE seed {seed}): "
            f"{seconds:.2f} s, values {values}, batch sizes "
            f"{[p['batch_size'] for _, p in study.trials]}, val-loss spreads"
            f" {moved}, buckets (batch, rows, epochs) {_shapes(buckets)}, "
            f"launches {launches}")
    return out


# The serving extras: int8 drift against the float32 model within JAX's
# bounds (tests/test_quantize.py: argmax agreement 1.0, probability error
# below 0.01); the quality comparison's labeled set; the serving rungs.
INT8_DRIFT = {"argmax_agree": 1.0, "prob_max_abs_err": 0.01}
QUALITY = {"n": 32, "bootstrap": 200, "batch": 8, "seed": SEED + 40}
SERVE_RUNGS = (8, 32)
RESNET18_CONVS = 20  # 17 3^3/7^3 convolutions and 3 downsamples


def _check_k9_modes(what, x, w, scale, bias, args, gen) -> None:
    """K9 against its plain version, bit for bit, in float32-out mode
    (scale 1 and bias 0 for the int32 sums, then random scale and bias)
    and in every other epilogue mode of ``INT8_MODES``."""
    for s, b in ((torch.ones_like(scale), torch.zeros_like(bias)),
                 (scale, bias)):
        got = int8_conv.int8_conv3d(x, w, s, b, *args)
        torch.cuda.synchronize()
        want = int8_conv.int8_conv3d_plain(x, w, s, b, *args)
        check(torch.equal(got, want), f"K9 {what} equals plain")
    for mode in INT8_MODES:
        if mode == "f32":
            continue
        kw = int8_fused_operands(x, w, scale, bias, args, mode, gen)
        got = int8_conv.int8_conv3d_fused(x, w, scale, bias, *args, **kw)
        torch.cuda.synchronize()
        want = int8_fused_plain(x, w, scale, bias, args, kw)
        check(got.dtype == want.dtype and torch.equal(got, want),
              f"K9 {what} {mode} equals plain")


def phase_int8_conv(device, batch: int = 2, timed=SERVE_RUNGS) -> dict:
    """K9 against its plain version, bit for bit, in every epilogue mode
    (``INT8_MODES``: float32 out; ReLU and int8 out; a float32 or int8
    residual, ReLU, int8 or float32 out) at every convolution shape of the
    int8 ResNet-18 at batch ``batch``, and at ``INT8_GEOMETRIES``; then at
    each serving rung,
    per shape, K9 held to its plain version again in float32-out mode and
    in each mode the graph runs at that shape (``INT8_FORWARD``), with its
    device times beside the plain version's (the first rung, float32 out),
    the bound of the mode, ``torch._int_mm`` on im2col columns of the same
    M, N and K (the GEMM only, not the same function) and cuDNN's bfloat16
    convolution of the same shape as context."""
    gen = make_generator(SEED + 50, device)
    for name in INT8_CONV_SHAPES:
        _check_k9_modes(f"{name} B={batch}",
                        *int8_conv_operands(name, batch, gen, device), gen)
    for name in INT8_GEOMETRIES:
        _check_k9_modes(f"{name} B={batch}",
                        *int8_geometry_operands(name, batch, gen, device),
                        gen)
    log(f"[int8 conv] K9 equals its plain version bit for bit in all "
        f"{len(INT8_MODES)} epilogue modes at all {len(INT8_CONV_SHAPES)} "
        f"convolution shapes of ResNet-18 and {len(INT8_GEOMETRIES)} more "
        f"geometries (INT8_GEOMETRIES), B={batch}")
    log(f"[int8 conv] bounds assume {INT8_OPS_PER_MS / 1e9:.0f} TOP/s int8 "
        f"dense tensor cores and 3.35 TB/s HBM (H100 SXM)")
    times = {}
    for b in timed:
        times[b] = {}
        total = dict.fromkeys(("ms", "bound_ms", "library_ms",
                               "cudnn_bf16_ms", "graph_ms",
                               "graph_bound_ms"), 0.0)
        for name in INT8_CONV_SHAPES:
            count = INT8_CONV_SHAPES[name][-1]
            times[b][name] = {}
            for mode in ["f32"] + [m for m in INT8_FORWARD[name]
                                   if m != "f32"]:
                r = time_int8_conv(name, b, gen, device,
                                   plain=b == timed[0] and mode == "f32",
                                   mode=mode)
                check(r["equal"], f"K9 {name} B={b} {mode} equals plain "
                      f"(max |kernel - plain| {r['max_abs_err']})")
                times[b][name][mode] = r
                runs = INT8_FORWARD[name].get(mode, 0)
                total["graph_ms"] += runs * r["ms"]
                total["graph_bound_ms"] += runs * r["bound_ms"]
                extra = "".join(
                    f", {label} {r[key]:.4f} ms" for key, label in (
                        ("plain_ms", "plain"),
                        ("library_ms", "torch._int_mm GEMM only"),
                        ("cudnn_bf16_ms", "cuDNN bf16 conv3d (context)"))
                    if r[key] is not None)
                log(f"[int8 conv] {name} B={b} {mode}: equal to plain, max "
                    f"|kernel - plain| {r['max_abs_err']}; kernel "
                    f"{r['ms']:.4f} ms (per call {r['call_ms']:.4f}), bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share "
                    f"{r['bound_ms'] / r['ms']:.3f}{extra}")
            for key in ("ms", "bound_ms", "library_ms", "cudnn_bf16_ms"):
                total[key] += count * times[b][name]["f32"][key]
        times[b]["total"] = total
        log(f"[int8 conv] one ResNet-18 forward's 20 convolutions at B={b}: "
            f"K9 in the graph's modes {total['graph_ms']:.3f} ms (bound "
            f"{total['graph_bound_ms']:.3f}); all float32 out "
            f"{total['ms']:.3f} ms (bound {total['bound_ms']:.3f}); "
            f"torch._int_mm GEMMs alone {total['library_ms']:.3f} ms; cuDNN "
            f"bf16 {total['cudnn_bf16_ms']:.3f} ms")
    return times


def phase_op_overhead(device, batch: int = 8, grid=GRID) -> dict:
    """Host microseconds per call of K1, K2, K3 and K9 through their custom
    ops (the wrappers now) and straight into the ctypes launch (the route
    before the ops), each queued behind a spin so the card never waits."""
    gen = make_generator(SEED + 51, device)
    vol, mask = make_scans("normal", batch, grid, gen, device)
    qs = (QUANTILE, 1.0 - QUANTILE)
    qmin = torch.zeros(batch, device=device)
    qmax = torch.full((batch,), 2000.0, device=device)
    x, w, scale, bias, args = int8_conv_operands("layer3", batch, gen,
                                                 device)

    def direct_k1():
        hopper_norm._order_stats_kernel(*hopper_norm._rows(vol, mask), qs)

    def direct_k2():
        hopper_norm._minmax_apply_kernel(*hopper_norm._rows(vol, mask), qmin,
                                         qmax)

    def direct_k3():
        hopper_norm._zscore_kernel(*hopper_norm._rows(vol, mask))

    def direct_k9():
        int8_conv._check(x, w, scale, bias, args[0], args[3])
        int8_conv._kernel(x, w, scale, bias, *args)

    routes = {
        "minmax_select": (lambda: hopper_norm.order_stats(vol, mask, qs),
                          direct_k1),
        "minmax_apply": (lambda: hopper_norm.minmax_apply(vol, mask, qmin,
                                                          qmax), direct_k2),
        "zscore": (lambda: hopper_norm.per_scan_zscore(vol, mask), direct_k3),
        "int8_conv3d": (lambda: int8_conv.int8_conv3d(x, w, scale, bias,
                                                      *args), direct_k9),
    }

    def host_us(fn, n=40) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(int(100 * 2.0e6))  # 100 ms or more
        start = time.perf_counter()
        for _ in range(n):
            fn()
        seconds = time.perf_counter() - start
        check(not torch.cuda.current_stream().query(),
              "the spin outlasted the timed calls")
        torch.cuda.synchronize()
        return seconds / n * 1e6

    out = {}
    for name, (op, direct) in routes.items():
        samples = {"op": [], "direct": []}
        for _ in range(2):  # op, direct, direct, op
            samples["op"].append(host_us(op))
            samples["direct"].append(host_us(direct))
            samples["direct"].append(host_us(direct))
            samples["op"].append(host_us(op))
        out[name] = {k: statistics.median(v) for k, v in samples.items()}
        log(f"[op overhead] {name} B={batch}: host {out[name]['op']:.1f} us "
            f"per call through the custom op, {out[name]['direct']:.1f} us "
            f"straight into the launch (samples op {samples['op']}, direct "
            f"{samples['direct']})")
    return out


def serve_rates(cores: dict, device, grid=GRID, reps: int = 5) -> None:
    """Log requests/s of each serve core through a Predictor at each
    serving rung: a full rung of raw requests, median of ``reps``
    batches."""
    requests = make_requests(max(SERVE_RUNGS), grid, SEED + 11)
    rates = {}
    for name, serve in cores.items():
        predictor = Predictor(serve_fn=serve, batch_size=max(SERVE_RUNGS),
                              ladder=SERVE_RUNGS, device=device)
        rates[name] = {}
        for rung in SERVE_RUNGS:
            batch = _stack(requests[:rung])
            predictor.predict_batch(batch)
            times = []
            for _ in range(reps):
                start = time.perf_counter()
                predictor.predict_batch(batch)
                times.append(time.perf_counter() - start)
            rates[name][rung] = rung / statistics.median(times)
    for rung in SERVE_RUNGS:
        log(f"[serve rates] rung {rung}: " + ", ".join(
            f"{name} {rates[name][rung]:.2f}" for name in cores)
            + f" requests/s (median of {reps} batches of raw requests)")


def phase_int8_serve(model, preprocess, device, grid=GRID) -> tuple:
    """The serving extras on the flagship model: the four serve cores of
    tools/cases.py; the int8 core's launches per batch (K9 20, K1 and K2
    once) and its drift from the float32 model within JAX's bounds; the
    folded bf16 core against the bf16 model; then the int8 core behind
    Predictor(serve_fn=..., ladder=(8,), batch_size=32) and BatchingServer
    over the serve phase's requests (the path whose launches the kernels
    line reports); then requests/s of the four cores at both rungs.
    Returns the cores, the server run's launch counts and the int8 core's
    launches per batch."""
    start = time.perf_counter()
    cores = {name: serve_core(name, model, preprocess, device, grid)
             for name in SERVE_CORES}
    log(f"[int8 serve] cores {list(cores)} built (int8 calibrated on 2 raw "
        f"batches of 8) in {time.perf_counter() - start:.2f} s")
    batch = _stack(make_requests(8, grid, SEED + 9), device)
    zero = dict.fromkeys(launch_counts(), 0)
    outs, per_batch = {}, {}
    for name, serve in cores.items():
        serve(batch)
        torch.cuda.synchronize()
        reset_launch_counts()
        with torch.inference_mode():
            outs[name] = serve(batch)
        torch.cuda.synchronize()
        per_batch[name] = launch_counts()
        want = dict(zero, minmax_select=1, minmax_apply=1,
                    int8_conv3d=RESNET18_CONVS if name == "int8" else 0)
        check(per_batch[name] == want,
              f"{name} core launches {per_batch[name]} == {want}")
    err = quantization_error(model, cores["int8"], batch, preprocess)
    check(err["argmax_agree"] >= INT8_DRIFT["argmax_agree"]
          and err["prob_max_abs_err"] < INT8_DRIFT["prob_max_abs_err"],
          f"int8 drift {err} within {INT8_DRIFT}")
    log(f"[int8 serve] int8 core launches per batch of 8: "
        f"{per_batch['int8']}; drift from the float32 model {err} (JAX's bounds "
        f"{INT8_DRIFT})")
    l16 = outs["bf16"]["logits"].float().cpu().numpy()
    lf = outs["folded"]["logits"].cpu().numpy()
    l32 = outs["float"]["logits"].cpu().numpy()
    tol = BF16_SERVE_TOL * max(1.0, float(np.abs(l32).max()))
    gaps = {"folded-f32": float(np.abs(lf - l32).max()),
            "folded-bf16": float(np.abs(lf - l16).max())}
    top2 = np.sort(l32, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 4 * tol
    check(np.isfinite(lf).all() and gaps["folded-f32"] <= tol
          and gaps["folded-bf16"] <= 2 * tol,
          f"folded bf16 logits {gaps}: within {tol} of f32's and "
          f"{2 * tol} of the bf16 model's")
    check(bool((lf.argmax(1) == l16.argmax(1))[clear].all()),
          "folded argmax equal to the bf16 model's where the f32 margin "
          "exceeds 4x tol")
    log(f"[folded serve] folded bf16 logits: {gaps['folded-f32']:.4g} from "
        f"f32's (tolerance {tol:.4g}), {gaps['folded-bf16']:.4g} from the "
        f"bf16 model's (tolerance {2 * tol:.4g}); argmax equal on "
        f"{int(clear.sum())} clear requests")

    predictor = Predictor(serve_fn=cores["int8"], batch_size=32, ladder=(8,),
                          device=device)
    requests = make_requests(N_REQUESTS, grid, SEED + 3)
    predictor.warmup(_stack(requests[:1]), parts=True)
    _, launches, _ = drive_server(predictor, requests, "int8 serve")
    for name in ("int8_conv3d", "minmax_select", "minmax_apply"):
        check(launches[name] > 0, f"{name} launched during int8 serving")
    check(launches["int8_conv3d"] == RESNET18_CONVS
          * launches["minmax_select"], "K9 20 times per served batch")
    serve_rates(cores, device, grid)
    return cores, launches, per_batch["int8"]


class _RecordingInt8Ctx(quantize._Int8Ctx):
    """The int8 graph's context, keeping each requant site's carrier."""

    def __init__(self, scales):
        super().__init__(scales)
        self.seen = {}

    def requant(self, site, x):
        self.seen[site] = super().requant(site, x)
        return self.seen[site]


class _UnfusedInt8Ctx(_RecordingInt8Ctx):
    """The int8 graph as it ran before K9's fused epilogue: every
    convolution writes float32 (``int8_conv3d``), then torch adds the
    shortcut (an int8 one through ``dequant``), applies ReLU and
    requantizes, as the float graph's ``conv_relu`` does."""

    conv_relu = quantize._FloatCtx.conv_relu


def phase_int8_fused_route(model, preprocess, device, grid=GRID) -> dict:
    """One batch of 8 raw requests at ``grid`` through the int8 ResNet-18
    graph twice from one calibration: fused (K9 adds the shortcut, applies
    ReLU and writes each int8 carrier) and unfused (float32 out, then torch
    ops). Every requant site's carrier, the feature map and the logits
    equal bit for bit; K9 20 launches per fused batch; the int8 core's
    drift from the float32 model within JAX's bounds; device ms per batch
    of each route's backbone. Returns the fused route's launch counts."""
    serve, qtree = quantize.quantize_anat_cnn(
        model, calibration_batches(device, grid), preprocess)
    batch = _stack(make_requests(8, grid, SEED + 9), device)
    vol = quantize._make_vol(model, preprocess, torch.float32)(batch)
    head = quantize._float32_head(model)
    cfg = qtree["config"]
    routes = {"fused": _RecordingInt8Ctx, "unfused": _UnfusedInt8Ctx}
    out, ms = {}, {}
    for name, ctx_type in routes.items():
        times = []
        for rep in range(4):
            ctx = ctx_type(qtree["scales"])
            torch.cuda.synchronize()
            if rep == 3:
                reset_launch_counts()
            start = time.perf_counter()
            with torch.inference_mode():
                fmap = quantize._backbone_forward(
                    qtree, vol, ctx, depth=cfg["depth"],
                    dilated=cfg["dilated"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
        if name == "fused":
            launches = launch_counts()
        with torch.inference_mode():
            out[name] = (ctx.seen, fmap, head(fmap)["logits"])
        ms[name] = statistics.median(times[1:])
    (fs, ffmap, flog), (us, ufmap, ulog) = out["fused"], out["unfused"]
    check(list(fs) == list(us), f"requant sites {list(fs)} == {list(us)}")
    for site in fs:
        check(fs[site].dtype == torch.int8 and torch.equal(fs[site],
                                                            us[site]),
              f"int8 carrier {site}: fused equals unfused")
    check(torch.equal(ffmap, ufmap) and torch.equal(flog, ulog),
          "feature map and logits: fused equals unfused")
    with torch.inference_mode():
        served = serve(batch)["logits"]
    check(torch.equal(served, flog), "the int8 core's logits are the fused "
          "route's")
    want = dict(dict.fromkeys(launches, 0), int8_conv3d=RESNET18_CONVS)
    check(launches == want, f"fused backbone launches {launches} == {want}")
    err = quantization_error(model, serve, batch, preprocess)
    check(err["argmax_agree"] >= INT8_DRIFT["argmax_agree"]
          and err["prob_max_abs_err"] < INT8_DRIFT["prob_max_abs_err"],
          f"int8 drift {err} within {INT8_DRIFT}")
    log(f"[int8 fused] batch 8 at {grid}: {len(fs)} requant sites, the "
        f"feature map and the logits equal bit for bit fused and unfused; "
        f"K9 {launches['int8_conv3d']} launches a fused batch; drift from "
        f"the float32 model {err}; backbone {ms['fused']:.3f} ms fused, "
        f"{ms['unfused']:.3f} ms unfused (host clock around a synchronised "
        f"batch, median of 3)")
    return launches


def phase_int8_stage3(device, grid=GRID) -> dict:
    """int8 stage 3 on tools/cases.py's stage-3 case (frozen, shared
    towers): quantize_all_modalities_fusion calibrated on the case's batch;
    K9 20 and K1/K2 once per batch; drift from the float fusion (the
    probabilities within JAX's 0.01, the argmax equal where the float
    margin is clear); ms per batch of each."""
    batch, (mean, std) = stage3_batch(device, grid)
    tab_hp = dict(TAB_HPARAMS, feature_mean=mean, feature_std=std)
    preprocess = stage3_preprocess()
    model = stage3_model(torch.float32, None, tab_hp, device=device).eval()
    serve, _ = quantize_all_modalities_fusion(model, [batch], preprocess)
    serve(batch)
    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.inference_mode():
        serve(batch)
    torch.cuda.synchronize()
    launches = launch_counts()
    want = dict(dict.fromkeys(launches, 0), minmax_select=1, minmax_apply=1,
                int8_conv3d=RESNET18_CONVS)
    check(launches == want, f"int8 stage 3 launches {launches} == {want}")
    err = quantization_error(model, serve, batch, preprocess)
    with torch.inference_mode():
        probs = torch.softmax(model(preprocess(batch))["logits"], -1)
        int8_probs = serve(batch)["probs"]
    top2 = probs.sort(dim=1).values[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * err["prob_max_abs_err"]
    agree = bool((probs.argmax(1) == int8_probs.argmax(1))[clear].all())
    # The random-weight 2-class fusion sits near p = 0.5 for some samples:
    # the argmax is held wherever the float margin exceeds twice the drift.
    check(agree and err["prob_max_abs_err"]
          < INT8_DRIFT["prob_max_abs_err"],
          f"int8 stage 3 drift {err}: probabilities within "
          f"{INT8_DRIFT['prob_max_abs_err']}, argmax equal on the "
          f"{int(clear.sum())} samples with a clear margin")

    def float_serve(b):
        with torch.inference_mode():
            return model(preprocess(b))

    ms = {}
    for name, fn in (("float", float_serve), ("int8", serve)):
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            start = time.perf_counter()
            with torch.inference_mode():
                fn(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
        ms[name] = statistics.median(times[1:])
    log(f"[int8 stage3] AllModalitiesFusion (shared towers), batch 8 at "
        f"{grid}: launches per batch {want}, drift from the float fusion "
        f"{err}; {ms['float']:.2f} ms float32, {ms['int8']:.2f} ms int8")
    return launches


def phase_export(cores: dict, device, grid=GRID) -> dict:
    """The int8 and folded cores through export_serve_fn -> bytes ->
    load_exported on the card: outputs bit for bit the eager core's, and
    the loaded program launches K9 (int8), K1 and K2."""
    batch = _stack(make_requests(8, grid, SEED + 9), device)
    zero = dict.fromkeys(launch_counts(), 0)
    out = {}
    for name in ("int8", "folded"):
        start = time.perf_counter()
        blob = export_serve_fn(cores[name], batch)
        exported_s = time.perf_counter() - start
        loaded = load_exported(blob)
        eager = cores[name](batch)
        loaded(batch)
        torch.cuda.synchronize()
        reset_launch_counts()
        got = loaded(batch)
        torch.cuda.synchronize()
        launches = launch_counts()
        want = dict(zero, minmax_select=1, minmax_apply=1,
                    int8_conv3d=RESNET18_CONVS if name == "int8" else 0)
        check(launches == want,
              f"exported {name}: launches {launches} == {want}")
        for key in ("logits", "probs"):
            check(torch.equal(got[key], eager[key]),
                  f"exported {name} {key} bit for bit the eager core's")
        check(torch.equal(got["embeddings"]["backbone_gap"],
                          eager["embeddings"]["backbone_gap"]),
              f"exported {name} backbone_gap bit for bit")
        out[name] = launches
        log(f"[export] {name}: {len(blob) / 1e6:.1f} MB artifact, exported "
            f"in {exported_s:.2f} s; loaded program launches "
            f"{ {k: v for k, v in launches.items() if v} }, outputs bit for "
            f"bit the eager core's")
    return out


def phase_quality(cores: dict, device, grid=GRID) -> dict:
    """compare_serve_cores over the float32, folded and int8 cores on a
    labeled synthetic set (make_labeled_volumes), with bootstrap CIs."""
    data = make_labeled_volumes(QUALITY["n"], tuple(grid), n_classes=3,
                                seed=QUALITY["seed"])
    res = compare_serve_cores(
        {k: cores[k] for k in ("float", "folded", "int8")}, data, 3,
        batch_size=QUALITY["batch"], bootstrap=QUALITY["bootstrap"],
        device=device)
    for name, r in res.items():
        check(r["n"] == QUALITY["n"] and np.isfinite(r["f1"])
              and np.isfinite(r["f1_ci"]), f"quality {name}: {r['n']} "
              f"samples, finite f1 and CI")
    check(res["float"]["delta_f1_ci"] == 0.0, "float's own delta CI is 0")
    for line in format_comparison(res).splitlines():
        log(f"[quality] {line}")
    return {k: {m: r[m] for m in ("f1", "mcc", "agreement",
                                  "max_prob_abs_err")}
            for k, r in res.items()}


# The deployment chain (convert, export, quality study). The reference's
# Anat_CNN for MedicalNet ResNet-18 (dilated, conv_seg head, 3 classes) is
# a replica built here (the JAX tests' replicas import JAX); the port's
# converted model against it on the same normalised batch, f32 with TF32
# off: the same cuDNN convolutions on the same weights, the BatchNorms
# computed in another order, so within CONVERT_TOL.
CONVERT_HPARAMS = {"n_classes": 3, "resnet_depth": 18, "linear_out": [],
                   "batchnorm_begin": False, "norm_percentile": QUANTILE,
                   "lr": 1e-3}
CONVERT_TOL = dict(rtol=1e-4, atol=1e-5)
# The quality study at 91x109x91, depth 18, cut to run in seconds: its
# defaults are 384 train and 1024 eval volumes, 12 epochs, 1000 draws.
QUALITY_EVAL = {"train_n": 192, "eval_n": 128, "epochs": 8, "batch": 8,
                "bootstrap": 500}
QUALITY_EVAL_FUSION_GRID = (48, 56, 48)


class _Med3DBlock(torch.nn.Module):
    """MedicalNet's BasicBlock (shortcut B)."""

    def __init__(self, inplanes, planes, stride, dilation, downsample):
        super().__init__()
        nn = torch.nn
        self.conv1 = nn.Conv3d(inplanes, planes, 3, stride=stride,
                               padding=dilation, dilation=dilation,
                               bias=False)
        self.bn1 = nn.BatchNorm3d(planes)
        self.conv2 = nn.Conv3d(planes, planes, 3, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = nn.BatchNorm3d(planes)
        self.downsample = downsample

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class _Med3D(torch.nn.Module):
    """MedicalNet resnet18 (dilated layers 3-4) with the reference's
    ``conv_seg`` head: GAP, Flatten, Linear(512, n_classes), ReLU."""

    def __init__(self, n_classes):
        super().__init__()
        nn = torch.nn
        self.conv1 = nn.Conv3d(1, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm3d(64)
        inplanes = 64
        for i, (planes, stride, dilation) in enumerate(
                ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4)), 1):
            blocks = []
            for b in range(2):
                down = None
                if b == 0 and (stride != 1 or inplanes != planes):
                    down = nn.Sequential(
                        nn.Conv3d(inplanes, planes, 1, stride=stride,
                                  bias=False), nn.BatchNorm3d(planes))
                blocks.append(_Med3DBlock(inplanes, planes,
                                          stride if b == 0 else 1,
                                          dilation, down))
                inplanes = planes
            setattr(self, f"layer{i}", nn.Sequential(*blocks))
        self.conv_seg = nn.Sequential(nn.AdaptiveAvgPool3d(1), nn.Flatten(),
                                      nn.Linear(512, n_classes), nn.ReLU())

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.nn.functional.max_pool3d(x, 3, 2, 1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return self.conv_seg(x)


class _AnatCNNReplica(torch.nn.Module):
    """The reference Anat_CNN's attribute layout: ``model`` (the Med3D
    backbone, its head at ``model.conv_seg``)."""

    def __init__(self, n_classes):
        super().__init__()
        self.model = _Med3D(n_classes)

    def forward(self, x):
        return self.model(x)


def _drift(got: dict, ref: dict) -> dict:
    return {"argmax_agree": float((got["probs"].argmax(1)
                                   == ref["probs"].argmax(1)).float()
                                  .mean()),
            "prob_max_abs_err": float((got["probs"] - ref["probs"]).abs()
                                      .max())}


def phase_convert(device, root, grid=GRID) -> str:
    """A reference-layout Anat_CNN (ResNet-18 dilated, conv_seg head, 3
    classes) from seeded tensors, its BatchNorm statistics those of one
    batch of raw scans (momentum 1) and its classifier bias 1.0 (off the
    trailing ReLU's floor), saved as a Lightning-style .ckpt; the port's
    convert_reference.main converts it, and the checkpoint loads back into
    an AnatCNN whose logits at ``grid``, batch 8, f32 with TF32 off match
    the replica's within CONVERT_TOL. Returns the port checkpoint."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(SEED + 60)
    replica = _AnatCNNReplica(CONVERT_HPARAMS["n_classes"]).to(device)
    preprocess = make_device_preprocess(normalize_mri=MINMAX,
                                        quantile=QUANTILE)
    with torch.no_grad():
        for m in replica.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.momentum = 1.0
        replica.train()(preprocess(_stack(make_requests(
            2, grid, SEED + 63), device))["mri"].unsqueeze(1))
        for m in replica.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.momentum = 0.1
        replica.model.conv_seg[2].bias.fill_(1.0)
    replica.eval()
    ckpt = os.path.join(root, "anat_cnn.ckpt")
    torch.save({"state_dict": {k: v.cpu() for k, v in
                               replica.state_dict().items()},
                "hyper_parameters": CONVERT_HPARAMS, "epoch": 0}, ckpt)
    out = os.path.join(root, "anat_cnn_port")
    start = time.perf_counter()
    convert_reference.main([ckpt, out, "--arch", "anat_cnn"])
    convert_s = time.perf_counter() - start
    state, hparams, _ = load_checkpoint(out)
    check(hparams == CONVERT_HPARAMS, "converted hparams kept")
    model = AnatCNN.from_hparams(hparams).to(device).eval()
    model.load_state_dict(state)
    batch = preprocess(_stack(make_requests(8, grid, SEED + 64), device))
    with torch.no_grad():
        want = replica(batch["mri"].unsqueeze(1))
        got = model(batch)["logits"]
    torch.cuda.synchronize()
    gap = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()) and torch.allclose(
        got, want, **CONVERT_TOL), f"converted AnatCNN logits within "
        f"{CONVERT_TOL} of the replica's (max |diff| {gap:.3g})")
    log(f"[convert] reference Anat_CNN ResNet-18 .ckpt "
        f"({os.path.getsize(ckpt) / 1e6:.1f} MB, {len(state)} port "
        f"entries) -> port checkpoint in {convert_s:.2f} s; logits at "
        f"{tuple(grid)}, batch 8, f32 (TF32 off): max |port - replica| "
        f"{gap:.3g}, largest |logit| {float(want.abs().max()):.4g} "
        f"(tolerance {CONVERT_TOL})")
    return out


def phase_export_cli(device, root, checkpoint: str, grid=GRID) -> dict:
    """export_artifact.main on the converted checkpoint in float, folded
    and int8 (int8 calibrated on a --calib npz of 8 raw scans), --batch 8:
    each artifact reloaded and held to the eager core the tool builds (its
    own loader, preprocess and serve), bit for bit; folded and int8 held to
    float by the drift gates (argmax agreement 1.0, probabilities within
    0.01); one int8 artifact call launches K9 20 times and K1, K2 once.
    Returns that call's launch counts."""
    calib = os.path.join(root, "calib.npz")
    np.savez(calib, **_stack(make_requests(8, grid, SEED + 61)))
    model, state, norm, _ = export_artifact.REGISTRY["anat_cnn"](
        checkpoint, None)
    model.load_state_dict(state)
    model = model.to(device).eval()
    preprocess = export_artifact._build_preprocess(norm)
    with np.load(calib) as z:
        calib_batches = [{k: torch.from_numpy(z[k]).to(device)
                          for k in z.files}]
    batch = _stack(make_requests(8, grid, SEED + 62), device)
    outs, launches = {}, None
    for mode in ("float", "folded", "int8"):
        path = os.path.join(root, f"anat_cnn_{mode}.pt2")
        argv = [checkpoint, "--model", "anat_cnn", "--mode", mode,
                "--batch", "8", "--volume-shape", *map(str, grid),
                "--out", path] + (["--calib", calib] if mode == "int8"
                                  else [])
        start = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()) as summary:
            export_artifact.main(argv)
        export_s = time.perf_counter() - start
        with open(path, "rb") as f:
            loaded = load_exported(f.read())
        eager = export_artifact._build_serve(mode, "anat_cnn", model,
                                             preprocess, calib_batches,
                                             False)
        with torch.inference_mode():
            want = eager(batch)
        got = loaded(batch)
        torch.cuda.synchronize()
        for key in ("logits", "probs"):
            check(torch.equal(got[key], want[key]),
                  f"export cli {mode} artifact {key} bit for bit the "
                  f"eager core's")
        if mode == "int8":
            reset_launch_counts()
            loaded(batch)
            torch.cuda.synchronize()
            launches = launch_counts()
            expect = dict(dict.fromkeys(launches, 0), minmax_select=1,
                          minmax_apply=1, int8_conv3d=RESNET18_CONVS)
            check(launches == expect,
                  f"int8 artifact call launches {launches} == {expect}")
        outs[mode] = got
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            start = time.perf_counter()
            loaded(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
        log(f"[export cli] {mode}: export_artifact.main {export_s:.2f} s, "
            f"{os.path.getsize(path) / 1e6:.1f} MB artifact "
            f"({summary.getvalue().strip().splitlines()[-1]}); reloaded "
            f"outputs bit for bit "
            f"the eager core's; {statistics.median(times[1:]):.3f} ms a "
            f"call of the loaded artifact (host clock around a synchronised "
            f"call, median of 5 after one)")
    for mode in ("folded", "int8"):
        err = _drift(outs[mode], outs["float"])
        check(err["argmax_agree"] >= INT8_DRIFT["argmax_agree"]
              and err["prob_max_abs_err"] < INT8_DRIFT["prob_max_abs_err"],
              f"{mode} artifact drift {err} within {INT8_DRIFT}")
        log(f"[export cli] {mode} artifact against float's: {err}")
    log(f"[export cli] one int8 artifact call (batch 8) launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def phase_quality_eval(device) -> dict:
    """quality_eval.main at 91x109x91, depth 18, cut to QUALITY_EVAL (a
    bf16 fit, then the float, folded, int8, int8_badcalib and fast cores
    over the held-out set), then --fusion alone at
    QUALITY_EVAL_FUSION_GRID: its JSON record has every core with finite
    metrics over the whole eval set, and folded agrees with float on at
    least 90% of the predictions (exact algebra in bf16: only near-ties
    may flip)."""
    cut = ["--train-n", str(QUALITY_EVAL["train_n"]),
           "--eval-n", str(QUALITY_EVAL["eval_n"]),
           "--epochs", str(QUALITY_EVAL["epochs"]),
           "--batch", str(QUALITY_EVAL["batch"]),
           "--bootstrap", str(QUALITY_EVAL["bootstrap"])]
    records = {}
    for name, argv, want in (
            ("flagship", ["--depth", "18"] + cut,
             {"float", "folded", "int8", "int8_badcalib", "fast"}),
            ("fusion", ["--depth", "18", "--fusion", "--skip-flagship",
                        "--volume-shape", *map(str, QUALITY_EVAL_FUSION_GRID)]
             + cut, {"float", "folded", "int8_mri", "int8_mri_pet"})):
        start = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()) as tables:
            record = quality_eval.main(argv)
        seconds = time.perf_counter() - start
        res = record[name]
        check(set(res) == want, f"quality eval {name} cores {sorted(res)}")
        for core, r in res.items():
            check(r["n"] == QUALITY_EVAL["eval_n"] and all(
                np.isfinite(r[k]) for k in ("f1", "mcc", "f1_ci",
                                            "delta_f1_ci")),
                f"quality eval {name} {core}: finite metrics over "
                f"{QUALITY_EVAL['eval_n']} samples")
        check(res["folded"]["agreement"] >= 0.9,
              f"quality eval {name}: folded agrees with float "
              f"({res['folded']['agreement']})")
        for line in tables.getvalue().splitlines():
            log(f"[quality eval] {line}")
        log(f"[quality eval] {name} at {record['volume_shape']}, depth 18, cut to "
            f"{QUALITY_EVAL} (defaults 384 / 1024 / 12 epochs / 16 / "
            f"1000 draws): {seconds:.2f} s; " + "; ".join(
                f"{core} f1 {r['f1']} Δf1 {r['delta_f1']}±"
                f"{r['delta_f1_ci']} agreement {r['agreement']}"
                for core, r in res.items()))
        records[name] = record
    return records


# ------------------------------------------------------------------ [dp] --
# Data parallelism on the one card (parallel/): correctness and the cost of
# the collective path only, never a speed-up. The flagship AnatCNN trained
# with SGD through Trainer(mesh=)'s step on batch 8 of raw scans (min-max in
# the step), class weights [0.4, 0.6]. SGD at lr 1e-4: at 1e-2 one step
# takes the loss from 0.75 to 0.10, and the ranks' other summation order
# (1e-7) flips ReLU and max-pool near-ties of the masked scans, as a
# one-ulp move of the scans does (ROADMAP section C): first-step gradients
# then part by up to 8% of a tensor's largest entry (CPU rehearsal at
# 32x36x32; 5e-6 on unmasked normal scans), which lr 1e-2 carries past
# JAX's DP tolerances within 3 steps. The steps are deterministic, so that
# one nccl rank can be held to the mesh-free step bit for bit: cuDNN's
# deterministic algorithms, and the stem pool's backward through K8
# (maxpool_impl="wf"; aten's adds with atomics, and two of its steps part).
DP_HPARAMS = dict(TRAIN_HPARAMS, loss_class_weights=[0.4, 0.6])
DP_LR = 1e-4
DP_WORLD, DP_STEPS, DP_TIMED = 2, 3, 3
DP_FUSED = ("full", False, "hybrid")
# Two gloo ranks against the one-process run: JAX's DP tolerances
# (tests/test_parallel.py); one bf16 "full" step's loss within 1e-2.
DP_LOSS_RTOL = 1e-5
DP_TOL = dict(rtol=2e-4, atol=1e-5)
DP_BF16_LOSS_RTOL = 1e-2
# The mesh predictor against the one-process one at rung 8: JAX
# _serve_dryrun's bounds, argmax equal; TabPFN's probabilities within 1e-5.
DP_SERVE_TOL = dict(rtol=1e-3, atol=1e-3)
DP_TABPFN_TOL = 1e-5


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def dp_steps(weights: dict, fused, device, mesh=None,
             steps: int = DP_STEPS, dtype=torch.float32, grid=GRID,
             timed: int = 0) -> dict:
    """``steps`` SGD steps of the flagship AnatCNN from ``weights``
    (``train_model``'s) through ``Trainer(mesh=mesh)``'s train step on
    batch 8 of raw scans, the rank's rows under a mesh. Returns the reported losses, the
    state dict on the CPU, the first step's launches, the collectives of
    the ``steps`` steps, and the median ms of ``timed`` further steps."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    model = AnatCNN.from_hparams(DP_HPARAMS, fused_bn=fused, dtype=dtype,
                                 maxpool_impl="wf")
    model.load_state_dict(weights)
    optimizer = torch.optim.SGD(model.parameters(), lr=DP_LR)
    trainer = Trainer(model, DP_HPARAMS, optimizer,
                      make_criterion(DP_HPARAMS),
                      preprocess=make_device_preprocess(
                          normalize_mri=MINMAX, quantile=QUANTILE),
                      log_confusion_images=False, device=device, mesh=mesh)
    state = trainer.init_state()
    data = make_labeled_volumes(8, tuple(grid), n_classes=2, seed=SEED + 6)
    batch = trainer._place({k: torch.from_numpy(data[k]) for k in
                            ("mri", "mri_mask", "label")})
    if mesh is not None:
        mesh.reset_counts()
    losses = []
    for i in range(steps):
        _sync(device)
        reset_launch_counts()
        state, aux = trainer.train_step(state, batch)
        losses.append(aux["loss"].item())
        if i == 0:
            launches = launch_counts()
    out = {"losses": losses, "launches": launches,
           "collectives": dict(mesh.counts) if mesh is not None else {},
           "state": {k: v.detach().float().cpu().clone()
                     for k, v in model.state_dict().items()}}
    times = []
    for _ in range(timed):
        _sync(device)
        start = time.perf_counter()
        trainer.train_step(state, batch)
        _sync(device)
        times.append((time.perf_counter() - start) * 1e3)
    out["ms"] = statistics.median(times) if times else None
    torch.backends.cudnn.deterministic = False
    return out


def _state_gap(got: dict, want: dict) -> tuple:
    """(every entry within DP_TOL, the largest |got - want|)."""
    ok, worst = set(got) == set(want), 0.0
    for key, value in want.items():
        diff = (got[key] - value).abs()
        worst = max(worst, float(diff.max()))
        ok = ok and bool((diff <= DP_TOL["atol"]
                          + DP_TOL["rtol"] * value.abs()).all())
    return ok, worst


def phase_dp_nccl(device, grid=GRID) -> dict:
    """[dp] 1: one nccl rank, the mesh over the card: Trainer(mesh=
    make_mesh()) steps with fused_bn="full" and False must be the
    mesh-free steps bit for bit (losses, parameters, running statistics);
    step ms of both and the collectives per step."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.distributed.init_process_group(
            "nccl", init_method=f"file://{os.path.join(tmp, 'init')}",
            world_size=1, rank=0)
        try:
            mesh = make_mesh()
            weights = train_model(False).state_dict()
            for fused in ("full", False):
                free = dp_steps(weights, fused, device, None, grid=grid,
                                timed=DP_TIMED)
                on = dp_steps(weights, fused, device, mesh, grid=grid,
                              timed=DP_TIMED)
                check(on["losses"] == free["losses"] and all(
                    torch.equal(on["state"][k], v)
                    for k, v in free["state"].items()),
                    f"[dp] nccl world 1, fused_bn={fused!r}: bit for bit "
                    f"the mesh-free step ({on['losses']} vs "
                    f"{free['losses']})")
                per_step = {k: v / DP_STEPS
                            for k, v in on["collectives"].items()}
                out[fused] = {"ms": on["ms"], "free_ms": free["ms"],
                              "collectives": per_step}
                log(f"[dp] nccl, world 1, fused_bn={fused!r}: {DP_STEPS} "
                    f"SGD steps bit for bit the mesh-free steps (losses "
                    f"{on['losses']}); step ms {on['ms']:.2f} on the mesh, "
                    f"{free['ms']:.2f} mesh-free (median of {DP_TIMED}); "
                    f"collectives per step {per_step}")
        finally:
            torch.distributed.destroy_process_group()
    return out


def dp_serve(device, mesh=None, grid=GRID) -> dict:
    """The float32 and int8 serve cores of tools/cases.py behind a
    Predictor at rung 8 on 8 raw requests (each rank runs 4 under a mesh);
    the launches of one call; under a mesh a BatchingServer round trip of
    the 8 requests on the int8 predictor, served from rank 0."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model, preprocess = serve_model(device=device), serve_preprocess()
    requests = make_requests(8, grid, SEED + 41)
    batch = _stack(requests)
    out = {}
    for name in ("float", "int8"):
        pred = Predictor(model, batch_size=8, serve_fn=serve_core(
            name, model, preprocess, device, grid), device=device, mesh=mesh)
        pred.predict_batch(batch)
        _sync(device)
        reset_launch_counts()
        got = pred.predict_batch(batch)
        _sync(device)
        out[name] = {"logits": got["logits"], "launches": launch_counts()}
    if mesh is None:
        return out
    if mesh.rank == 0:
        start = time.perf_counter()
        with BatchingServer(pred, max_wait_s=0.05) as server:
            futures = [server.submit(r) for r in requests]
            out["served"] = np.stack([f.result(timeout=120)["logits"]
                                      for f in futures])
        out["served_s"] = time.perf_counter() - start
        out["batches"] = dict(server.batch_histogram)
    else:
        out["followed"] = pred.follow()
    return out


def dp_trials(device, mesh=None, grid=GRID, epochs: int = 1):
    """The MRI search's K=2 trials (HPO_TRIALS, phase 25's split and
    kwargs) sharded over the mesh's ranks; the val history."""
    torch.backends.cudnn.allow_tf32 = False
    data = _raw_split(24, grid, SEED + 21)
    train, val = train_anat_cnn.percentile_normalizer(
        _RawSplit(), {k: v[:16] for k, v in data.items()},
        {k: v[16:] for k, v in data.items()}, device)(QUANTILE)
    model = AnatCNN.from_hparams(TRAIN_HPARAMS, freeze_backbone=False)
    hp = vmap_hpo.stack_trial_hparams(HPO_TRIALS,
                                      extra_keys=("lr_pretrained",))
    _, info = vmap_hpo.run_parallel_trials(
        model, hp, train, val, batch_size=8, max_epochs=epochs,
        patience=epochs, class_weights=[0.5, 0.5], seed=SEED,
        apply_fn=vmap_hpo.plain_apply, init_fn=_live_init,
        lr_select=train_anat_cnn.head_backbone_lr, device=device, mesh=mesh)
    return info["val_history"]


def dp_tabpfn(device, mesh=None) -> np.ndarray:
    """TabPFN at its published width on seeded random weights, 4 members
    (split over the mesh's ranks): the probabilities of the test rows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x_tr, y_tr, x_te, _ = tabpfn_table(SEED + 13)
    clf = TabPFNClassifier(model=TabPFNTransformer(**TABPFN_WIDTH),
                           ensemble_size=TABPFN_DATA["ensemble_size"],
                           seed=SEED + 14, device=device, mesh=mesh)
    return clf.fit(x_tr, y_tr).predict_proba(x_te)


def dp_rank(mesh, grid, hpo_epochs: int) -> dict:
    """[dp] 2-5 on one of two gloo ranks sharing the card."""
    device = mesh.device
    weights = train_model(False).state_dict()
    train = {}
    for fused in DP_FUSED:
        train[fused] = dp_steps(weights, fused, device, mesh, grid=grid,
                                timed=DP_TIMED)
        train[fused]["collectives"] = {
            k: v / DP_STEPS for k, v in train[fused]["collectives"].items()}
    bf16 = dp_steps(weights, "full", device, mesh, steps=1,
                    dtype=torch.bfloat16, grid=grid)
    return {"train": train, "bf16": bf16["losses"][0],
            "serve": dp_serve(device, mesh, grid),
            "trials": dp_trials(device, mesh, grid, hpo_epochs),
            "tabpfn": dp_tabpfn(device, mesh)}


def phase_dp_gloo(device, grid=GRID, hpo_epochs: int = 1) -> dict:
    """[dp] 2-5: two gloo ranks on the one card (NCCL refuses two ranks on
    one device) against the one-process runs of this phase; returns the
    per-rank launches of a train step and of a predictor call."""
    weights = train_model(False).state_dict()
    want = {fused: dp_steps(weights, fused, device, grid=grid)
            for fused in DP_FUSED}
    want_bf16 = dp_steps(weights, "full", device, steps=1,
                         dtype=torch.bfloat16, grid=grid)["losses"][0]
    want_serve = dp_serve(device, grid=grid)
    want_trials = dp_trials(device, grid=grid, epochs=hpo_epochs)
    want_tabpfn = dp_tabpfn(device)
    start = time.perf_counter()
    ranks = run_ranks(dp_rank, DP_WORLD, "gloo", grid, hpo_epochs,
                      device=device.type, timeout=900)
    spawn_s = time.perf_counter() - start
    for r, rank in enumerate(ranks):
        for fused in DP_FUSED:
            got, ref = rank["train"][fused], want[fused]
            ok, worst = _state_gap(got["state"], ref["state"])
            losses_ok = np.allclose(got["losses"], ref["losses"],
                                    rtol=DP_LOSS_RTOL, atol=0)
            check(losses_ok and ok,
                  f"[dp] gloo rank {r}, fused_bn={fused!r}: losses "
                  f"{got['losses']} vs {ref['losses']}, largest state gap "
                  f"{worst:.3g} (tolerance {DP_TOL})")
            log(f"[dp] gloo rank {r}/{DP_WORLD}, fused_bn={fused!r}: "
                f"{DP_STEPS} SGD steps at global batch 8 (4 a rank), losses "
                f"{got['losses']} vs one process {ref['losses']}, largest "
                f"|state - one process| {worst:.3g}; launches per step "
                f"{got['launches']}; collectives per step "
                f"{got['collectives']}; step ms {got['ms']:.2f} (two ranks "
                f"sharing one card: not a scaling figure; one process at "
                f"batch 8 is phase 8's)")
        full = rank["train"]["full"]["launches"]
        want_launches = dict(dict.fromkeys(full, 0), minmax_select=1,
                             minmax_apply=1, maxpool_bwd=1,
                             **dict.fromkeys(BN_KERNELS, BN_LAYERS))
        check(full == want_launches, f"[dp] rank {r} launches per step "
              f"{full} == {want_launches}")
        check(abs(rank["bf16"] - want_bf16) <= DP_BF16_LOSS_RTOL
              * abs(want_bf16), f"[dp] rank {r} bf16 full step loss "
              f"{rank['bf16']} vs {want_bf16}")
        for name in ("float", "int8"):
            got = rank["serve"][name]
            ref = want_serve[name]["logits"]
            check(np.allclose(got["logits"], ref, **DP_SERVE_TOL)
                  and (got["logits"].argmax(-1) == ref.argmax(-1)).all(),
                  f"[dp] rank {r} {name} predictor logits within "
                  f"{DP_SERVE_TOL} of one process, argmax equal")
            want_call = dict(dict.fromkeys(got["launches"], 0),
                             minmax_select=1, minmax_apply=1,
                             int8_conv3d=RESNET18_CONVS
                             if name == "int8" else 0)
            check(got["launches"] == want_call,
                  f"[dp] rank {r} {name} predictor launches "
                  f"{got['launches']} == {want_call}")
        gap = float(np.max(np.abs(rank["trials"] - want_trials)
                           / np.abs(want_trials)))
        check(gap <= HPO_SOLO_RTOL, f"[dp] rank {r} sharded trials val "
              f"{rank['trials'].tolist()} vs {want_trials.tolist()}")
        tab_gap = float(np.abs(rank["tabpfn"] - want_tabpfn).max())
        check(tab_gap <= DP_TABPFN_TOL,
              f"[dp] rank {r} TabPFN probabilities {tab_gap:.3g}")
        serve_gap = {name: float(np.abs(rank["serve"][name]["logits"]
                                        - want_serve[name]["logits"]).max())
                     for name in ("float", "int8")}
        log(f"[dp] gloo rank {r}: bf16 full step loss {rank['bf16']} vs "
            f"{want_bf16}; Predictor(mesh=) at rung 8, largest |logit - one "
            f"process| {serve_gap}, launches per call float "
            f"{rank['serve']['float']['launches']}, int8 "
            f"{rank['serve']['int8']['launches']}; K=2 trials sharded, val "
            f"{rank['trials'].tolist()} vs unsharded "
            f"{want_trials.tolist()} (rel gap {gap:.3g}); TabPFN 4 members "
            f"split, largest |probability gap| {tab_gap:.3g}")
    lead = ranks[0]["serve"]
    check(np.allclose(lead["served"], want_serve["int8"]["logits"],
                      **DP_SERVE_TOL) and ranks[1]["serve"]["followed"]
          == sum(lead["batches"].values()),
          f"[dp] BatchingServer over the int8 mesh predictor: 8 requests "
          f"served, batches {lead['batches']}, rank 1 followed "
          f"{ranks[1]['serve']['followed']}")
    log(f"[dp] BatchingServer on rank 0 over the int8 mesh predictor: 8 "
        f"requests in {lead['served_s']:.3f} s, batches {lead['batches']}, "
        f"rank 1 followed {ranks[1]['serve']['followed']}; two-rank spawn "
        f"{spawn_s:.1f} s")
    return {"train_step_per_rank": ranks[0]["train"]["full"]["launches"],
            "int8_call_per_rank": ranks[0]["serve"]["int8"]["launches"]}


def _nccl_rank(mesh) -> float:
    return mesh.all_reduce_(torch.ones(1, device=mesh.device)).item()


def phase_dp_nccl_two_ranks() -> None:
    """[dp] why the two-rank runs name gloo: two nccl ranks on the one
    card. The outcome is printed, not gated."""
    start = time.perf_counter()
    try:
        run_ranks(_nccl_rank, DP_WORLD, "nccl", timeout=120,
                  group_timeout=60)
        outcome = "accepted: the all-reduce returned"
    except Exception as exc:  # the outcome is what this phase reports
        text = " ".join(str(exc).split())
        outcome = f"refused: {type(exc).__name__}: {text[-300:]}"
    log(f"[dp] nccl, two ranks on one card: {outcome} "
        f"({time.perf_counter() - start:.1f} s)")



# [tp] tensor and spatial parallelism (parallel/tp.py): a correctness run on
# the one card, no scaling figure. The flagship at global batch 4 of raw
# scans z-scored in the step (K3 split on a spatial axis), SGD at DP_LR as
# in [dp] (at 1e-2 masked scans' ReLU and max-pool ties flip between the
# one-process and the sharded step), cuDNN's deterministic algorithms.
TP_BATCH = 4
# run: (fused_bn, maxpool_impl, SGD steps, compute dtype)
TP_RUNS = {"full": ("full", "xla", 2, torch.float32),
           "False": (False, "xla", 2, torch.float32),
           "wf": ("full", "wf", 1, torch.float32),
           "wf-bf16": ("full", "wf", 1, torch.bfloat16)}
# (a)'s runs pool through K8: aten's max-pool backward adds with atomics,
# so that two runs of one step part in the last bits ([dp]'s finding).
TP_NCCL_RUNS = {"full-wf": ("full", "wf", 2, torch.float32),
                "False-wf": (False, "wf", 2, torch.float32)}
TP_SMALL_GRID = (48, 56, 48)
TP_SMALL_HPARAMS = dict(DP_HPARAMS, resnet_depth=10)
# (a) times the mesh and the mesh-free step TP_TIMED times each, in turns
# (free, mesh, mesh, free, ...); (b) times its "full" step TP_TIMED_B times.
TP_TIMED = 12
TP_TIMED_B = 2
# Above this gap of the mesh's median step over the mesh-free one, (a)
# profiles a mesh step and prints its collectives.
TP_GAP_PROFILE = 0.05
# JAX's tp tolerances (tests/test_tp.py): loss rtol 1e-5, parameters and
# running statistics rtol 2e-4, atol 1e-5.
TP_LOSS_RTOL = 1e-5
TP_TOL = dict(rtol=2e-4, atol=1e-5)
# The split statistics against the whole scan's: within 2e-6 relative.
TP_STATS_RTOL = 2e-6
TP_SOURCE = {"zscore_partials": CSRC + "zscore_norm.cu",
             "zscore_apply": CSRC + "zscore_norm.cu",
             "maxpool_bwd_window": CSRC + "maxpool_bwd.cu"}
TP_REPLACES = {"zscore_partials": REPLACES["zscore"],
               "zscore_apply": REPLACES["zscore"],
               "maxpool_bwd_window": REPLACES["maxpool_bwd"]}
# tools/fast_mode_study.py cut to size for the card run.
FAST_MODE_ARGS = ["--volume-shape", "48", "56", "48", "--depth", "10",
                  "--seeds", "2", "--train-n", "16", "--eval-n", "8",
                  "--epochs", "2", "--batch", "4"]


def tp_batch(grid, seed: int) -> dict:
    data = make_labeled_volumes(TP_BATCH, tuple(grid), n_classes=2,
                                seed=seed)
    return {k: torch.from_numpy(data[k]) for k in ("mri", "mri_mask",
                                                    "label")}


def tp_steps(weights: dict, hp: dict, run: str, device, mesh=None,
             grid=GRID, seed: int = SEED + 51, timed: int = 0,
             bump: bool = False, keep: bool = False,
             fault: bool = False) -> dict:
    """``TP_RUNS[run]``'s SGD steps of an AnatCNN from ``weights`` through
    ``make_train_step`` on the global batch of ``tp_batch`` (``bump``: the
    scans one bfloat16 ulp up), z-score in the step; under a 3-D ``mesh``
    on the rank's shards (``shard_state``, ``shard_batch_3d``), with
    ``fault`` under ``dropped_halo()``. Returns the
    losses, the whole state dict on the CPU (``gather_state`` under a
    mesh), the first step's launches and collectives, the median ms of
    ``timed`` further steps, and with ``keep`` a function that times one
    more step (``"one"``)."""
    fused, pool, steps, dtype = {**TP_RUNS, **TP_NCCL_RUNS}[run]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    model = AnatCNN.from_hparams(hp, fused_bn=fused, maxpool_impl=pool,
                                 dtype=dtype)
    model.load_state_dict(weights)
    model.to(device)
    optimizer = torch.optim.SGD(model.parameters(), lr=DP_LR)
    step = make_train_step(model, make_criterion(hp), optimizer,
                           make_device_preprocess(normalize_mri=ZSCORE),
                           mesh=mesh)
    state = TrainState(model, optimizer)
    batch = tp_batch(grid, seed)
    if bump:
        raw = batch["mri"].to(torch.bfloat16)
        batch["mri"] = torch.nextafter(
            raw, torch.full_like(raw, float("inf"))).to(torch.float32)
    if mesh is None:
        batch = {k: v.to(device) for k, v in batch.items()}
    else:
        tp.shard_state(state, mesh)
        batch = tp.shard_batch_3d(batch, mesh)
    losses = []
    for i in range(steps):
        _sync(device)
        reset_launch_counts()
        if mesh is not None:
            mesh.reset_counts()
        with dropped_halo() if fault else contextlib.nullcontext():
            state, aux = step(state, batch)
        losses.append(aux["loss"].item())
        if i == 0:
            _sync(device)
            launches = launch_counts()
            collectives = dict(mesh.counts) if mesh is not None else {}
    whole = (tp.gather_state(model, mesh) if mesh is not None
             else model.state_dict())
    out = {"losses": losses, "launches": launches,
           "collectives": collectives,
           "state": {k: v.detach().float().cpu().clone()
                     for k, v in whole.items()}}
    def one() -> float:
        _sync(device)
        start = time.perf_counter()
        step(state, batch)
        _sync(device)
        return (time.perf_counter() - start) * 1e3

    times = [one() for _ in range(timed)]
    out["ms"] = statistics.median(times) if times else None
    if keep:
        out["one"] = one
    else:
        torch.backends.cudnn.deterministic = False
    return out


@contextlib.contextmanager
def dropped_halo(rank: int = 1):
    """A planted fault of the sharded step, to show that [tp] (b)'s bf16
    rule fails a wrong step: spatial rank ``rank`` zeroes the planes that
    its depth windows receive from the rank below (a halo exchange that
    lost them), in the forward pass."""
    real = tp._halo

    def halo(x, mesh, depth, need, fill=0.0):
        out = real(x, mesh, depth, need, fill)
        sp = mesh.spatial
        lost = tp.depth_slab(depth, sp.rank, sp.size)[0] - need[sp.rank][0]
        if sp.rank != rank or lost <= 0:
            return out
        axis = out.ndim - 3
        keep = torch.ones(out.shape[axis], dtype=out.dtype,
                          device=out.device)
        keep[:lost] = 0
        return out * keep.view([-1] + [1] * (out.ndim - axis - 1))

    tp._halo = halo
    try:
        yield
    finally:
        tp._halo = real


def tp_small_weights() -> dict:
    """The depth-10 AnatCNN's seeded weights, the classifier bias at 1 as
    ``train_model``'s (the trailing ReLU passes gradient)."""
    model = AnatCNN.from_hparams(TP_SMALL_HPARAMS,
                                 generator=make_generator(SEED + 52))
    with torch.no_grad():
        model.head.cls.bias.fill_(1.0)
    return model.state_dict()


def _spread(times: list) -> str:
    return (f"median {statistics.median(times):.2f} ms, min "
            f"{min(times):.2f}, max {max(times):.2f}")


def tp_nccl_gathers(mesh, device) -> dict:
    """The gathers of parallel/ on the one-rank nccl mesh, whose nccl
    branch is all_gather_into_tensor and reduce_scatter_tensor (the
    one-rank steps reach none of them): the channel gather and its
    reduce-scatter, the depth and spatial gathers, gather_rows, in float32
    and bfloat16; each must give back its input, one collective each."""
    from multimodal_alzheimer_tpu_torch.parallel.mesh import (
        DataParallel,
        gather_rows,
    )

    ok, counts = True, {}
    for dtype in (torch.float32, torch.bfloat16):
        mesh.reset_counts()
        x = torch.randn((2, 3, 5, 4, 6), device=device).to(dtype)
        cot = torch.randn(x.shape, device=device).to(dtype)
        leaf = x.clone().requires_grad_(True)
        y = tp._Gather.apply(leaf, mesh, 1, True)
        y.backward(cot)
        ctx = tp.TensorParallel(mesh.data, 2, 0, mesh, {(4, 6): 5})
        spread = ctx.gather_spatial(x[0])
        ok = ok and torch.equal(tp._gather(x, 2, mesh), x) and torch.equal(
            y, x) and torch.equal(leaf.grad, cot) and torch.equal(
            ctx.gather_depth(x), x) and len(spread) == 1 and torch.equal(
            spread[0], x[0]) and torch.equal(
            gather_rows(x, DataParallel(mesh.data, 2, 0)), x)
        counts[str(dtype)] = {k: v for k, v in mesh.counts.items() if v}
    want = {"all_gather": 5, "reduce_scatter": 1}
    check(ok and all(c == want for c in counts.values()),
          f"[tp] (a) nccl gathers at one rank (all_gather_into_tensor, "
          f"reduce_scatter_tensor) give back their inputs, one collective "
          f"each: {counts}")
    log(f"[tp] (a) nccl gathers at one rank, float32 and bfloat16: the "
        f"channel gather and its reduce-scatter, the depth and spatial "
        f"gathers and gather_rows give back their inputs; collectives "
        f"{counts}")
    return counts


def _device_us(e) -> float:
    """A profiler row's time on the device: a kernel's or a copy's own
    (an operator's row repeats its kernels' time, and counts 0 here)."""
    if e.device_type == torch.autograd.DeviceType.CPU or getattr(
            e, "is_user_annotation", False):
        return 0.0
    return e.self_device_time_total


def _profile_step(one) -> tuple:
    """One step (``one()``) under torch.profiler: ({"wall_ms", "device_ms"
    (every kernel's time, summed), "host_ms" (every operator's self CPU
    time, summed), "collectives" (torch.distributed's c10d calls),
    "collective_host_ms" (their CPU time, nested work included),
    "collective_device_ms" (nccl's kernels)}, a table of the collective
    rows by host time, a table of every row by device time)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall = one()
    rows = prof.key_averages()
    calls = [e for e in rows if e.key.startswith("c10d::")]
    comm = [e for e in rows if e.key.startswith("c10d::")
            or "nccl" in e.key.lower() or e.key == "record_param_comms"]
    numbers = {
        "wall_ms": wall,
        "device_ms": sum(_device_us(e) for e in rows) / 1e3,
        "host_ms": sum(e.self_cpu_time_total for e in rows) / 1e3,
        "collectives": float(sum(e.count for e in calls)),
        "collective_host_ms": sum(e.cpu_time_total for e in calls) / 1e3,
        "collective_device_ms": sum(_device_us(e) for e in comm) / 1e3}
    comm_table = "\n".join(
        f"  {e.key[:56]:56s} calls {e.count:3d}, host "
        f"{e.cpu_time_total / 1e3:.3f} ms (self "
        f"{e.self_cpu_time_total / 1e3:.3f}), device "
        f"{_device_us(e) / 1e3:.3f} ms"
        for e in sorted(comm, key=lambda e: e.cpu_time_total, reverse=True))
    return (numbers, comm_table,
            rows.table(sort_by="self_cuda_time_total", row_limit=25))


def phase_tp_nccl(device, weights: dict, grid=GRID) -> dict:
    """[tp] (a): a (1, 1, 1) mesh over one nccl rank: the flagship steps
    with fused_bn "full" and False (the stem pool through K8) bit for bit
    the mesh-free steps (losses, parameters, running statistics); then
    TP_TIMED further steps of each, timed in turns (free, mesh, mesh,
    free, ...), median and spread; then one step of each under the
    profiler: wall, device and host time, the mesh step's collectives by
    host time, and above TP_GAP_PROFILE its kernels by device time."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.distributed.init_process_group(
            "nccl", init_method=f"file://{os.path.join(tmp, 'init')}",
            world_size=1, rank=0)
        try:
            mesh = tp.make_mesh_3d(1, 1, 1)
            out["gathers"] = tp_nccl_gathers(mesh, device)
            for run in TP_NCCL_RUNS:
                ref = tp_steps(weights, DP_HPARAMS, run, device, grid=grid,
                               keep=True)
                on = tp_steps(weights, DP_HPARAMS, run, device, mesh,
                              grid=grid, keep=True)
                check(on["losses"] == ref["losses"] and all(
                    torch.equal(on["state"][k], v)
                    for k, v in ref["state"].items()),
                    f"[tp] (1, 1, 1) nccl, {run}: bit for bit the "
                    f"mesh-free step ({on['losses']} vs {ref['losses']})")
                times = {"free": [], "mesh": []}
                for i in range(TP_TIMED):
                    order = ("free", "mesh") if i % 2 == 0 else ("mesh",
                                                                 "free")
                    for which in order:
                        times[which].append(
                            (ref if which == "free" else on)["one"]())
                free_ms = statistics.median(times["free"])
                mesh_ms = statistics.median(times["mesh"])
                gap = mesh_ms / free_ms - 1.0
                out[run] = {"ms": mesh_ms, "free_ms": free_ms, "gap": gap,
                            "times": times,
                            "collectives": on["collectives"]}
                log(f"[tp] (a) (1, 1, 1) mesh, nccl, {run}: "
                    f"{len(on['losses'])} SGD steps bit for bit the "
                    f"mesh-free steps (losses {on['losses']}); then "
                    f"{TP_TIMED} steps each in turns at global batch "
                    f"{TP_BATCH}: on the mesh {_spread(times['mesh'])}, "
                    f"mesh-free {_spread(times['free'])}, gap "
                    f"{100 * gap:+.1f}%; collectives of a step "
                    f"{on['collectives']}")
                prof = {which: _profile_step((ref if which == "free"
                                              else on)["one"])
                        for which in ("free", "mesh")}
                torch.backends.cudnn.deterministic = False
                out[run]["profile"] = {k: v[0] for k, v in prof.items()}
                log(f"[tp] (a) {run}: one step of each profiled, mesh / "
                    f"mesh-free: "
                    + "; ".join(f"{k} {prof['mesh'][0][k]:.3f} / "
                                f"{prof['free'][0][k]:.3f}"
                                for k in prof["mesh"][0])
                    + "; the mesh step's collectives by host time:\n"
                    + prof["mesh"][1])
                if gap > TP_GAP_PROFILE:
                    log(f"[tp] (a) {run}: the profiled mesh step (gap above "
                        f"{100 * TP_GAP_PROFILE:.0f}%), by device time:\n"
                        + prof["mesh"][2])
                del ref, on
                torch.cuda.empty_cache()
        finally:
            torch.distributed.destroy_process_group()
    return out


def tp_rank(world, grid, small_grid) -> dict:
    """[tp] (b) on the first four of eight gloo ranks sharing the card, a
    (1, 2, 2) mesh at full width (``grid``); then (c) on all eight, a
    (2, 2, 2) mesh of the depth-10 AnatCNN at ``small_grid``."""
    device = world.device
    out = {}
    start = time.perf_counter()
    mesh_b = tp.make_mesh_3d(1, 2, 2, device=device.type)
    mesh_c = tp.make_mesh_3d(2, 2, 2, device=device.type)
    out["groups_s"] = time.perf_counter() - start
    if mesh_b is not None:
        weights = train_model(False).state_dict()
        out["b"] = {run: tp_steps(weights, DP_HPARAMS, run, device, mesh_b,
                                  grid=grid,
                                  timed=TP_TIMED_B if run == "full" else 0)
                    for run in TP_RUNS}
        out["b_fault"] = tp_steps(weights, DP_HPARAMS, "wf-bf16", device,
                                  mesh_b, grid=grid, fault=True)
        out["coords"] = mesh_b.coords
        del weights
        torch.cuda.empty_cache()
    out["c"] = tp_steps(tp_small_weights(), TP_SMALL_HPARAMS, "full",
                        device, mesh_c, grid=small_grid)
    return out


def _tp_gap(got: dict, want: dict, what: str) -> float:
    ok, worst = set(got["state"]) == set(want["state"]), 0.0
    for key, value in want["state"].items():
        diff = (got["state"][key] - value).abs()
        worst = max(worst, float(diff.max()))
        ok = ok and bool((diff <= TP_TOL["atol"]
                          + TP_TOL["rtol"] * value.abs()).all())
    losses_ok = np.allclose(got["losses"], want["losses"], rtol=TP_LOSS_RTOL,
                            atol=0)
    check(ok and losses_ok, f"{what}: losses {got['losses']} vs "
          f"{want['losses']}, largest state gap {worst:.3g} (tolerance "
          f"{TP_TOL}, loss rtol {TP_LOSS_RTOL})")
    return worst


def _step_gaps(got: dict, want: dict, weights: dict) -> tuple:
    """(relative loss gap, {tensor: relative gap of its update norm}) of a
    one-step run against another from the same ``weights``: SGD without
    momentum moves a parameter by lr times its gradient, so the update
    norms are the gradient norms (and the running statistics' own
    moves)."""
    loss = abs(got["losses"][0] - want["losses"][0]) / abs(want["losses"][0])
    gaps = {}
    for key, value in want["state"].items():
        base = weights[key].detach().float().cpu()
        ref = float((value - base).norm())
        if ref > 0:
            gaps[key] = abs(float((got["state"][key] - base).norm())
                            - ref) / ref
    return loss, gaps


def _tp_bf16_gap(got: dict, want: dict, control: dict,
                 weights: dict) -> tuple:
    """A bf16 mesh step against the one-process one under the bf16 rule of
    the [bf16 step] phase: the loss gap and the largest update-norm gap
    within BF16_FLOOR_FACTOR x the one-ulp control's plus
    BF16_FLOOR_SLACK. Returns (within the rule, (loss gap, largest
    update-norm gap, the control's two), a line of readings)."""
    loss, gaps = _step_gaps(got, want, weights)
    ctl_loss, ctl_gaps = _step_gaps(control, want, weights)
    worst, ctl_worst = max(gaps.values()), max(ctl_gaps.values())
    ok = bool(np.isfinite(got["losses"]).all()
              and loss <= BF16_FLOOR_FACTOR * ctl_loss + BF16_FLOOR_SLACK
              and worst <= BF16_FLOOR_FACTOR * ctl_worst + BF16_FLOOR_SLACK)
    top = sorted(gaps, key=gaps.get, reverse=True)[:4]
    text = (f"loss gap {loss:.3g} (limit {BF16_FLOOR_FACTOR} x {ctl_loss:.3g}"
            f" + {BF16_FLOOR_SLACK}), largest update-norm gap {worst:.3g} "
            f"(limit {BF16_FLOOR_FACTOR} x {ctl_worst:.3g} + "
            f"{BF16_FLOOR_SLACK}; control's largest at "
            f"{max(ctl_gaps, key=ctl_gaps.get)}); largest: "
            + ", ".join(f"{k} {gaps[k]:.3g} (control {ctl_gaps[k]:.3g})"
                        for k in top))
    return ok, (loss, worst, ctl_loss, ctl_worst), text


def phase_tp_kernels(device) -> dict:
    """The [tp] entry points against their plain versions at the [tp]
    shapes: K3's partials and apply on the two depth slabs (46 + 45 of 91)
    of batch 4 (the apply bit for bit; the statistics from the partials
    added in rank order within 2e-6 of the whole scan's), K8's window on
    the two edge slabs and the interior ones of the stem pool split four
    ways (bit for bit); then their device times and bounds."""
    gen = make_generator(SEED + 53, device)
    vol, mask = zscore_scans(TP_BATCH, 400.0, GRID, gen, device)
    b = TP_BATCH
    total, err = None, {}
    for q in range(2):
        lo, hi = tp.depth_slab(GRID[0], q, 2)
        part = hopper_norm.zscore_partials(vol[:, lo:hi], mask[:, lo:hi])
        want = hopper_norm.zscore_partials_plain(
            vol[:, lo:hi].reshape(b, -1), mask[:, lo:hi].reshape(b, -1))
        rel = float(((part - want).abs() / want.abs().clamp(min=1)).max())
        check(rel <= 1e-12, f"[tp] zscore_partials slab {q}: within 1e-12 "
              f"of its plain version ({rel:.3g})")
        err["zscore_partials"] = max(err.get("zscore_partials", 0.0), rel)
        total = part if total is None else total + part
    mean, std = hopper_norm.zscore_stats(total)
    rows = vol.reshape(b, -1).double(), mask.reshape(b, -1).double()
    valid = rows[0] * rows[1] != 0
    ref_mean = torch.stack([r[v].mean() for r, v in zip(rows[0], valid)])
    ref_std = torch.stack([r[v].std() for r, v in zip(rows[0], valid)])
    stats_gap = max(float(((mean.double() - ref_mean) / ref_mean).abs().max()),
                    float(((std.double() - ref_std) / ref_std).abs().max()))
    check(stats_gap <= TP_STATS_RTOL, f"[tp] split statistics within "
          f"{TP_STATS_RTOL} of the whole scan's: {stats_gap:.3g}")
    out = hopper_norm.zscore_apply(vol, mask, mean, std)
    plain = hopper_norm.zscore_apply_plain(*(t.reshape(b, -1) for t in
                                             (vol, mask)), mean, std)
    check(torch.equal(out.reshape(b, -1), plain),
          "[tp] zscore_apply bit for bit its plain version")
    err["zscore_apply"] = 0.0
    whole_err = _zscore_err(out, hopper_norm.per_scan_zscore(vol, mask),
                            "[tp] split z-score against the whole-scan K3")
    log(f"[tp] K3 split at {(b,) + GRID} over 46 + 45 planes: partials "
        f"within {err['zscore_partials']:.3g} (relative) of plain, "
        f"statistics within {stats_gap:.3g} of the whole scan's float64 "
        f"ones, apply bit for bit, output within {whole_err:.3g} of the "
        f"whole-scan K3")
    del vol, mask, out, plain, rows, valid
    tp_shape = TP_POOL
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.relu(torch.randn(tp_shape, generator=gen, device=device)
                       - 0.8).to(dtype)
        y = pool_forward(x)
        g = torch.randn(y.shape, generator=gen, device=device).to(dtype)
        depth, do = tp_shape[2], y.shape[2]
        for n in (2, 4):
            for q in range(n):
                o_lo, o_hi = tp.depth_slab(do, q, n)
                first, end = max(2 * o_lo - 1, 0), min(2 * o_hi, depth)
                args = (x[:, :, first:end].contiguous(),
                        y[:, :, o_lo:o_hi].contiguous(),
                        g[:, :, o_lo:o_hi].contiguous(), first, depth)
                got = hopper_maxpool.max_pool3d_backward(*args)
                check(torch.equal(got, max_pool3d_backward_plain(*args)),
                      f"[tp] K8 window [{first}, {end}) of {depth} (outputs "
                      f"[{o_lo}, {o_hi})) in {dtype} bit for bit its plain "
                      f"version")
        del x, y, g
    err["maxpool_bwd_window"] = 0.0
    log(f"[tp] K8 on depth windows of {tp_shape} in float32 and bfloat16: "
        f"the slabs of 2 and 4 ranks (edge windows, lead 0, through "
        f"maxpool_bwd; interior ones with their lead plane, lead 1, through "
        f"maxpool_bwd_window) bit for bit their plain versions")
    times = time_tp(gen, device)
    for name, r in times.items():
        extra = "".join(f", {key} {r[key]}" for key in
                        ("empty_ms", "blocks", "plan") if r.get(key))
        log(f"[tp] {name} {r['dims']}: kernel {r['ms']:.4f} ms (per call "
            f"{r['call_ms']:.4f}), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), no library call "
            f"computes it{extra}")
    return {"err": err, "times": times}


def phase_tp(device, grid=GRID, small_grid=TP_SMALL_GRID) -> dict:
    """[tp]: (a) on nccl, (b) and (c) on eight gloo ranks sharing the card,
    each held against the one-process run of the same batch (float32 runs
    at JAX's tp tolerances, (b)'s bf16 "wf" run within twice the gap a
    one-ulp move of the scans opens in one process); the new entry points
    against their plain versions with times. Returns the per-rank launches
    and collectives of (b)'s "full", "wf" and "wf-bf16" steps. On the CPU (a
    rehearsal) (a) and the kernels are left out."""
    weights = train_model(False).state_dict()
    free = {run: tp_steps(weights, DP_HPARAMS, run, device, grid=grid,
                          timed=TP_TIMED_B if run == "full" else 0)
            for run in TP_RUNS}
    control = tp_steps(weights, DP_HPARAMS, "wf-bf16", device, grid=grid,
                       bump=True)
    small = tp_steps(tp_small_weights(), TP_SMALL_HPARAMS, "full", device,
                     grid=small_grid)
    if device.type == "cuda":
        out_a = phase_tp_nccl(device, weights, grid)
    start = time.perf_counter()
    ranks = run_ranks(tp_rank, 8, "gloo", grid, small_grid,
                      device=device.type, timeout=600, group_timeout=600)
    spawn_s = time.perf_counter() - start
    launches, collectives, bf16_gaps = {}, {}, {}
    for r, rank in enumerate(ranks):
        if "b" in rank:
            for run, got in rank["b"].items():
                if run == "wf-bf16":
                    ok, gaps, worst = _tp_bf16_gap(got, free[run], control,
                                                   weights)
                    check(ok, f"[tp] (b) rank {r} {run}: {worst}")
                    bf16_gaps[f"rank{r}"] = gaps
                else:
                    gap = _tp_gap(got, free[run], f"[tp] (b) rank {r} {run}")
                    worst = f"largest |state - one process| {gap:.3g}"
                log(f"[tp] (b) (1, 2, 2) gloo rank {r} {rank['coords']}, "
                    f"{run}: {len(got['losses'])} SGD steps at global batch "
                    f"{TP_BATCH}, {'x'.join(map(str, grid))}, losses "
                    f"{got['losses']} vs one "
                    f"process {free[run]['losses']}, {worst}; launches of a "
                    f"step { {k: v for k, v in got['launches'].items() if v} }; "
                    f"collectives of a step {got['collectives']}"
                    + (f"; step ms {got['ms']:.2f} (four ranks sharing one "
                       f"card over gloo: a correctness run, not a rate; one "
                       f"process {free[run]['ms']:.2f})" if got["ms"] else ""))
            ok, gaps, text = _tp_bf16_gap(rank["b_fault"], free["wf-bf16"],
                                          control, weights)
            check(not ok, f"[tp] (b) rank {r}: the bf16 rule fails a step "
                  f"whose spatial rank 1 drops the halo planes it receives "
                  f"from below: {text}")
            bf16_gaps[f"rank{r} planted fault"] = gaps
            log(f"[tp] (b) rank {r} wf-bf16 with a planted fault (spatial "
                f"rank 1 drops its received halo planes): failed by the "
                f"rule, {text}")
            full = rank["b"]["full"]["launches"]
            s = rank["coords"][2]
            want = {**dict.fromkeys(full, 0), "zscore_partials": 1,
                    "zscore_apply": 1, **dict.fromkeys(BN_KERNELS,
                                                       BN_LAYERS)}
            check(full == want, f"[tp] (b) rank {r} full-step launches "
                  f"{full} == {want}")
            want_wf = dict(want, **{"maxpool_bwd_window" if s else
                                    "maxpool_bwd": 1})
            for run in ("wf", "wf-bf16"):
                got = rank["b"][run]["launches"]
                check(got == want_wf, f"[tp] (b) rank {r} {run}-step "
                      f"launches {got} == {want_wf}")
            launches[f"rank{r}"] = {run: rank["b"][run]["launches"]
                                    for run in ("full", "wf", "wf-bf16")}
            collectives[f"rank{r}"] = rank["b"]["full"]["collectives"]
        worst = _tp_gap(rank["c"], small, f"[tp] (c) rank {r}")
        log(f"[tp] (c) (2, 2, 2) gloo rank {r}: AnatCNN depth 10 at "
            f"{small_grid}, global batch {TP_BATCH}, fused_bn='full', loss "
            f"{rank['c']['losses']} vs one process {small['losses']}, largest "
            f"|state - one process| {worst:.3g}; collectives "
            f"{rank['c']['collectives']}")
    log(f"[tp] eight-rank spawn {spawn_s:.1f} s (groups made in "
        f"{ranks[0]['groups_s']:.1f} s)")
    out = {"launches": launches, "collectives": collectives,
           "bf16_gaps": bf16_gaps}
    if device.type == "cuda":
        out["nccl"] = out_a
        out.update(phase_tp_kernels(device))
    return out


def phase_fast_mode(device) -> dict:
    """[fast mode]: tools/fast_mode_study.py's main on the card at
    FAST_MODE_ARGS: its JSON line complete (both arches, every key) and
    finite."""
    start = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fast_mode_study.main(FAST_MODE_ARGS)
    line = buf.getvalue().strip().splitlines()[-1]
    got = json.loads(line)
    keys = ("best_val_loss", "best_val_mean", "eval_f1", "eval_f1_mean",
            "eval_f1_std", "eval_mcc_mean", "eval_f1_final",
            "eval_f1_final_mean", "stopped_epoch", "screen_pick_f1",
            "fit_wall_s")
    check(got["metric"] == "fast_mode_convergence"
          and all(set(got[a]) == set(keys) for a in ("dilated", "fast")),
          f"[fast mode] JSON line keys: {sorted(got)}")

    def finite(v):
        if isinstance(v, dict):
            return all(finite(x) for x in v.values())
        if isinstance(v, list):
            return all(finite(x) for x in v)
        return not isinstance(v, float) or math.isfinite(v)

    check(finite(got), f"[fast mode] every number finite: {line}")
    log(f"[fast mode] {' '.join(FAST_MODE_ARGS)}: dilated eval F1 "
        f"{got['dilated']['eval_f1_mean']}, fast "
        f"{got['fast']['eval_f1_mean']}, best val "
        f"{got['dilated']['best_val_mean']} / {got['fast']['best_val_mean']}"
        f"; {time.perf_counter() - start:.1f} s")
    log(f"[fast mode] {line}")
    return got


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
    int8_times = phase_int8_conv(device)
    op_overhead = phase_op_overhead(device)
    cores, int8_launches, int8_per_batch = phase_int8_serve(
        model, preprocess, device)
    export_launches = phase_export(cores, device)
    phase_quality(cores, device)
    del cores
    fused_route = phase_int8_fused_route(model, preprocess, device)
    del model
    stage3_int8 = phase_int8_stage3(device)
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
    stage3_launches, k10_launches = phase_stage3_step(device)
    k10_times = phase_narrow_conv(device)
    early_launches = phase_baseline_steps(device)
    with entry_split() as root:
        entry_launches, mri_checkpoint = phase_entry_points(device, root)
        _, pet_checkpoint = phase_pet_entry_points(device, root)
        _, stage2 = phase_fusion_entry_points(device, root, mri_checkpoint,
                                              pet_checkpoint)
        phase_stage3_entry_points(device, root, mri_checkpoint,
                                  pet_checkpoint, stage2)
        hpo_launches = {"screen": phase_hpo_screen(device, root)}
    with provision_root() as (root, tables):
        provision_launches = phase_provision(device, root, tables)
    hpo_launches["mri_normalize"] = phase_hpo_mri(device)
    hpo_launches["fusion_per_step"] = phase_hpo_fusion(device)
    hpo_launches.update(phase_hpo_entry_points(device))
    with tempfile.TemporaryDirectory() as root:
        converted = phase_convert(device, root)
        export_cli_launches = phase_export_cli(device, root, converted)
    phase_quality_eval(device)
    phase_dp_nccl(device)
    dp_launches = phase_dp_gloo(device)
    phase_dp_nccl_two_ranks()
    tp_result = phase_tp(device)
    phase_fast_mode(device)

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
            "launches_stage3": {k: v[name] for k, v in
                                stage3_launches.items()},
            "launches_early_fusion": {k: v[name] for k, v in
                                      early_launches.items()},
            "launches_hpo": {k: v[name] for k, v in hpo_launches.items()},
            "launches_provision": provision_launches[name],
            "launches_dp": {k: v[name] for k, v in dp_launches.items()},
            "launches_int8": {"serve": int8_launches[name],
                              "serve_per_batch": int8_per_batch[name],
                              "stage3_per_batch": stage3_int8[name],
                              "export_int8": export_launches["int8"][name],
                              "export_cli_int8": export_cli_launches[name]},
            "shape": [8, int(np.prod(GRID))], "ms": ms, "call_ms": per_call,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "host_us_custom_op": op_overhead[name]["op"],
            "host_us_direct": op_overhead[name]["direct"]})
    keys = ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    bn_per_step = {
        name: {dtype: {k: sum(BN_PER_STEP[shape] * t[shape][name][k]
                              for shape in BN_SHAPES)
                       for k in ("ms", "bound_ms", "library_ms")}
               for dtype, t in (("float32", bn_times),
                                ("bfloat16", bn_times_bf16))}
        for name in BN_KERNELS}
    for name, per in bn_per_step.items():
        log(f"[bn per step] {name}: " + "; ".join(
            f"{dtype} {v['ms']:.4f} ms a step (sum of launches x time over "
            f"the five shapes), bound {v['bound_ms']:.4f} ms, share "
            f"{v['bound_ms'] / v['ms']:.3f}, library (aten) "
            f"{v['library_ms']:.4f} ms" for dtype, v in per.items()))
    for name in BN_KERNELS:
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": fit_launches[name],
            "launches_fusion": {k: v[name] for k, v in
                                fusion_launches.items()},
            "launches_stage3": {k: v[name] for k, v in
                                stage3_launches.items()},
            "launches_early_fusion": {k: v[name] for k, v in
                                      early_launches.items()},
            "launches_hpo": {k: v[name] for k, v in hpo_launches.items()},
            "launches_dp": {k: v[name] for k, v in dp_launches.items()},
            "launches_tp": {k: v["full"][name] for k, v in
                            tp_result["launches"].items()},
            "max_abs_err": err[name], "batch": 8,
            "shape": list(BN_SHAPES["stem"]),
            **{k: bn_times["stem"][name][k] for k in keys},
            "per_step": bn_per_step[name],
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
        "launches_hpo": {k: v["maxpool_bwd"] for k, v in
                         hpo_launches.items()},
        "launches_dp": {k: v["maxpool_bwd"] for k, v in
                        dp_launches.items()},
        "launches_tp": {k: v["wf"]["maxpool_bwd"] for k, v in
                        tp_result["launches"].items()},
        "batch": 8, "shape": list(STEM), **{k: k8[k] for k in keys},
        "bfloat16": {k: pool[torch.bfloat16][1][k] for k in keys}})
    tp_times = tp_result["times"]
    for name in TP_KERNELS:
        run = "wf" if name == "maxpool_bwd_window" else "full"
        per_rank = {k: v[run][name]
                    for k, v in tp_result["launches"].items()}
        extra = {}
        if name == "zscore_partials":
            extra = {"empty_ms": tp_times[name]["empty_ms"],
                     "blocks": tp_times[name]["blocks"],
                     "batch_1": {k: tp_times[name + " B=1"][k] for k in
                                 keys + ("empty_ms", "blocks")}}
        elif name == "maxpool_bwd_window":
            extra = {"plan": tp_times[name]["plan"],
                     "launches_bf16": {k: v["wf-bf16"][name] for k, v in
                                       tp_result["launches"].items()},
                     "bfloat16": {k: tp_times[name + " bf16"][k] for k in
                                  keys + ("plan",)},
                     "edge": {dt: {k: tp_times["maxpool_bwd edge " + dt][k]
                                   for k in keys + ("plan",)}
                              for dt in ("f32", "bf16")}}
        kernels.append({
            "name": name, "route": "cuda", "source": TP_SOURCE[name],
            "replaces": TP_REPLACES[name],
            # spatial rank 1 of the (1, 2, 2) mesh, whose pool window is
            # an interior one
            "launches": per_rank["rank1"], "launches_tp": per_rank,
            "collectives_tp": tp_result["collectives"],
            "max_abs_err": tp_result["err"][name], "batch": TP_BATCH,
            "shape": list(TP_POOL if name == "maxpool_bwd_window"
                          else TP_ZSCORE),
            **{k: tp_times[name][k] for k in keys}, **extra})
    per_forward = {b: {
        "ms": r["total"]["graph_ms"], "bound_ms": r["total"]["graph_bound_ms"],
        "ms_f32_out": r["total"]["ms"],
        "bound_ms_f32_out": r["total"]["bound_ms"],
        "library_ms": r["total"]["library_ms"],
        "cudnn_bf16_ms": r["total"]["cudnn_bf16_ms"],
        **{k: sum(r[n]["f32"][k] * INT8_CONV_SHAPES[n][-1]
                  for n in INT8_CONV_SHAPES)
           for k in ("call_ms", "plain_ms") if r["stem"]["f32"][k]
           is not None}}
        for b, r in int8_times.items()}
    by_ops = sum(r["f32"]["bound_ms"] * INT8_CONV_SHAPES[n][-1]
                 for n, r in int8_times[8].items() if n != "total"
                 and r["f32"]["bound_by"] == "operations")
    kernels.append({
        "name": "int8_conv3d", "route": "cuda",
        "source": SOURCE["int8_conv3d"], "replaces": REPLACES["int8_conv3d"],
        "launches": int8_launches["int8_conv3d"],
        "launches_int8": {"serve_per_batch": int8_per_batch["int8_conv3d"],
                          "stage3_per_batch": stage3_int8["int8_conv3d"],
                          "export_int8": export_launches["int8"][
                              "int8_conv3d"],
                          "export_folded": export_launches["folded"][
                              "int8_conv3d"],
                          "export_cli_int8": export_cli_launches[
                              "int8_conv3d"],
                          "fused_route_per_batch": fused_route[
                              "int8_conv3d"]},
        "launches_dp": {k: v["int8_conv3d"] for k, v in dp_launches.items()},
        "max_abs_err": max(m["max_abs_err"] for n, r in int8_times[8].items()
                           if n != "total" for m in r.values()),
        "batch": 8,
        "shape": "the 20 convolutions of one ResNet-18 forward, 91x109x91, "
                 "in the int8 graph's epilogue modes",
        "plain_ms": None, **per_forward[8],
        "library": "torch._int_mm on im2col columns of the same M, N, K: "
                   "GEMM only, not the same function",
        "bound_by": ("operations" if by_ops >= per_forward[8][
            "bound_ms_f32_out"] / 2 else "bytes"),
        "batch_32": per_forward[32],
        "per_shape": {b: {n: {mode: {k: m[k] for k in (
            "max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "cudnn_bf16_ms")}
            for mode, m in r[n].items()} for n in INT8_CONV_SHAPES}
            for b, r in int8_times.items()},
        "host_us_custom_op": op_overhead["int8_conv3d"]["op"],
        "host_us_direct": op_overhead["int8_conv3d"]["direct"]})
    k10 = [(layer, direction, r) for layer, per in k10_times.items()
           for direction, r in per.items()]
    k10_step = {key: sum(NARROW_CALLS_PER_STEP * r[key] for *_, r in k10)
                for key in ("ms", "bound_ms", "library_ms")}
    kernels.append({
        "name": "narrow_conv3d", "route": "cuda",
        "source": SOURCE["narrow_conv3d"],
        "replaces": REPLACES["narrow_conv3d"],
        "launches": k10_launches["bfloat16 trained"],
        "launches_stage3": k10_launches,
        "max_abs_err": max(max(r["max_abs_err"], r.get("db", r)[
            "max_abs_err"]) for *_, r in k10),
        "max_rel_l2": max(max(r["rel_l2"], r.get("db", r)["rel_l2"])
                          for *_, r in k10),
        "batch": NARROW_BATCH,
        "shape": "each direction the rule takes of the PET towers' block_0 "
                 "and block_1 in a bf16 stage-3 step (two towers at batch "
                 "32)",
        **k10_step, "plain_ms": k10_step["library_ms"],
        "bound_by": "bytes (block_0) and operations (block_1)",
        "library": "cuDNN's bf16 F.conv3d and convolution_backward, the "
                   "plain version",
        "per_shape": {f"{layer} {direction}": {k: r[k] for k in (
            "dims", "shape", "ms", "call_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "rel_l2", "max_abs_err")}
            for layer, direction, r in k10}})
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
