"""Where the time of TabPFN and of the MRI+tabular fusion step goes, on one
NVIDIA GPU.

    python3 -m multimodal_alzheimer_tpu_torch.tools.profile_paths [--out DIR]

Cases, each warmed up and then run ``CALLS`` times under ``torch.profiler``
with every call inside a ``record_function`` span (float32 with TF32 off,
or bfloat16 compute; random weights from a seed):

* ``tabpfn_{f32,bf16}``: ``TabPFNClassifier.predict_proba`` at the width
  of tabpfn's published checkpoint (``chip_smoke.py``'s TabPFN phase: 12
  layers, emsize 512, 1000 train + 200 test rows of 9 features, 4 members
  in one batched forward), probabilities copied to the host;
* ``fusion_{frozen,unfrozen}_{f32,bf16}``: one ``TabularMRIFusion`` train
  step (ResNet-18 tower with ``fused_bn="full"``, ``TabularMLP`` (256,
  1024), batch 8 of raw 91x109x91 scans min-max normalised in the step),
  ending in a synchronisation.

Per case, as ``tools/profile_serve.py`` reads a trace: ``host_ms`` (the
span of a call), ``busy_ms`` (the union of device intervals inside it),
``idle_share`` (1 - busy / span), device time by kind (``gemm``: cuBLAS and
cuDNN matmul and convolution kernels; ``port``: the port's CUDA kernels;
``memory``: copies and sets; ``other``: elementwise, reductions, softmax,
casts) and the ten largest kernels by device ms per call. It prints one
line per case and the card's name and power limit, and writes
``profile_paths.json`` and each case's Chrome trace under ``--out``
(default ``profile_out/``). The profiler adds host time to every launch,
so ``host_ms`` and ``idle_share`` read above an unprofiled run.
"""

from __future__ import annotations

import argparse
import json
import statistics
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.data.synthetic import make_labeled_volumes
from multimodal_alzheimer_tpu_torch.losses.classification import (
    make_criterion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.tabular_mri_fusion import (
    TabularMRIFusion,
)
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabpfn import (
    TabPFNClassifier,
    TabPFNTransformer,
)
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp import (
    TabularMLP,
    compute_feature_stats,
)
from multimodal_alzheimer_tpu_torch.tools.profile_serve import (
    breakdown,
    nvidia_smi,
)
from multimodal_alzheimer_tpu_torch.train.driver import fusion_optimizer
from multimodal_alzheimer_tpu_torch.train.state import (
    TrainState,
    make_train_step,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

CALLS = 3
SEED = 0
GRID = (91, 109, 91)
SPAN = "path_call"
GEMM_WORDS = ("gemm", "xmma", "cutlass", "conv", "fprop", "dgrad", "wgrad",
              "implicit", "winograd", "cudnn")
# The port's kernels (csrc/*.cu, each in an anonymous namespace); torch's
# own kernels of the same names live in at::native.
PORT_KERNELS = ("select_cluster_kernel", "minmax_apply_kernel",
                "zscore_kernel", "reduce_kernel", "apply_kernel", "dx_kernel",
                "maxpool_bwd_kernel")


def kind(event: dict) -> str:
    """The kind of one device event of a Chrome trace."""
    if event["cat"] != "kernel":
        return "memory"
    name = event["name"]
    if "at::native" not in name and any(
            f"::{k}<" in name or f"::{k}(" in name for k in PORT_KERNELS):
        return "port"
    if any(w in name.lower() for w in GEMM_WORDS):
        return "gemm"
    return "other"


def tabpfn_call(dtype, device):
    """predict_proba of a fitted full-width classifier."""
    rng = np.random.default_rng(SEED + 13)
    y = rng.integers(0, 3, 1200)
    x = (rng.normal(size=(1200, 9)) + 0.5 * y[:, None]).astype(np.float32)
    model = TabPFNTransformer(dtype=dtype, generator=make_generator(SEED))
    clf = TabPFNClassifier(state_dict=model.state_dict(), model=model,
                           ensemble_size=4, device=device)
    clf.fit(x[:1000], y[:1000])
    return lambda: clf.predict_proba(x[1000:])


def fusion_call(dtype, frozen: bool, device):
    """One TabularMRIFusion train step on a fixed batch of raw scans."""
    data = make_labeled_volumes(8, GRID, n_classes=2, seed=SEED + 14,
                                modalities=("mri", "tabular"))
    data["label"] = (np.arange(8) % 2).astype(np.int32)
    mean, std = compute_feature_stats(data["tabular"])
    batch = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    gen = make_generator(SEED)
    model = TabularMRIFusion(
        2, AnatCNN(n_classes=2, resnet_depth=18, fused_bn="full",
                   dtype=dtype, generator=gen),
        TabularMLP(2, (256, 1024), feature_mean=mean, feature_std=std,
                   dtype=dtype, generator=gen),
        freeze_towers=frozen, dtype=dtype, generator=gen).to(device)
    hp = {"n_classes": 2, "lr": 1e-3, "l2_reg": 1e-2,
          "lr_pretrained": None if frozen else 1e-5,
          "loss_class_weights": [0.5, 0.5]}
    optimizer = fusion_optimizer(hp, ("reduce_tab", "stage2out", "cls2"),
                                 model)
    step = make_train_step(model, make_criterion(hp), optimizer,
                           make_device_preprocess(
                               normalize_mri={"per_scan_norm": "min_max"}))
    state = TrainState(model, optimizer)

    def call():
        step(state, batch)
        torch.cuda.synchronize()

    return call


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="profile_out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_paths needs an NVIDIA GPU")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    report = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "calls": CALLS, "cases": {}}
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    cases = [(f"tabpfn_{d}", lambda d=d: tabpfn_call(dtypes[d], device))
             for d in dtypes]
    cases += [(f"fusion_{'frozen' if f else 'unfrozen'}_{d}",
               lambda d=d, f=f: fusion_call(dtypes[d], f, device))
              for f in (True, False) for d in dtypes]
    for name, build in cases:
        call = build()
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                with record_function(SPAN):
                    call()
        trace_path = out / f"profile_paths_{name}.json"
        prof.export_chrome_trace(str(trace_path))
        case = breakdown(json.loads(trace_path.read_text()), CALLS, SPAN,
                         kind)
        case["kernels_ms"] = dict(list(case["kernels_ms"].items())[:10])
        case["trace"] = str(trace_path)
        report["cases"][name] = case
        kinds = ", ".join(f"{k} {v:.3f} ms" for k, v in
                          case["kind_ms"].items())
        top = "; ".join(f"{n[:60]} {v:.3f}" for n, v in
                        list(case["kernels_ms"].items())[:5])
        print(f"[profile] {name}: host "
              f"{statistics.median(case['host_ms']):.3f} ms/call, device "
              f"busy {statistics.median(case['busy_ms']):.3f} ms/call, idle "
              f"share {case['idle_share']:.4f}; per call {kinds}; largest: "
              f"{top}", flush=True)
        del call
        torch.cuda.empty_cache()
    (out / "profile_paths.json").write_text(json.dumps(report, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
