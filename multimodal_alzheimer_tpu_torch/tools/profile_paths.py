"""Where the time of TabPFN, of the fusion train steps and of the fusion
baselines' train steps goes, on one NVIDIA GPU.

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
  ending in a synchronisation;
* ``stage3_{frozen,trained}_{f32,bf16}``: one ``AllModalitiesFusion``
  train step (``tools/cases.stage3_model``: ResNet-18 ``"full"`` MRI
  towers, ``SmallPETCNN`` at its defaults, ``TabularMLP`` (256, 1024);
  frozen with shared towers, or every tower trained), batch 8 of raw scans,
  PET z-scored and MRI min-max normalised in the step (``chip_smoke.py``'s
  stage-3 phase, on the same case);
* ``early_{f32,bf16}`` and ``featuremap_{f32,bf16}``: one train step of
  the ``tools/cases.BASELINES`` cases "early differentnorm"
  (``PETMRIEarlyFusion`` at ``BEST_HPARAMS``, batch 64, MRI min-max) and
  "featuremap maxout" (``PETMRIFeatureMapFusion`` at
  ``BEST_MAXOUT_HPARAMS``, batch 32, MRI all-scan z-score), as
  ``chip_smoke.py``'s baseline phase runs them.

With ``--convs B`` the one case is ``stage3_trained_bf16``, the step's
batch ``B`` raw samples, profiled with the shapes recorded: the device
kernels launched under each ``aten::convolution`` (forward) or
``aten::convolution_backward`` op are charged to the op's layer, read from
its weight's (C_in, C_out, k) (the ``SmallPETCNN`` blocks by name, every
other conv "resnet"), and to a direction by kernel name (``fprop``,
``dgrad``, ``wgrad``, ``transpose``: cuDNN's NCHW/NHWC layout kernels,
``other``: bias sums, casts); K10's kernels (``ops/narrow_conv.py``),
launched outside any aten op, by their template's (C_in, C_out, k). The
case then also carries ``convs_ms``, {layer: {direction: device ms a
call}}, one line printed per layer.

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
import re
import statistics
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.losses.classification import (
    make_criterion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.tabular_mri_fusion import (
    TabularMRIFusion,
)
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
    SmallPETCNN,
)
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabpfn import (
    TabPFNClassifier,
    TabPFNTransformer,
)
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp import (
    TabularMLP,
)
from multimodal_alzheimer_tpu_torch.ops import narrow_conv
from multimodal_alzheimer_tpu_torch.tools.cases import (
    FUSION_HPARAMS,
    GRID,
    MINMAX,
    SEED,
    STAGE3_REGIMES,
    TAB_HPARAMS,
    baseline_batch,
    baseline_case,
    raw_batch,
    stage3_model,
    stage3_preprocess,
)
from multimodal_alzheimer_tpu_torch.tools.profile_serve import (
    breakdown,
    nvidia_smi,
)
from multimodal_alzheimer_tpu_torch.train.driver import fusion_optimizer
from multimodal_alzheimer_tpu_torch.train.optim import single_lr_optimizer
from multimodal_alzheimer_tpu_torch.train.state import (
    TrainState,
    make_train_step,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

CALLS = 3
# profiled case -> its tools/cases.BASELINES name
BASELINE_CASES = {"early": "early differentnorm",
                  "featuremap": "featuremap maxout"}
SPAN = "path_call"
GEMM_WORDS = ("gemm", "xmma", "cutlass", "conv", "fprop", "dgrad", "wgrad",
              "implicit", "winograd", "cudnn")
# The port's kernels (csrc/*.cu, each in an anonymous namespace); torch's
# own kernels of the same names live in at::native.
PORT_KERNELS = ("select_cluster_kernel", "minmax_apply_kernel",
                "zscore_kernel", "reduce_kernel", "apply_kernel", "dx_kernel",
                "maxpool_bwd_kernel", "narrow_conv_fprop_kernel",
                "narrow_conv_wgrad_kernel", "narrow_conv_wgrad_folded_kernel",
                "narrow_conv_merge_kernel")
CONV_OPS = ("aten::convolution", "aten::convolution_backward")
DIRECTIONS = ("fprop", "dgrad", "wgrad", "transpose", "other")
# K10's kernels carry (C_in, C_out, k) as their first template arguments;
# its input gradient runs the fprop kernel on (C_out, C_in)
NARROW = re.compile(
    r"narrow_conv_(fprop|wgrad|merge)\w*<(\d+), (\d+), (\d+)")


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


def direction(kernel: str) -> str:
    """The direction of one cuDNN kernel launched for a convolution."""
    low = kernel.lower()
    for word in ("dgrad", "wgrad", "fprop"):
        if word in low:
            return word
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "transpose"
    return "other"


def _kernels(event) -> list:
    """(name, µs) of every device kernel launched under ``event``."""
    out = [(k.name, k.duration) for k in event.kernels]
    for child in event.cpu_children:
        out += _kernels(child)
    return out


def conv_layers(events, calls: int) -> dict:
    """{layer: {direction: device ms a call}} of the convolutions in a
    profile recorded with shapes (the module docstring)."""
    pet = {(m.in_channels, m.out_channels, m.kernel_size[0]): f"pet.{name}"
           for name, m in SmallPETCNN(2).named_modules()
           if isinstance(m, torch.nn.Conv3d)}
    table: dict = {}

    def add(layer, kind, us):
        row = table.setdefault(layer, dict.fromkeys(DIRECTIONS, 0.0))
        row[kind] += us / 1e3 / calls

    for e in events:
        if e.name not in CONV_OPS or (e.cpu_parent is not None
                                      and e.cpu_parent.name in CONV_OPS):
            continue
        # the forward's inputs are (x, weight, ...), the backward's
        # (dy, x, weight, ...)
        w = e.input_shapes[1 if e.name == CONV_OPS[0] else 2]
        layer = (pet.get((w[1], w[0], w[2]), "resnet") if len(w) == 5
                 else "other")
        for name, us in _kernels(e):
            add(layer, direction(name), us)
    for e in events:
        m = NARROW.search(e.name)
        if e.device_type != torch.autograd.DeviceType.CUDA or m is None:
            continue
        kind, cin, cout, k = m.group(1), *map(int, m.groups()[1:])
        if kind == "fprop" and (cin, cout, k) not in narrow_conv.SHAPES:
            kind, cin, cout = "dgrad", cout, cin
        add(pet.get((cin, cout, k), f"narrow {cin}->{cout} k{k}"),
            "wgrad" if kind == "merge" else kind, e.time_range.elapsed_us())
    return dict(sorted(table.items()))


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
    batch, (mean, std) = raw_batch(("mri", "tabular"), GRID, SEED + 14,
                                   device)
    gen = make_generator(SEED)
    model = TabularMRIFusion(
        2, AnatCNN(n_classes=2, resnet_depth=18, fused_bn="full",
                   dtype=dtype, generator=gen),
        TabularMLP(2, (256, 1024), feature_mean=mean, feature_std=std,
                   dtype=dtype, generator=gen),
        freeze_towers=frozen, dtype=dtype, generator=gen).to(device)
    hp = dict(FUSION_HPARAMS, lr_pretrained=None if frozen else 1e-5)
    optimizer = fusion_optimizer(hp, ("reduce_tab", "stage2out", "cls2"),
                                 model)
    return _step_call(model, hp, optimizer,
                      make_device_preprocess(normalize_mri=MINMAX), batch)


def _step_call(model, hp: dict, optimizer, preprocess, batch,
               dropout_generator=None):
    step = make_train_step(model, make_criterion(hp), optimizer, preprocess,
                           dropout_generator)
    state = TrainState(model, optimizer)

    def call():
        step(state, batch)
        torch.cuda.synchronize()

    return call


def stage3_call(dtype, frozen: bool, device, n: int = 8):
    """One AllModalitiesFusion train step on a fixed batch of ``n`` raw
    samples (``tools/cases.stage3_batch``'s at 8)."""
    batch, (mean, std) = raw_batch(("mri", "pet1451", "tabular"), GRID,
                                   SEED + 17, device, n=n)
    lr_pretrained = STAGE3_REGIMES["frozen" if frozen else "trained"]
    model = stage3_model(dtype, lr_pretrained,
                         dict(TAB_HPARAMS, feature_mean=mean,
                              feature_std=std), device=device)
    hp = dict(FUSION_HPARAMS, lr_pretrained=lr_pretrained)
    return _step_call(model, hp, fusion_optimizer(hp, ("stage3out", "cls3"),
                                                  model),
                      stage3_preprocess(), batch)


def baseline_call(name: str, dtype, device):
    """One train step of the ``BASELINES`` case ``name``."""
    model, hp, preprocess = baseline_case(name, dtype, device)
    batch = {k: v[:hp["batch_size"]]
             for k, v in baseline_batch(device).items()}
    return _step_call(model, hp, single_lr_optimizer(model, hp["lr"]),
                      preprocess, batch, make_generator(SEED, device))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="profile_out")
    parser.add_argument("--convs", type=int, default=0, metavar="B",
                        help="profile only the bf16 stage-3 step with every "
                             "tower trained at batch B, its convolutions by "
                             "layer and direction")
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
    cases += [(f"stage3_{'frozen' if f else 'trained'}_{d}",
               lambda d=d, f=f: stage3_call(dtypes[d], f, device))
              for f in (True, False) for d in dtypes]
    cases += [(f"{b}_{d}", lambda d=d, b=b: baseline_call(BASELINE_CASES[b],
                                                          dtypes[d], device))
              for b in BASELINE_CASES for d in dtypes]
    if args.convs:
        cases = [("stage3_trained_bf16", lambda: stage3_call(
            torch.bfloat16, False, device, args.convs))]
        report["batch"] = args.convs
    for name, build in cases:
        call = build()
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=bool(args.convs)) as prof:
            for _ in range(CALLS):
                with record_function(SPAN):
                    call()
        trace_path = out / f"profile_paths_{name}.json"
        prof.export_chrome_trace(str(trace_path))
        case = breakdown(json.loads(trace_path.read_text()), CALLS, SPAN,
                         kind)
        case["kernels_ms"] = dict(list(case["kernels_ms"].items())[:10])
        case["trace"] = str(trace_path)
        if args.convs:
            case["convs_ms"] = conv_layers(prof.events(), CALLS)
            for layer, row in case["convs_ms"].items():
                print(f"[convs] {layer}: " + ", ".join(
                    f"{k} {v:.3f}" for k, v in row.items())
                    + f"; all {sum(row.values()):.3f} ms a step", flush=True)
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
