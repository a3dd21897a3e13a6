"""BatchNorm precision in a real train step, kernels and cuDNN against float64.

    python3 -m multimodal_alzheimer_tpu_torch.tools.bn_precision [--out DIR]

Runs one forward and backward of the flagship ResNet-18 ``AnatCNN``
(dilated, float32, TF32 off, ``fused_bn="full"``, random weights from a
seed, classifier bias 1 so the trailing ReLU passes gradient) on 8 raw
91x109x91 scans preprocessed by the min-max kernels, and catches every
backbone BatchNorm's input x and output gradient g. For each layer, on the
same x and g, it reports against a float64 computation:

* ``var``: the largest relative error over channels of the batch variance,
  the kernels' ``E[x^2] - E[x]^2`` (``bn_stats``) and cuDNN's
  (``torch.batch_norm_stats``);
* ``dscale``, ``dbias``, ``dx``: ``|err| / |ref|`` of the kernels
  (``bn_grad_sum``, ``bn_dx``) and of cuDNN
  (``torch.batch_norm_backward_reduce`` and ``_elemt``), all given the
  kernels' mean and inverse deviation;
* ``cancellation``: ``|sum |g * xhat|| / |sum g * xhat|`` over channels,
  how far the dscale sums cancel.

It prints one line per layer and the card's name and power limit, and
writes ``bn_precision.json`` under ``--out`` (default ``profile_out/``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.data.synthetic import make_labeled_volumes
from multimodal_alzheimer_tpu_torch.losses.classification import (
    weighted_cross_entropy,
)
from multimodal_alzheimer_tpu_torch.models import layers
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.ops import hopper_bn
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

GRID = (91, 109, 91)
SEED = 0
EPS = 1e-5


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.double() - ref).norm() / ref.norm()).item()


def layer_precision(x: torch.Tensor, g: torch.Tensor,
                    scale: torch.Tensor) -> dict:
    """One BatchNorm's statistics and backward against float64."""
    dims = [0] + list(range(2, x.ndim))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    n = x.numel() // x.shape[1]
    x64, g64 = x.double(), g.double()
    var64 = x64.var(dims, unbiased=False)
    sums = hopper_bn.bn_stats(x)
    mean = sums[0] / n
    var = sums[1] / n - mean * mean
    inv = torch.rsqrt(var + EPS)
    cudnn_var = torch.batch_norm_stats(x, 0.0)[1].double() ** -2

    m64, i64 = mean.double().view(shape), inv.double().view(shape)
    xhat = (x64 - m64) * i64
    dbias, dscale = g64.sum(dims), (g64 * xhat).sum(dims)
    dx = scale.double().view(shape) * i64 * (
        g64 - (dbias / n).view(shape) - xhat * (dscale / n).view(shape))
    k_sums = hopper_bn.bn_grad_sum(g, x, mean, inv)
    k_dx = hopper_bn.bn_dx(g, x, mean, inv, scale, k_sums / n)
    c_sum_dy, c_sum_dy_xmu, c_dscale, c_dbias = \
        torch.batch_norm_backward_reduce(g, x, mean, inv, scale, True, True,
                                         True)
    c_dx = torch.batch_norm_backward_elemt(
        g, x, mean, inv, scale, c_sum_dy, c_sum_dy_xmu,
        torch.tensor([n], dtype=torch.int32, device=x.device))
    return {
        "shape": list(x.shape),
        "max_abs_mean_over_std": (x64.mean(dims).abs()
                                  / var64.sqrt()).max().item(),
        "var": {"kernel": ((var.double() - var64).abs() / var64).max().item(),
                "cudnn": ((cudnn_var - var64).abs() / var64).max().item()},
        "cancellation": ((g64 * xhat).abs().sum(dims).norm()
                         / dscale.norm()).item(),
        "dscale": {"kernel": _rel(k_sums[1], dscale),
                   "cudnn": _rel(c_dscale, dscale)},
        "dbias": {"kernel": _rel(k_sums[0], dbias),
                  "cudnn": _rel(c_dbias, dbias)},
        "dx": {"kernel": _rel(k_dx, dx), "cudnn": _rel(c_dx, dx)},
    }


def capture_step(device) -> dict:
    """{layer name: (x, g, scale)} of every backbone BatchNorm in one
    forward and backward."""
    model = AnatCNN.from_hparams(
        {"n_classes": 2, "resnet_depth": 18, "linear_out": ()},
        fused_bn="full", generator=make_generator(SEED))
    with torch.no_grad():
        model.head.cls.bias.fill_(1.0)
    model.to(device).train()
    xs, gs = {}, {}
    handles = []
    for name, module in model.named_modules():
        if isinstance(module, layers.FusedBatchNorm):
            handles.append(module.register_forward_pre_hook(
                lambda m, args, name=name: xs.__setitem__(
                    name, args[0].detach().clone())))
            handles.append(module.register_full_backward_hook(
                lambda m, gin, gout, name=name: gs.__setitem__(
                    name, gout[0].detach().clone())))
    data = make_labeled_volumes(8, GRID, n_classes=2, seed=SEED + 6)
    batch = make_device_preprocess(
        normalize_mri={"per_scan_norm": "min_max"}, quantile=0.99)(
        {k: torch.from_numpy(data[k]).to(device)
         for k in ("mri", "mri_mask", "label")})
    out = model(batch)
    weighted_cross_entropy(out["logits"], batch["label"]).backward()
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    modules = dict(model.named_modules())
    return {name: (xs[name], gs[name], modules[name].weight.detach())
            for name in xs}


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
        raise SystemExit("bn_precision needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    report = {"device": nvidia_smi(), "torch": torch.__version__,
              "layers": {}}
    for name, (x, g, scale) in capture_step(device).items():
        r = layer_precision(x, g, scale)
        report["layers"][name] = r
        print(f"[bn precision] {name}: max |mean|/std "
              f"{r['max_abs_mean_over_std']:.2f}, cancellation "
              f"{r['cancellation']:.1f}; kernel / cuDNN: var "
              f"{r['var']['kernel']:.2e} / {r['var']['cudnn']:.2e}, dscale "
              f"{r['dscale']['kernel']:.2e} / {r['dscale']['cudnn']:.2e}, "
              f"dbias {r['dbias']['kernel']:.2e} / {r['dbias']['cudnn']:.2e}"
              f", dx {r['dx']['kernel']:.2e} / {r['dx']['cudnn']:.2e}",
              flush=True)
    worst = {k: {side: float(np.max([r[k][side]
                                     for r in report["layers"].values()]))
                 for side in ("kernel", "cudnn")}
             for k in ("var", "dscale", "dbias", "dx")}
    report["worst"] = worst
    print(f"[bn precision] worst over {len(report['layers'])} layers: "
          f"{json.dumps(worst)}", flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "bn_precision.json").write_text(json.dumps(report, indent=1))
    print(report["device"], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
