"""Plain PyTorch reference of the configurations' models, in float32.

Written from the published descriptions and the reference repository's
modules, independent of the program: the configuration's backbone (a file
``reference/backbones/<backbone>.py``, found by the configuration's
``backbone`` key) with its GAP + Linear + ReLU head; the small PET CNN (conv 'same' ->
ReLU -> max pool 2, four times, GAP, Linear 64 + ReLU, Linear); the tabular
MLP (standardised features, Linear 256 + ReLU, Linear 1024 + ReLU,
Linear); the three stage-2 late fusions and stage 3; the masked per-scan
z-score and quantile min-max; the weighted cross-entropy.

The parameters are a dict of tensors under the program's ``state_dict``
names, so one draw of weights feeds both. ``Numerics`` says how every
convolution and dense layer computes: float32 (the reference), or with its
operands, its output and their gradients rounded to float8 e4m3 with a
per-tensor scale (the control: the nearest precision below the
configuration's bfloat16). BatchNorm in train mode normalises with the
batch's mean and biased variance (eps 1e-5), in eval mode with the running
statistics.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
FP8_MAX = 448.0  # the largest float8 e4m3fn value


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale that maps its
    largest magnitude to the format's largest value."""
    amax = x.detach().abs().amax()
    if not torch.isfinite(amax) or amax == 0:
        return x
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


class _RoundFp8(torch.autograd.Function):
    """Rounds values forward and gradients backward to float8."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


class Numerics:
    """How the convolutions and dense layers compute: ``"float32"`` or
    ``"fp8"``."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "fp8"):
            raise ValueError(f"numerics {kind!r}")
        self.kind = kind

    def _q(self, x):
        return _RoundFp8.apply(x) if self.kind == "fp8" else x

    def conv(self, x, w, b=None, stride=1, padding=0, dilation=1):
        return self._q(F.conv3d(self._q(x), self._q(w), b, stride, padding,
                                dilation))

    def linear(self, x, w, b):
        return self._q(F.linear(self._q(x), self._q(w), b))


F32 = Numerics("float32")


def batch_norm(P, name, x, train: bool):
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    shape = (1, -1) + (1,) * (x.ndim - 2)
    if train:
        axes = [0] + list(range(2, x.ndim))
        mean = x.mean(axes, keepdim=True)
        var = ((x - mean) ** 2).mean(axes, keepdim=True)
    else:
        mean = P[f"{name}.running_mean"].reshape(shape)
        var = P[f"{name}.running_var"].reshape(shape)
    return (x - mean) / torch.sqrt(var + BN_EPS) * w.reshape(shape) + \
        b.reshape(shape)


# What the reference implements of a configuration's architecture besides
# its backbone: each key's one value (a GAP + Linear + ReLU head; stage 3
# with two private towers of each kind, shared once when frozen).
IMPLEMENTED = {
    "anat_cnn": {"linear_out": [], "batchnorm_begin": False,
                 "trailing_relu": True},
    "all_modalities_fusion": {
        "linear_out": [], "batchnorm_begin": False, "trailing_relu": True,
        "pet_tower_simple_dim_red": True, "frozen_towers_shared": True,
        "towers": {"mri": 2, "pet": 2, "tab": 2}},
}


def backbone(config: dict, bench_dir):
    """The module of ``reference/backbones/<backbone>.py`` under
    ``bench_dir``, named by the configuration's ``backbone``; ValueError
    where there is no such file, or where the configuration's architecture
    keys differ from the file's ``KEYS``."""
    name = config.get("backbone")
    path = Path(bench_dir) / "reference" / "backbones" / f"{name}.py"
    if not (isinstance(name, str) and name.isidentifier()
            and path.is_file()):
        raise ValueError(f"no backbone file for backbone={name!r}")
    spec = importlib.util.spec_from_file_location(
        f"_portbench_backbone_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    bad = [f"{k}={config.get(k)!r} (the backbone {name!r} implements {v!r})"
           for k, v in module.KEYS.items() if config.get(k) != v]
    if bad:
        raise ValueError(f"configuration {config.get('name')!r}: "
                         + "; ".join(bad))
    return module


def check_architecture(config: dict, bench_dir):
    """The configuration's backbone module (``backbone``), after refusing a
    configuration whose architecture keys ask for what the reference does
    not implement (ValueError), rather than compare and count a model other
    than the one the program builds."""
    model = config.get("model")
    if model not in IMPLEMENTED:
        raise ValueError(f"the reference implements no model {model!r}")
    module = backbone(config, bench_dir)
    bad = [f"{k}={config.get(k)!r} (implemented: {v!r})"
           for k, v in IMPLEMENTED[model].items() if config.get(k) != v]
    if model == "all_modalities_fusion":
        pet, tab = config["pet"], config["tabular"]
        if pet["batchnorm"] or not pet["linear_out"]:
            bad.append("pet: batchnorm off and a hidden Linear implemented")
        if len(pet["conv_out"]) != len(pet["filter_size"]) or any(
                k % 2 == 0 for k in pet["filter_size"]):
            bad.append("pet: one odd filter size a conv implemented")
        if tab["dropout_p"] != 0.0:
            bad.append("tabular: dropout_p 0 implemented")
    if bad:
        raise ValueError(f"configuration {config.get('name')!r}: "
                         + "; ".join(bad))
    return module


def anat_cnn(P, pre, x, train: bool, net, nm: Numerics = F32) -> dict:
    """The backbone ``net`` (a backbone module) -> GAP (the
    ``backbone_gap`` tap) -> Linear -> ReLU."""
    gap = net.forward(P, pre + "backbone.", x, train, nm).mean((2, 3, 4))
    logits = F.relu(nm.linear(gap, P[pre + "head.cls.weight"],
                              P[pre + "head.cls.bias"]))
    return {"logits": logits, "gap": gap}


def pet_cnn(P, pre, x, nm: Numerics = F32) -> dict:
    """Conv 'same' + bias -> ReLU -> max pool 2 blocks, as many as the
    weights hold, GAP (the ``gap`` tap), Linear + ReLU, Linear."""
    i = 0
    while f"{pre}convs.block_{i}.conv.weight" in P:
        w = P[f"{pre}convs.block_{i}.conv.weight"]
        x = nm.conv(x, w, P[f"{pre}convs.block_{i}.conv.bias"],
                    padding=w.shape[-1] // 2)
        x = F.max_pool3d(F.relu(x), 2, 2)
        i += 1
    gap = x.mean((2, 3, 4))
    h = F.relu(nm.linear(gap, P[pre + "hidden.weight"], P[pre + "hidden.bias"]))
    return {"logits": nm.linear(h, P[pre + "cls.weight"], P[pre + "cls.bias"]),
            "gap": gap}


def tabular_mlp(P, pre, x, mean, std, nm: Numerics = F32) -> dict:
    """Standardised features -> (Linear + ReLU), as many as the weights
    hold (the last one's output is the ``decoder`` tap) -> Linear."""
    h = (x - mean) / std
    i = 0
    while f"{pre}dense_{i}.weight" in P:
        h = F.relu(nm.linear(h, P[f"{pre}dense_{i}.weight"],
                             P[f"{pre}dense_{i}.bias"]))
        i += 1
    return {"logits": nm.linear(h, P[pre + "cls.weight"], P[pre + "cls.bias"]),
            "decoder": h}


def _lin(P, name, x, nm):
    return nm.linear(x, P[f"{name}.weight"], P[f"{name}.bias"])


def stage3(P, batch, train: bool, frozen: bool, tab_stats, net,
           nm: Numerics = F32) -> torch.Tensor:
    """Stage-3 logits (the reference's All_Modalities_Fusion): the three
    stage-2 fusions' pre-ReLU 64-d taps, concatenated, Linear 64 -> ReLU ->
    Linear. Frozen towers and stage-2 heads run without gradient, each
    tower once (PET and MRI of the PET-MRI fusion, tabular of the
    MRI-tabular fusion); trained, each fusion runs its own towers. ``net``:
    the MRI towers' backbone module."""
    mri = batch["mri"][:, None]
    pet = batch["pet1451"][:, None]
    tab = batch["tabular"]
    ap, at, pt = "model_anat_pet.", "model_anat_tab.", "model_pet_tab."
    with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen):
        if frozen:
            towers = {"pet": pet_cnn(P, ap + "pet_model.", pet, nm),
                      "mri": anat_cnn(P, ap + "mri_model.", mri, train,
                                      net, nm),
                      "tab": tabular_mlp(P, at + "tab_model.", tab,
                                         *tab_stats, nm)}
            own = {ap: towers, at: towers, pt: towers}
        else:
            own = {ap: {"pet": pet_cnn(P, ap + "pet_model.", pet, nm),
                        "mri": anat_cnn(P, ap + "mri_model.", mri, train,
                                        net, nm)},
                   at: {"mri": anat_cnn(P, at + "mri_model.", mri, train, net,
                                        nm),
                        "tab": tabular_mlp(P, at + "tab_model.", tab,
                                           *tab_stats, nm)},
                   pt: {"pet": pet_cnn(P, pt + "pet_model.", pet, nm),
                        "tab": tabular_mlp(P, pt + "tab_model.", tab,
                                           *tab_stats, nm)}}
        mri_r = F.relu(_lin(P, ap + "reduce_dim_mri",
                            own[ap]["mri"]["gap"], nm))
        tap_ap = _lin(P, ap + "stage2out",
                      torch.cat([own[ap]["pet"]["gap"], mri_r], 1), nm)
        tab_r = F.relu(_lin(P, at + "reduce_tab", own[at]["tab"]["decoder"],
                            nm))
        tap_at = _lin(P, at + "stage2out",
                      torch.cat([tab_r, own[at]["mri"]["gap"]], 1), nm)
        tab_p = F.relu(_lin(P, pt + "reduce_tab_1", F.relu(_lin(
            P, pt + "reduce_tab_0", own[pt]["tab"]["decoder"], nm)), nm))
        tap_pt = _lin(P, pt + "stage2out",
                      torch.cat([own[pt]["pet"]["gap"], tab_p], 1), nm)
    fused = _lin(P, "stage3out", torch.cat([tap_ap, tap_at, tap_pt], 1), nm)
    return _lin(P, "cls3", F.relu(fused), nm)


def weighted_cross_entropy(logits, labels, weights) -> torch.Tensor:
    """sum_i w[y_i] nll_i / sum_i w[y_i]."""
    nll = -torch.log_softmax(logits, -1).gather(1, labels[:, None])[:, 0]
    w = torch.as_tensor(weights, dtype=logits.dtype,
                        device=logits.device)[labels]
    return (w * nll).sum() / w.sum()


# --------------------------------------------------------------------------
# Per-scan normalisation of raw scans (reference dataloader.py:252-270)
# --------------------------------------------------------------------------

def zscore(vol: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std * mask, mean and Bessel-corrected std over each
    scan's voxels with x * mask != 0, in float64."""
    b = vol.shape[0]
    v = (vol * mask).reshape(b, -1).double()
    valid = v != 0
    n = valid.sum(1).double()
    mean = torch.where(valid, v, 0).sum(1) / n
    var = torch.where(valid, (v - mean[:, None]) ** 2, 0).sum(1) / (n - 1)
    shape = (b,) + (1,) * (vol.ndim - 1)
    out = (vol.double() - mean.reshape(shape)) / torch.sqrt(var).reshape(
        shape)
    return (out * mask.double()).float()


def quantiles(vol: torch.Tensor, mask: torch.Tensor, qs) -> torch.Tensor:
    """(B, Q) linear-interpolation quantiles of each scan's voxels with x *
    mask != 0 (``torch.quantile``'s rule, the rank q (n - 1) in float32)."""
    b = vol.shape[0]
    v = (vol * mask).reshape(b, -1).float()
    out = torch.empty((b, len(qs)), device=vol.device)
    for i in range(b):
        vals = torch.sort(v[i][v[i] != 0]).values
        n = vals.numel()
        for j, q in enumerate(qs):
            rank = torch.tensor(q, dtype=torch.float32) * torch.tensor(
                float(n - 1), dtype=torch.float32)
            lo = int(math.floor(float(rank)))
            hi = min(lo + 1, n - 1)
            frac = (rank - lo).to(vol.device)
            out[i, j] = vals[lo] + frac * (vals[hi] - vals[lo])
    return out


def minmax(vol: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """clamp((x - Q(1-q)) / (Q(q) - Q(1-q)), 0, 1) * mask."""
    qq = quantiles(vol, mask, (q, 1.0 - q))
    shape = (vol.shape[0],) + (1,) * (vol.ndim - 1)
    hi, lo = qq[:, 0].reshape(shape), qq[:, 1].reshape(shape)
    return torch.clamp((vol - lo) / (hi - lo), 0.0, 1.0) * mask


def preprocess(spec: dict, batch: dict) -> dict:
    """The configuration's normalisation of a raw batch, its volumes taken
    as float32 first."""
    batch = {k: (v.float() if k in ("mri", "mri_mask", "pet1451") else v)
             for k, v in batch.items()}
    out = dict(batch)
    mri = spec["mri"]
    if mri["mode"] == "zscore":
        out["mri"] = zscore(batch["mri"], batch["mri_mask"])
    else:
        out["mri"] = minmax(batch["mri"], batch["mri_mask"],
                            mri.get("quantile", 0.99))
    if spec.get("pet") and "pet1451" in batch:
        out["pet1451"] = (batch["pet1451"] - spec["pet"]["mean"]) / \
            spec["pet"]["std"]
    return out
