"""BN-folded and int8 post-training-quantized serving graphs.

Port of ``multimodal_alzheimer_tpu/inference/quantize.py``:

* **BN folding**: in eval mode a BatchNorm is an affine map, so every
  conv + BN pair collapses into one conv with per-channel folded weights and
  a bias (``fold_backbone``, ``fold_pet_tower``): exact algebra.
  ``fold_anat_cnn`` serves the folded graph in a float dtype (bf16 by
  default) through cuDNN's ``F.conv3d``.
* **Symmetric PTQ**: per-output-channel int8 weights, per-tensor int8
  activations with scales from a one-pass absmax calibration that runs the
  folded float32 graph (``calibrate_backbone``).
* **int8 dataflow**: every convolution is the Hopper kernel K9 on the card
  (``ops.int8_conv``): int8 operands, int32 sums, and a float32 epilogue
  ``* scale + bias`` whose ``scale`` holds the input's scale. In the ResNet
  graph a convolution followed by ReLU and a requant
  (``int8_conv3d_fused``) also adds its block's shortcut (the int8 carrier
  dequantized, or the downsample's float32 output), applies the ReLU and
  writes the next int8 carrier from the same epilogue, the same float32
  operations in the same order; the downsamples, the last block's feature
  map and the PET towers' convolutions (``int8_conv3d``) write float32.
  The int8 carriers between convolutions are channels-last ``(B, D, H, W,
  C)``, as JAX's NDHWC; the graph permutes only where it enters and leaves
  float32 NCDHW. The max pools run on int8 exactly, through a cast to
  float16 and back with ``-inf`` padding (max commutes with the monotone
  requant). Residual adds are float32.

One graph (``_backbone_forward``, ``_pet_tower_forward``) serves both modes:
a context object supplies conv (and ``conv_relu``: conv, shortcut, ReLU and
requant), pool and requant, so calibration and serving name their requant
sites alike; the int8 context passes a carrier that the fused epilogue
already requantized through ``requant`` by its site's name. The requant is ``clamp(round(x * f32(1/s)),
-127, 127)`` with round-half-to-even, ``1/s`` rounded to float32 once, as
JAX's weakly typed multiply does.

What the port does otherwise than JAX:

* ``stem_s2d`` is taken with JAX's meaning and error, and both values
  compute the plain 7^3 stride-2 stem: the space-to-depth relayout is a TPU
  lowering whose int32 sums are the same.
* The PET blocks are computed plainly, conv -> ReLU -> pool(2), where JAX
  uses its parity decomposition for narrow blocks; the absmax of such a
  ("fused") block is taken after the pool, as JAX takes it, and before the
  pool otherwise.

Serve functions follow the ``Predictor`` contract, ``batch -> {'logits',
'probs', 'embeddings'}``, take raw batches of tensors on the model's device
and apply their own ``preprocess``; their heads run in float32.
"""

from __future__ import annotations

import copy
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_alzheimer_tpu_torch.models import layers
from multimodal_alzheimer_tpu_torch.models.resnet3d import BLOCK_CONFIGS
from multimodal_alzheimer_tpu_torch.ops.int8_conv import (
    int8_conv3d,
    int8_conv3d_fused,
    pack_weight,
)

_EPS = 1e-5


def _f32(x: float) -> float:
    """``x`` rounded to float32, as JAX casts a weakly typed scalar."""
    return float(np.float32(x))


# --------------------------------------------------------------------------
# BN folding
# --------------------------------------------------------------------------

def _bn_gain(state: dict, bn: str, eps: float = _EPS) -> torch.Tensor:
    """``scale / sqrt(var + eps)`` in float32, each operation rounded to
    nearest. The square root is taken in float64 and rounded once, which is
    the correctly rounded float32 root: torch's vectorised float32 ``sqrt``
    on the CPU is off by an ulp for some inputs."""
    root = torch.sqrt((state[f"{bn}.running_var"] + eps).double()).float()
    return state[f"{bn}.weight"] / root


def _fold_pair(state: dict, conv: str, bn: str, eps: float = _EPS) -> dict:
    """conv -> BN(eval) == conv(folded kernel) + bias. Exact algebra."""
    g = _bn_gain(state, bn, eps)
    return {"w": state[f"{conv}.weight"] * g.reshape(-1, 1, 1, 1, 1),
            "bias": state[f"{bn}.bias"] - state[f"{bn}.running_mean"] * g}


def _backbone_state(source) -> dict:
    """The backbone's tensors by name (``conv1.weight``, ``bn1.running_var``,
    ``layer1_block0.conv1.weight``, ...) from an ``AnatCNN``, a
    ``MedicalNetResNet3D`` or a ``state_dict`` of either."""
    state = source.state_dict() if isinstance(source, nn.Module) else source
    if any(k.startswith("backbone.") for k in state):
        state = {k[len("backbone."):]: v for k, v in state.items()
                 if k.startswith("backbone.")}
    return {k: v.detach() for k, v in state.items()}


def fold_backbone(source, depth: int = 18) -> dict:
    """Fold every conv + BN pair of a Med3D ResNet into conv + bias.

    Returns ``{'conv1': {w, bias}, 'layer{i}_block{j}': {'conv1': ..,
    'conv2': .., ['conv3': ..], ['downsample': ..]}}`` with float32 kernels
    in torch's ``(F, C, kd, kh, kw)`` layout.
    """
    state = _backbone_state(source)
    kind, layout = BLOCK_CONFIGS[depth]
    folded = {"conv1": _fold_pair(state, "conv1", "bn1")}
    for li in range(1, 5):
        for bi in range(layout[li - 1]):
            name = f"layer{li}_block{bi}"
            blk = {"conv1": _fold_pair(state, f"{name}.conv1", f"{name}.bn1"),
                   "conv2": _fold_pair(state, f"{name}.conv2", f"{name}.bn2")}
            if kind == "bottleneck":
                blk["conv3"] = _fold_pair(state, f"{name}.conv3",
                                          f"{name}.bn3")
            if f"{name}.downsample_conv.weight" in state:
                blk["downsample"] = _fold_pair(
                    state, f"{name}.downsample_conv", f"{name}.downsample_bn")
            folded[name] = blk
    return folded


# --------------------------------------------------------------------------
# Shared graph traversal (float: folded / calibration; int8: serving)
# --------------------------------------------------------------------------

def _layer_specs(dilated: bool):
    if dilated:  # Med3D: layers 3-4 stride 1, dilation 2/4 (resnet3d.py)
        return [(64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4)]
    return [(64, 1, 1), (128, 2, 1), (256, 2, 1), (512, 2, 1)]


def _torch_pad(k: int, dilation: int):
    p = dilation * (k - 1) // 2
    return ((p, p),) * 3


def _same_pad(k: int):
    """flax ``padding='SAME'`` at stride 1: lo (k-1)//2, hi k//2."""
    return (((k - 1) // 2, k // 2),) * 3


def _conv_float(entry, x, stride, dilation, pad=None):
    """NCDHW float conv + bias in the entry's dtype (cuDNN on the card)."""
    w = entry["w"]
    pad = pad or _torch_pad(w.shape[2], dilation)
    if all(lo == hi for lo, hi in pad):
        return F.conv3d(x, w, entry["bias"], stride, [lo for lo, _ in pad],
                        dilation)
    (dl, dh), (hl, hh), (wl, wh) = pad
    return F.conv3d(F.pad(x, (wl, wh, hl, hh, dl, dh)), w, entry["bias"],
                    stride, 0, dilation)


def _conv_int8(entry, q, stride, dilation, pad=None):
    """int8 conv -> int32 -> float32 ``* scale + bias`` (K9), channels-last.
    ``entry['scale']`` already holds the input activation's scale."""
    kernel = entry["kernel"]
    pad = pad or _torch_pad(kernel[0], dilation)
    return int8_conv3d(q, entry["wq"], entry["scale"], entry["bias"], kernel,
                       stride, dilation, pad)


def _pool_channels_last(x, window: int, stride: int, padding: int):
    """Max pool of a (B, D, H, W, C) tensor; int8 through float16 (which
    holds every int8 value) with ``-inf`` padding, exact."""
    if min(x.shape[1:4]) < window - 2 * padding:
        raise ValueError(f"max pool: spatial dims {tuple(x.shape[1:4])} "
                         f"smaller than the {window}^3 window")
    t = x.permute(0, 4, 1, 2, 3)
    if x.dtype == torch.int8:
        t = t.to(torch.float16)
    y = F.max_pool3d(t, window, stride, padding).to(x.dtype)
    return y.permute(0, 2, 3, 4, 1).contiguous()


class _FloatCtx:
    """The folded float graph, NCDHW: no requant."""

    conv = staticmethod(_conv_float)

    def conv_relu(self, entry, x, stride, dilation, site=None,
                  residual=None):
        """``requant(site, relu(conv(x) + shortcut))``; ``residual`` is
        ``(carrier_site, carrier)`` (dequantized at that site) or ``(None,
        tensor)``; no requant without a site."""
        y = self.conv(entry, x, stride, dilation)
        if residual is not None:
            res_site, res = residual
            y = y + (res if res_site is None else self.dequant(res_site, res))
        y = F.relu(y)
        return y if site is None else self.requant(site, y)

    def enter(self, x):
        return x

    def leave(self, y):
        return y

    def requant(self, site, x):
        return x

    def dequant(self, site, x):
        return x

    def pool(self, x):
        return F.max_pool3d(x, 3, 2, 1)

    def pool2(self, x):
        return layers.max_pool3d(x)


class _CalibCtx(_FloatCtx):
    """Folded-float32 pass that records per-site activation absmax (0-d
    tensors, read once per batch)."""

    def __init__(self):
        self.absmax: Dict[str, torch.Tensor] = {}

    def requant(self, site, x):
        self.absmax[site] = x.abs().amax()
        return x


class _Int8Ctx:
    """int8 pass: ``scales[site]`` are static post-calibration floats; the
    carriers are channels-last."""

    conv = staticmethod(_conv_int8)

    def __init__(self, scales: Dict[str, float]):
        self.scales = scales

    def enter(self, x):
        return x.permute(0, 2, 3, 4, 1).contiguous()

    def leave(self, y):
        return y.permute(0, 4, 1, 2, 3)

    def conv_relu(self, entry, x, stride, dilation, site=None,
                  residual=None):
        """``_FloatCtx.conv_relu`` in one K9 launch: the shortcut, ReLU and
        the requant at ``site`` in the epilogue. The carrier still passes
        through ``requant`` by its site's name."""
        kernel = entry["kernel"]
        kw = {"relu": True, "pads": _torch_pad(kernel[0], dilation)}
        if residual is not None:
            res_site, kw["residual"] = residual
            if res_site is not None:
                kw["residual_scale"] = _f32(self.scales[res_site])
        if site is not None:
            kw["out_scale"] = self.scales[site]
        y = int8_conv3d_fused(x, entry["wq"], entry["scale"], entry["bias"],
                              kernel, stride, dilation, **kw)
        return y if site is None else self.requant(site, y)

    def requant(self, site, x):
        """float32 -> the int8 carrier of ``site``; a carrier that
        ``conv_relu`` already requantized at ``site`` passes as it is."""
        if x.dtype == torch.int8:
            return x
        inv = _f32(1.0 / self.scales[site])
        return torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)

    def dequant(self, site, q):
        return q.to(torch.float32) * _f32(self.scales[site])

    def pool(self, q):
        return _pool_channels_last(q, 3, 2, 1)

    def pool2(self, x):
        return _pool_channels_last(x, 2, 2, 0)


def _backbone_forward(tree, x, ctx, *, depth, dilated):
    """(B, C, D, H, W) -> (B, C_out, d, h, w) feature map. ``tree`` holds
    whichever arrays the ctx's conv expects; requant sites are named alike
    in both modes, so the calibration's keys are the serving scales'."""
    kind, layout = BLOCK_CONFIGS[depth]
    x = ctx.requant("stem_in", ctx.enter(x))
    carrier = ctx.pool(ctx.conv_relu(tree["conv1"], x, 2, 1, "pool_in"))
    carrier_site = "pool_in"
    for li, (_, stride, dilation) in enumerate(_layer_specs(dilated),
                                               start=1):
        for bi in range(layout[li - 1]):
            name = f"layer{li}_block{bi}"
            blk = tree[name]
            st = stride if bi == 0 else 1
            if kind == "basic":
                h = ctx.conv_relu(blk["conv1"], carrier, st, dilation,
                                  f"{name}/mid")
                last, last_dilation = blk["conv2"], dilation
            else:  # bottleneck: 1^3 -> 3^3 (stride, dilation) -> 1^3 (x4)
                h = ctx.conv_relu(blk["conv1"], carrier, 1, 1,
                                  f"{name}/mid1")
                h = ctx.conv_relu(blk["conv2"], h, st, dilation,
                                  f"{name}/mid2")
                last, last_dilation = blk["conv3"], 1
            if "downsample" in blk:
                res = (None, ctx.conv(blk["downsample"], carrier, st, 1))
            else:
                res = (carrier_site, carrier)
            if li == 4 and bi == layout[3] - 1:
                # float32 fmap for the float head
                return ctx.leave(ctx.conv_relu(last, h, 1, last_dilation,
                                               residual=res))
            carrier_site = f"{name}/out"
            carrier = ctx.conv_relu(last, h, 1, last_dilation, carrier_site,
                                    residual=res)
    raise AssertionError("unreachable")


# --------------------------------------------------------------------------
# Calibration + quantization
# --------------------------------------------------------------------------

def _absmax_over(batches, forward) -> Dict[str, float]:
    """Max over ``batches`` of each site's absmax; one read of the card per
    batch."""
    agg: Dict[str, float] = {}
    for x in batches:
        ctx = _CalibCtx()
        with torch.no_grad():
            forward(x, ctx)
        sites = list(ctx.absmax)
        values = torch.stack([ctx.absmax[s] for s in sites]).tolist()
        for site, v in zip(sites, values):
            agg[site] = max(agg.get(site, 0.0), float(v))
    return agg


def calibrate_backbone(folded: dict, batches, *, depth=18, dilated=True,
                       stem_s2d=True) -> Dict[str, float]:
    """absmax per requant site over ``batches`` (iterable of (B, C, D, H, W)
    float32 tensors, already preprocessed), running the folded float32
    graph, which equals the float model's eval forward. ``stem_s2d`` is
    accepted for JAX's signature: the port computes the plain stem."""
    del stem_s2d
    return _absmax_over(batches, lambda x, ctx: _backbone_forward(
        folded, x, ctx, depth=depth, dilated=dilated))


def _quantize_kernel(entry, in_scale: float) -> dict:
    """Per-out-channel symmetric int8 weights, packed for K9; the (static)
    input scale is folded into the epilogue multiplier."""
    w = entry["w"]
    sw = w.abs().amax(dim=(1, 2, 3, 4))
    sw = torch.clamp(sw, min=1e-12) / 127.0
    wq = torch.clamp(torch.round(w / sw.reshape(-1, 1, 1, 1, 1)), -127,
                     127).to(torch.int8)
    return {"wq": pack_weight(wq), "kernel": tuple(w.shape[2:]),
            "scale": (sw * _f32(in_scale)).to(torch.float32),
            "bias": entry["bias"].to(torch.float32)}


def quantize_backbone(folded: dict, absmax: Dict[str, float], *, depth=18,
                      dilated=True, stem_s2d=True) -> dict:
    """Folded float32 tree + calibration absmax -> int8 serving tree."""
    kind, layout = BLOCK_CONFIGS[depth]
    scales = {k: max(v, 1e-12) / 127.0 for k, v in absmax.items()}
    qtree = {"conv1": _quantize_kernel(folded["conv1"], scales["stem_in"])}
    carrier_site = "pool_in"
    for li in range(1, 5):
        for bi in range(layout[li - 1]):
            name = f"layer{li}_block{bi}"
            blk = folded[name]
            q = {"conv1": _quantize_kernel(blk["conv1"],
                                           scales[carrier_site])}
            if kind == "basic":
                q["conv2"] = _quantize_kernel(blk["conv2"],
                                              scales[f"{name}/mid"])
            else:
                q["conv2"] = _quantize_kernel(blk["conv2"],
                                              scales[f"{name}/mid1"])
                q["conv3"] = _quantize_kernel(blk["conv3"],
                                              scales[f"{name}/mid2"])
            if "downsample" in blk:
                q["downsample"] = _quantize_kernel(blk["downsample"],
                                                   scales[carrier_site])
            qtree[name] = q
            if not (li == 4 and bi == layout[3] - 1):
                carrier_site = f"{name}/out"
    qtree["scales"] = scales
    qtree["config"] = {"depth": depth, "dilated": dilated,
                       "stem_s2d": stem_s2d}
    return qtree


def int8_backbone_apply(qtree: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) float32 -> (B, C_out, d, h, w) float32 feature map
    through the int8 graph."""
    cfg = qtree["config"]
    return _backbone_forward(qtree, x, _Int8Ctx(qtree["scales"]),
                             depth=cfg["depth"], dilated=cfg["dilated"])


def folded_backbone_apply(folded: dict, x: torch.Tensor, *, depth=18,
                          dilated=True, stem_s2d=True) -> torch.Tensor:
    """The folded float forward in the dtype of ``folded`` and ``x``; in
    float32 it equals the float model's eval forward."""
    del stem_s2d  # the plain stem either way
    return _backbone_forward(folded, x, _FloatCtx(), depth=depth,
                             dilated=dilated)


# --------------------------------------------------------------------------
# Whole-model serving fn (AnatCNN: int8 or folded backbone + float32 head)
# --------------------------------------------------------------------------

def _float32_head(model) -> nn.Module:
    """An eval-mode float32 copy of ``model.head`` (JAX rebuilds its head
    without a dtype): the compute dtype of every layer set to float32."""
    head = copy.deepcopy(model.head).eval().requires_grad_(False)
    for m in head.modules():
        if isinstance(m, (layers.Conv3d, layers.Linear)):
            m.compute_dtype = torch.float32
        elif isinstance(m, layers._BatchNorm):
            m.dtype = torch.float32
    return head


def _make_vol(model, preprocess, dtype):
    """batch dict -> preprocessed (B, C, D, H, W) volume in ``dtype``."""

    def _vol(batch):
        if preprocess is not None:
            batch = preprocess(batch)
        x = batch[model.input_key]
        if x.ndim == 4:
            x = x.unsqueeze(1)
        return x.to(dtype)

    return _vol


def _contract(logits, embeddings) -> dict:
    logits = logits.to(torch.float32)
    return {"logits": logits, "probs": torch.softmax(logits, dim=-1),
            "embeddings": embeddings}


def _stem_channels(model) -> int:
    return int(model.backbone.conv1.weight.shape[1])


def quantize_anat_cnn(model, calib_batches, preprocess=None, stem_s2d=None):
    """(AnatCNN or PETResNetCNN) -> (serve_fn, qtree).

    ``serve_fn(batch)`` returns ``{'logits', 'probs', 'embeddings'}``; the
    head (and its ``backbone_gap`` tap) runs in float32 on the dequantized
    feature map. ``calib_batches`` iterates raw batch dicts on the model's
    device; ``preprocess`` is the normalisation the float Predictor uses.
    ``stem_s2d``: None derives JAX's choice (a single input channel), True
    on a multi-channel stem raises as JAX does; the stem is computed plainly
    either way.
    """
    depth, dilated = model.backbone.depth, model.backbone.dilated
    _vol = _make_vol(model, preprocess, torch.float32)
    if stem_s2d is None:
        stem_s2d = _stem_channels(model) == 1
    elif stem_s2d and _stem_channels(model) != 1:
        raise ValueError("s2d stem requires a single input channel")
    with torch.no_grad():
        folded = fold_backbone(model, depth)
        vols = [_vol(b) for b in calib_batches]
        absmax = calibrate_backbone(folded, vols, depth=depth,
                                    dilated=dilated)
        qtree = quantize_backbone(folded, absmax, depth=depth,
                                  dilated=dilated, stem_s2d=stem_s2d)
    head = _float32_head(model)

    def serve_fn(batch):
        with torch.no_grad():
            out = head(int8_backbone_apply(qtree, _vol(batch)))
            return _contract(out["logits"], out["embeddings"])

    return serve_fn, qtree


def fold_anat_cnn(model, preprocess=None, dtype=torch.bfloat16):
    """BN-folded float serving for an AnatCNN: no quantization.

    The backbone runs the folded conv + bias graph in ``dtype`` (cuDNN's
    ``F.conv3d`` on the card), the head in float32; same output contract as
    ``quantize_anat_cnn``. Returns (serve_fn, folded tree in ``dtype``).
    """
    depth, dilated = model.backbone.depth, model.backbone.dilated
    with torch.no_grad():
        folded = _tree_map(lambda t: t.to(dtype), fold_backbone(model, depth))
    _vol = _make_vol(model, preprocess, dtype)
    head = _float32_head(model)

    def serve_fn(batch):
        with torch.no_grad():
            fmap = folded_backbone_apply(folded, _vol(batch), depth=depth,
                                         dilated=dilated)
            out = head(fmap)
            return _contract(out["logits"], out["embeddings"])

    return serve_fn, folded


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# --------------------------------------------------------------------------
# PET conv tower (SmallPETCNN) quantization
# --------------------------------------------------------------------------
#
# n x (conv 'same' -> [BN] -> ReLU -> MaxPool(2)) -> GAP -> float32 head.
# BN blocks fold exactly (conv bias included). The head (GAP + two Linear)
# stays float32, keeping the 'gap'/'dense' taps the stage-2 fusions use.

def _pet_block_specs(model):
    """Per-block plan; ``fused`` is JAX's parity-decomposition choice (odd
    kernel, C_in <= 8), which here decides only where the block's absmax
    is taken: after its pool if fused, before it otherwise."""
    specs = []
    for i in range(model.convs.n_blocks):
        name = f"block_{i}"
        f, cin, k = getattr(model.convs, name).conv.weight.shape[:3]
        specs.append({"name": name, "features": int(f), "k": int(k),
                      "cin": int(cin), "fused": k % 2 == 1 and cin <= 8})
    return specs


def _fold_conv_bn(state: dict, prefix: str, eps: float = _EPS) -> dict:
    """conv(+bias) -> BN(eval) == conv(folded kernel) + folded bias."""
    bn = f"{prefix}.bn"
    g = _bn_gain(state, bn, eps)
    bias = state[f"{bn}.bias"] + g * (state[f"{prefix}.conv.bias"]
                                      - state[f"{bn}.running_mean"])
    return {"w": state[f"{prefix}.conv.weight"] * g.reshape(-1, 1, 1, 1, 1),
            "bias": bias}


def fold_pet_tower(model, specs=None) -> dict:
    """Every PET conv block -> ``{'w', 'bias'}`` float32 (BN folded where
    present: exact algebra)."""
    specs = specs or _pet_block_specs(model)
    state = {k: v.detach() for k, v in model.convs.state_dict().items()}
    folded = {}
    for sp in specs:
        name = sp["name"]
        if f"{name}.bn.weight" in state:
            folded[name] = _fold_conv_bn(state, name)
        else:
            folded[name] = {"w": state[f"{name}.conv.weight"],
                            "bias": state[f"{name}.conv.bias"]}
    return folded


def _pet_tower_forward(tree, x, ctx, specs):
    """(B, C, D, H, W) -> (B, F_last, d, h, w) float32 feature map; one graph
    for calibration and serving, requant sites named alike."""
    carrier = ctx.requant("in", ctx.enter(x))
    last = len(specs) - 1
    for i, sp in enumerate(specs):
        y = F.relu(ctx.conv(tree[sp["name"]], carrier, 1, 1,
                            pad=_same_pad(sp["k"])))
        if i == last:
            return ctx.leave(ctx.pool2(y))
        site = f"{sp['name']}/out"
        if sp["fused"]:
            carrier = ctx.requant(site, ctx.pool2(y))
        else:  # the pool commutes with the requant: exact either way
            carrier = ctx.pool2(ctx.requant(site, y))
    raise AssertionError("unreachable")


def quantize_pet_cnn(model, calib_batches, preprocess=None):
    """(SmallPETCNN) -> (serve_fn, qtree). ``serve_fn(batch)`` returns
    ``{'logits', 'probs', 'embeddings'}`` with the 'gap' (and 'dense') taps
    the stage-2 fusions cut on; conv blocks int8, the head float32."""
    specs = _pet_block_specs(model)
    _vol = _make_vol(model, preprocess, torch.float32)
    with torch.no_grad():
        folded = fold_pet_tower(model, specs)
        absmax = _absmax_over((_vol(b) for b in calib_batches),
                              lambda x, ctx: _pet_tower_forward(
                                  folded, x, ctx, specs))
        scales = {k: max(v, 1e-12) / 127.0 for k, v in absmax.items()}
        qtree: dict = {"scales": scales, "specs": specs}
        site = "in"
        for sp in specs:
            qtree[sp["name"]] = _quantize_kernel(folded[sp["name"]],
                                                 scales[site])
            site = f"{sp['name']}/out"
    hidden = (None if model.hidden is None else
              (model.hidden.weight.detach().float(),
               model.hidden.bias.detach().float()))
    cls = (model.cls.weight.detach().float(), model.cls.bias.detach().float())

    def serve_fn(batch):
        with torch.no_grad():
            fmap = _pet_tower_forward(qtree, _vol(batch), _Int8Ctx(scales),
                                      specs)
            h = layers.global_avg_pool(fmap)  # dropout is an eval no-op
            embeddings = {"gap": h}
            if hidden is not None:
                h = F.relu(F.linear(h, *hidden))
                embeddings["dense"] = h
            return _contract(F.linear(h, *cls), embeddings)

    return serve_fn, qtree


# --------------------------------------------------------------------------
# Fusions: int8 or folded towers through the ``towers=`` hook
# --------------------------------------------------------------------------

def _fusion_serve_with_towers(fusion, serves: dict, preprocess):
    """Serve a fusion with externally computed stage-1 towers (int8 or
    BN-folded) fed through its ``towers`` hook (keys 'mri'/'pet'); the other
    towers and the fusion heads stay in the model's dtype. Each call runs
    the fusion in eval mode and gives it back in the mode it found."""

    def serve_fn(batch):
        was_training = fusion.training
        fusion.eval()
        try:
            with torch.no_grad():
                pre = (dict(preprocess(batch)) if preprocess is not None
                       else batch)
                towers = {}
                for key, fn in serves.items():
                    out = fn(pre)
                    towers[key] = {"logits": out["logits"],
                                   "embeddings": out["embeddings"]}
                out = fusion(pre, towers=towers)
        finally:
            fusion.train(was_training)
        return _contract(out["logits"], out["embeddings"])

    return serve_fn


def _calibration_inputs(calib_batches, preprocess) -> list:
    return ([dict(preprocess(b)) for b in calib_batches]
            if preprocess is not None else list(calib_batches))


def _require_shared(fusion) -> None:
    if not fusion.share_towers:
        raise ValueError("external towers require share_towers=True")


def fold_mri_fusion(fusion, preprocess=None, dtype=torch.bfloat16):
    """BN-folded MRI tower for a stage-2 fusion (the float analogue of
    ``quantize_mri_fusion``: exact algebra, no calibration)."""
    serve_mri, ftree = fold_anat_cnn(fusion.mri_model, dtype=dtype)
    return (_fusion_serve_with_towers(fusion, {"mri": serve_mri},
                                      preprocess), ftree)


def fold_all_modalities_fusion(fusion, preprocess=None, dtype=torch.bfloat16):
    """BN-folded MRI tower for the stage-3 serve (the float analogue of
    ``quantize_all_modalities_fusion``; shared towers required)."""
    _require_shared(fusion)
    serve_mri, ftree = fold_anat_cnn(fusion.model_anat_pet.mri_model,
                                     dtype=dtype)
    return (_fusion_serve_with_towers(fusion, {"mri": serve_mri},
                                      preprocess), ftree)


def quantize_mri_fusion(fusion, calib_batches, preprocess=None,
                        quantize_pet: bool = False):
    """int8 MRI tower for a stage-2 fusion (AnatPETFusion,
    TabularMRIFusion: any fusion with an ``mri_model`` and a ``towers=``
    hook). ``quantize_pet`` also replaces a SmallPETCNN partner tower with
    its int8 serve."""
    pre_batches = _calibration_inputs(calib_batches, preprocess)
    serve_mri, qtree = quantize_anat_cnn(fusion.mri_model, pre_batches)
    serves = {"mri": serve_mri}
    if quantize_pet:
        if not hasattr(fusion, "pet_model"):
            raise ValueError("quantize_pet: fusion has no pet_model tower")
        serves["pet"], pet_q = quantize_pet_cnn(fusion.pet_model,
                                                pre_batches)
        qtree = {"mri": qtree, "pet": pet_q}
    return _fusion_serve_with_towers(fusion, serves, preprocess), qtree


def quantize_all_modalities_fusion(fusion, calib_batches, preprocess=None,
                                   quantize_pet: bool = False):
    """int8 serving for stage 3: the canonical MRI tower
    (``model_anat_pet.mri_model``, the one the shared forward reads) is
    replaced by the int8 backbone + float32 head and fed to every consumer
    through the shared-tower path; ``quantize_pet`` does the same for the
    shared PET tower. Requires ``share_towers``."""
    _require_shared(fusion)
    pre_batches = _calibration_inputs(calib_batches, preprocess)
    anat_pet = fusion.model_anat_pet
    serve_mri, qtree = quantize_anat_cnn(anat_pet.mri_model, pre_batches)
    serves = {"mri": serve_mri}
    if quantize_pet:
        serves["pet"], pet_q = quantize_pet_cnn(anat_pet.pet_model,
                                                pre_batches)
        qtree = {"mri": qtree, "pet": pet_q}
    return _fusion_serve_with_towers(fusion, serves, preprocess), qtree


def quantization_error(model, serve_fn, batch, preprocess=None) -> dict:
    """Float-vs-optimized drift on one batch. ``serve_fn`` applies
    ``preprocess`` itself, so it gets the raw batch; the float model (run in
    eval mode) the preprocessed one."""
    pre = dict(preprocess(batch)) if preprocess is not None else batch
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            ref = model(pre)
    finally:
        model.train(was_training)
    got = serve_fn(batch)
    rl = ref["logits"].float().cpu().numpy()
    gl = got["logits"].float().cpu().numpy()
    rp = torch.softmax(ref["logits"].float(), -1).cpu().numpy()
    gp = got["probs"].float().cpu().numpy()
    denom = max(float(np.abs(rl).max()), 1e-12)
    return {"argmax_agree": float((rl.argmax(-1) == gl.argmax(-1)).mean()),
            "logit_max_rel_err": float(np.abs(rl - gl).max() / denom),
            "prob_max_abs_err": float(np.abs(rp - gp).max())}
