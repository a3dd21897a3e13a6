"""Plain reference of the int8 serving rule of a Med3D ResNet of basic
blocks, walked by its backbone file's ``LAYERS`` (planes, blocks, stride,
dilation); a backbone of other blocks is refused (``check``).

The rule, as the configuration states it: every conv + BatchNorm pair of the
backbone folded into one conv with a bias (scale / sqrt(var + eps), the
root taken in float64); per-output-channel symmetric weights ``round(w /
s_w)`` with ``s_w = max|w| / 127``; per-tensor activations at each requant
site, ``clamp(round(x * f32(1 / s)), -127, 127)`` (half to even) with ``s =
max|x| / 127`` over two calibration batches run through the folded float32
graph; each convolution's integer sum times ``s_w * f32(s_in)`` plus the
bias, in float32; ReLU after the stem and each block's first conv, and
after each block's sum with its shortcut (the dequantized carrier ``q *
f32(s)``, or the downsample's float32 output); the stem's max pool on the
integers; the last block's float32 map into the float32 head (GAP, Linear,
ReLU) and a softmax.

The integer sums are taken exactly, as float64 convolutions of the integer
values. ``bits=4`` computes the same rule with 4-bit integers, the control
a step below the configuration's int8.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-5


def _f32(x: float) -> float:
    return float(np.float32(x))


def check(net) -> None:
    """ValueError unless the backbone module ``net`` is built of basic
    blocks, the only blocks this rule folds and requantizes."""
    if getattr(net, "BLOCK", None) != "basic":
        raise ValueError(f"the int8 rule takes basic blocks only; the "
                         f"backbone {Path(net.__file__).stem!r} has "
                         f"{getattr(net, 'BLOCK', None)!r} blocks")


def fold(P, layers, pre: str = "backbone.") -> dict:
    """conv -> BN(eval) as conv(folded kernel) + bias, by conv name, over
    the backbone's ``layers``."""
    def pair(conv, bn):
        root = torch.sqrt((P[f"{pre}{bn}.running_var"] + EPS).double()).float()
        g = P[f"{pre}{bn}.weight"] / root
        return {"w": P[f"{pre}{conv}.weight"] * g.reshape(-1, 1, 1, 1, 1),
                "bias": P[f"{pre}{bn}.bias"] - P[f"{pre}{bn}.running_mean"] * g}

    out = {"stem": pair("conv1", "bn1")}
    for blk, _, _ in _blocks(layers):
        out[blk + ".conv1"] = pair(blk + ".conv1", blk + ".bn1")
        out[blk + ".conv2"] = pair(blk + ".conv2", blk + ".bn2")
        if f"{pre}{blk}.downsample_conv.weight" in P:
            out[blk + ".down"] = pair(blk + ".downsample_conv",
                                      blk + ".downsample_bn")
    return out


def _blocks(layers) -> list:
    """(block name, stride, dilation) of each basic block, in order."""
    return [(f"layer{li}_block{bi}", stride if bi == 0 else 1, dil)
            for li, (_, blocks, stride, dil) in enumerate(layers, start=1)
            for bi in range(blocks)]


def _graph(folded, layers, x, conv, relu_site, pool):
    """The backbone's dataflow, shared by calibration and the integer pass.
    ``conv(name, x, stride, dilation)``; ``relu_site(v, site, residual)``
    adds the residual (a (site, carrier) pair), applies ReLU and requantizes
    at ``site`` (None: stays float32)."""
    carrier = pool(relu_site(conv("stem", x, 2, 1), "pool_in", None))
    carrier_site = "pool_in"
    last = _blocks(layers)[-1][0]
    for blk, st, dil in _blocks(layers):
        h = relu_site(conv(blk + ".conv1", carrier, st, dil), f"{blk}/mid",
                      None)
        if blk + ".down" in folded:
            res = (None, conv(blk + ".down", carrier, st, 1))
        else:
            res = (carrier_site, carrier)
        site = None if blk == last else f"{blk}/out"
        carrier = relu_site(conv(blk + ".conv2", h, 1, dil), site, res)
        carrier_site = site
    return carrier


def calibrate(folded, layers, volumes) -> dict:
    """max |x| per requant site over the preprocessed (B, 1, D, H, W)
    float32 ``volumes``, through the folded float32 graph."""
    absmax: dict = {}

    def note(site, v):
        absmax[site] = max(absmax.get(site, 0.0), float(v.abs().amax()))

    def conv(name, x, st, dil):
        e = folded[name]
        k = e["w"].shape[-1]
        return F.conv3d(x, e["w"], e["bias"], st, dil * (k - 1) // 2, dil)

    def relu_site(v, site, res):
        if res is not None:
            v = v + res[1]
        v = F.relu(v)
        if site is not None:
            note(site, v)
        return v

    with torch.no_grad():
        for x in volumes:
            note("stem_in", x)
            _graph(folded, layers, x, conv, relu_site,
                   lambda t: F.max_pool3d(t, 3, 2, 1))
    return absmax


def _requant(x, s: float, qmax: int):
    return torch.clamp(torch.round(x * _f32(1.0 / s)), -qmax, qmax)


def quantize(folded, layers, absmax, bits: int = 8) -> dict:
    """Integer weights, per-channel multipliers and site scales, and the
    backbone's ``layers``."""
    qmax = 2 ** (bits - 1) - 1
    scales = {k: max(v, 1e-12) / qmax for k, v in absmax.items()}
    inputs = {"stem": "stem_in"}
    carrier = "pool_in"
    for blk, _, _ in _blocks(layers):
        inputs[blk + ".conv1"] = carrier
        inputs[blk + ".conv2"] = f"{blk}/mid"
        inputs[blk + ".down"] = carrier
        carrier = f"{blk}/out"
    q = {}
    for name, e in folded.items():
        w = e["w"]
        sw = torch.clamp(w.abs().amax(dim=(1, 2, 3, 4)), min=1e-12) / qmax
        wq = torch.clamp(torch.round(w / sw.reshape(-1, 1, 1, 1, 1)), -qmax,
                         qmax)
        q[name] = {"wq": wq, "mul": (sw * _f32(scales[inputs[name]])).float(),
                   "bias": e["bias"].float()}
    return {"tree": q, "scales": scales, "qmax": qmax, "layers": layers}


def backbone(qmodel, x) -> torch.Tensor:
    """The integer pass: preprocessed (B, 1, D, H, W) float32 -> float32
    feature map."""
    q, scales, qmax = qmodel["tree"], qmodel["scales"], qmodel["qmax"]

    def conv(name, v, st, dil):
        e = q[name]
        k = e["wq"].shape[-1]
        acc = F.conv3d(v.double(), e["wq"].double(), None, st,
                       dil * (k - 1) // 2, dil)
        c = (1, -1, 1, 1, 1)
        return acc.float() * e["mul"].reshape(c) + e["bias"].reshape(c)

    def relu_site(v, site, res):
        if res is not None:
            res_site, r = res
            v = v + (r if res_site is None
                     else r * _f32(scales[res_site]))
        v = F.relu(v)
        return v if site is None else _requant(v, scales[site], qmax)

    with torch.no_grad():
        x = _requant(x, scales["stem_in"], qmax)
        return _graph(q, qmodel["layers"], x, conv, relu_site,
                      lambda t: F.max_pool3d(t, 3, 2, 1))


def head(P, fmap, pre: str = "head.") -> dict:
    """float32 GAP -> Linear -> ReLU; logits and probabilities."""
    logits = F.relu(F.linear(fmap.mean((2, 3, 4)), P[pre + "cls.weight"],
                             P[pre + "cls.bias"]))
    return {"logits": logits, "probs": torch.softmax(logits, -1)}
