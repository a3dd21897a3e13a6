"""The reference's first three train steps, and what a run compares of them.

Given the weights and the three raw batches the program's first steps took,
the reference preprocesses, runs the model in train mode, takes the
weighted cross-entropy, back-propagates and applies torch-style Adam
(``weight_decay`` added to the gradient before the moments; betas 0.9 and
0.999, eps 1e-8; a parameter the loss does not reach takes a zero gradient,
so the decay still moves it). It returns each step's loss, each trained
leaf's first gradient as the optimizer takes it, and each leaf's change
after the three steps, and each leaf's first gradient itself (on the host).

``numerics`` computes the convolutions and dense layers otherwise (the
float8 control), and ``loss_rows`` takes the loss's mean over the first
rows of each batch only, the logits still of the whole batch (a program
that leaves out half of its batch).
"""

from __future__ import annotations

import torch

from benchmark.reference import nets

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def loss_fn(config: dict, net, regime: dict, tab_stats):
    """``loss(P, batch, numerics) -> (loss, logits)`` of the configuration,
    its MRI backbone the module ``net``, on a preprocessed batch, in train
    mode."""
    weights = config["loss_class_weights"]
    frozen = regime.get("lr_pretrained") is None

    def loss(P, batch, nm, rows=None):
        if config["model"] == "anat_cnn":
            logits = nets.anat_cnn(P, "", batch["mri"][:, None], True,
                                   net, nm)["logits"]
        else:
            logits = nets.stage3(P, batch, True, frozen, tab_stats, net,
                                 nm)
        return (nets.weighted_cross_entropy(logits[:rows],
                                            batch["label"][:rows], weights),
                logits)

    return loss


def groups(config: dict, regime: dict, names) -> dict:
    """Trained leaf -> learning rate, as the configuration's optimizer
    groups them: every leaf at ``lr``, or the fusion heads at ``lr`` and
    the towers at ``lr_pretrained`` (left out when it is None)."""
    opt = config["optimizer"]
    if config["model"] == "anat_cnn":
        return {n: opt["lr"] for n in names}
    heads = tuple(opt["head"])
    out = {}
    for n in names:
        if n.split(".")[0] in heads:
            out[n] = opt["lr"]
        elif regime.get("lr_pretrained") is not None:
            out[n] = regime["lr_pretrained"]
    return out


def readings(config: dict, net, regime: dict, weights: dict, batches: list,
             tab_stats=None, numerics: str = "float32",
             loss_rows: int | None = None) -> dict:
    """{'loss': [3 floats], 'logits1': the first step's logits, 'grad':
    {leaf: norm}, 'grad1': {leaf: the first gradient, float32 on the
    host}, 'update': {leaf: norm}, 'heads': the trained leaves of the
    configuration's fusion heads, 'labels1' and 'class_weights': what the
    first loss is taken over} of three reference steps from
    ``weights`` (a state dict; the trained leaves are its parameters named
    by ``config_param_names``) on the raw ``batches``, the configuration's
    backbone the module ``net``."""
    nm = nets.Numerics(numerics)
    l2 = config["optimizer"].get("l2_reg", 0.0)
    params = {k: v.detach().clone().float() for k, v in weights.items()}
    lrs = groups(config, regime, config_param_names(weights))
    leaves = {k: params[k].requires_grad_(True) for k in lrs}
    start = {k: v.detach().clone() for k, v in leaves.items()}
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    loss = loss_fn(config, net, regime, tab_stats)
    out = {"loss": [], "grad": {}, "grad1": {}}
    for t, raw in enumerate(batches, start=1):
        batch = nets.preprocess(config["preprocess"]["train"], raw)
        value, logits = loss(params, batch, nm, loss_rows)
        if t == 1:
            out["logits1"] = logits.detach().float().cpu()
            out["labels1"] = batch["label"].cpu()
        grads = torch.autograd.grad(value, list(leaves.values()),
                                    allow_unused=True)
        out["loss"].append(float(value.detach()))
        with torch.no_grad():
            for (k, p), g in zip(leaves.items(), grads):
                g = torch.zeros_like(p) if g is None else g
                g = g + l2 * p
                if t == 1:
                    out["grad"][k] = float(g.norm())
                    out["grad1"][k] = g.detach().float().cpu()
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                bc1 = 1 - BETAS[0] ** t
                bc2 = 1 - BETAS[1] ** t
                denom = (v2[k].sqrt() / bc2 ** 0.5).add_(ADAM_EPS)
                p.addcdiv_(m[k], denom, value=-lrs[k] / bc1)
        del grads, value, logits
    out["update"] = {k: float((p.detach() - start[k]).norm())
                     for k, p in leaves.items()}
    out["class_weights"] = config["loss_class_weights"]
    heads = tuple(config["optimizer"].get("head", ()))
    out["heads"] = [k for k in leaves if k.split(".")[0] in heads]
    return out


def config_param_names(state: dict) -> list:
    """The parameters of a state dict: every floating leaf but the
    BatchNorm running statistics."""
    return [k for k, v in state.items() if v.is_floating_point()
            and not k.endswith(("running_mean", "running_var"))]
