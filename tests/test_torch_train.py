"""One train step of the port against ``train/state.make_train_step`` (CPU).

ResNet-10 ``AnatCNN`` at (12, 14, 12) from converted JAX weights, batch 4 of
raw ``make_labeled_volumes`` scans: the min-max preprocess runs inside the
step on both sides, then forward, weighted cross-entropy, backward and
Adam with head/backbone groups and torch-style L2. For ``fused_bn`` in
{False, "full", "hybrid"}, backbone frozen and unfrozen, the step's loss,
logits, gradients, BatchNorm statistics and updated parameters must match.
The JAX BatchNorm kernels run in interpret mode. The module imports JAX
only inside those tests, so that its card cases (marker ``cuda``) run where
JAX is not installed.

Gradients are read from Adam's first moment after the step, which both
packages hold as ``0.1 * (g + l2 * p)``. Adam's first update is about
``lr * sign(g)``, so updated parameters are compared only where that
gradient is above ``GRAD_FLOOR``; the gradients are compared everywhere.

Tolerances: logits rtol 1e-3, atol 1e-4 (tests/test_torch_anat_cnn.py);
loss rtol 1e-4; gradients rtol 2e-3 with atol 1e-3 of the leaf's largest
gradient (the two frameworks sum the convolutions in another order, and the
gradient passes back through up to ten of them); BatchNorm statistics rtol
2e-4, atol 2e-5 (tests/test_torch_bn.py); updated parameters atol 1e-7.
"""

import copy

import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.data.synthetic import make_labeled_volumes
from multimodal_alzheimer_tpu_torch.losses.classification import (
    make_criterion,
)
from multimodal_alzheimer_tpu_torch.models.convert import flax_from_state_dict
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.ops import hopper_bn, hopper_norm
from multimodal_alzheimer_tpu_torch.train.optim import (
    build_optimizer,
    head_pretrained_label_fn,
)
from multimodal_alzheimer_tpu_torch.train.state import (
    TrainState,
    make_train_step,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

SHAPE = (12, 14, 12)
MINMAX = {"per_scan_norm": "min_max"}
LOGIT_TOL = dict(rtol=1e-3, atol=1e-4)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-3
STATS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_ATOL = 1e-7
GRAD_FLOOR = 1e-4


@pytest.fixture
def interpret_mode(monkeypatch):
    from multimodal_alzheimer_tpu.ops import pallas_bn

    monkeypatch.setattr(pallas_bn, "INTERPRET", True)


def _hparams(frozen):
    return {"n_classes": 2, "resnet_depth": 10, "lr": 1e-3,
            "lr_pretrained": None if frozen else 1e-4, "l2_reg": 1e-2,
            "loss_class_weights": [0.4, 0.6]}


def _batch(seed=0):
    data = make_labeled_volumes(4, SHAPE, n_classes=2, seed=seed)
    data["label"] = np.array([0, 1, 1, 0], np.int32)  # both classes
    return data


def _port_optimizer(hp, model):
    return build_optimizer(
        {"head": hp["lr"], "pretrained": hp["lr_pretrained"]},
        head_pretrained_label_fn(("head",), hp["lr_pretrained"]), model,
        hp["l2_reg"])


def _flat(tree):
    import jax

    return {tuple(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _adam_mu(opt_state):
    """{param path: first moment} of every trained parameter."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(opt_state):
        names = [getattr(k, "name", None) for k in path]
        if "mu" in names:
            out[tuple(k.key for k in path[names.index("mu") + 1:])] = \
                np.asarray(leaf)
    return out


def _port_tree(model, values: dict) -> dict:
    """Parameter tensors by name -> flat flax params tree."""
    sd = dict(model.state_dict())
    sd.update(values)
    return _flat(flax_from_state_dict(sd)["params"])


def _run_both(fused_bn, frozen, seed=0):
    import jax

    from multimodal_alzheimer_tpu.data.dataset import MultiModalDataset
    from multimodal_alzheimer_tpu.losses import (
        make_criterion as jax_criterion,
    )
    from multimodal_alzheimer_tpu.models.mri_models.train_anat_cnn import (
        backbone_head_optimizer,
    )
    from multimodal_alzheimer_tpu.train.state import (
        TrainState as JaxTrainState,
        make_train_step as jax_train_step,
    )
    from torch_port_helpers import model_pair

    hp = _hparams(frozen)
    jax_model, variables, port = model_pair(hp, SHAPE, seed=seed,
                                            fused_bn=fused_bn)
    batch = _batch(seed)

    holder = type("Holder", (), {"normalize_pet": None,
                                 "normalize_mri": MINMAX,
                                 "quantile": 0.99})()
    optimizer = backbone_head_optimizer(hp, None)
    step = jax_train_step(jax_model, jax_criterion(hp), optimizer,
                          MultiModalDataset.get_device_preprocess(holder))
    state, aux = step(JaxTrainState.create(variables, optimizer),
                      {k: jax.numpy.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0))
    want = {"loss": float(aux["loss"]), "logits": np.asarray(aux["logits"]),
            "params": _flat(state.params),
            "batch_stats": _flat(state.batch_stats),
            "mu": _adam_mu(state.opt_state)}

    port_opt = _port_optimizer(hp, port)
    port_step = make_train_step(
        port, make_criterion(hp), port_opt,
        make_device_preprocess(normalize_mri=MINMAX, quantile=0.99))
    before = dict(hopper_bn.LAUNCHES), dict(hopper_norm.LAUNCHES)
    pstate, paux = port_step(TrainState(port, port_opt),
                             {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    assert (dict(hopper_bn.LAUNCHES), dict(hopper_norm.LAUNCHES)) == before
    assert pstate.step == 1
    mu = {name: port_opt.state[p]["exp_avg"]
          for name, p in port.named_parameters() if p in port_opt.state}
    got = {"loss": float(paux["loss"]), "logits": paux["logits"].numpy(),
           "params": _port_tree(port, {}),
           "batch_stats": _flat(flax_from_state_dict(
               port.state_dict())["batch_stats"]),
           "mu": {k: v for k, v in _port_tree(port, mu).items()
                  if k in want["mu"]},
           "grads": {name: p.grad for name, p in port.named_parameters()}}
    return variables, want, got


CASES = [(fused, frozen) for fused in (False, "full", "hybrid")
         for frozen in (False, True)]


@pytest.mark.parametrize("fused_bn,frozen", CASES,
                         ids=[f"{f}-{'frozen' if z else 'unfrozen'}"
                              for f, z in CASES])
def test_train_step_matches_jax(interpret_mode, fused_bn, frozen):
    variables, want, got = _run_both(fused_bn, frozen)
    before = _flat(variables["params"])

    np.testing.assert_allclose(got["loss"], want["loss"], **LOSS_TOL)
    np.testing.assert_allclose(got["logits"], want["logits"], **LOGIT_TOL)

    assert set(got["batch_stats"]) == set(want["batch_stats"])
    for key, value in want["batch_stats"].items():
        np.testing.assert_allclose(got["batch_stats"][key], value,
                                   err_msg=str(key), **STATS_TOL)

    # trained parameters: the head always, the backbone when unfrozen
    assert set(got["mu"]) == set(want["mu"])
    assert all(k[0] == "head" for k in want["mu"]) == frozen
    for key, mu in want["mu"].items():
        atol = GRAD_ATOL * float(np.abs(mu).max())
        np.testing.assert_allclose(got["mu"][key], mu, rtol=GRAD_RTOL,
                                   atol=atol, err_msg=str(key))
        moved = np.abs(mu / 0.1) > GRAD_FLOOR
        np.testing.assert_allclose(got["params"][key][moved],
                                   want["params"][key][moved],
                                   rtol=0, atol=PARAM_ATOL, err_msg=str(key))

    # a frozen backbone has no gradient and does not move
    for key, value in want["params"].items():
        if key not in want["mu"]:
            np.testing.assert_array_equal(value, before[key])
            np.testing.assert_array_equal(got["params"][key], before[key])
    backbone_grads = [g for name, g in got["grads"].items()
                      if name.startswith("backbone.")]
    assert all(g is None for g in backbone_grads) == frozen


def _cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fused_bn", [False, "full", "hybrid"])
def test_train_step_on_the_card_matches_the_cpu(fused_bn):
    """The same step on the card (the kernels) and on the CPU (their plain
    versions); cuDNN runs with TF32 off."""
    device = _cuda_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    hp = _hparams(frozen=False)
    port = AnatCNN.from_hparams(hp, fused_bn=fused_bn,
                                generator=make_generator(1))
    with torch.no_grad():
        port.head.cls.bias.fill_(1.0)  # the trailing ReLU passes gradient
    batch = _batch(1)
    results = []
    for dev in ("cpu", device):
        model = copy.deepcopy(port).to(dev)
        opt = _port_optimizer(hp, model)
        step = make_train_step(
            model, make_criterion(hp), opt,
            make_device_preprocess(normalize_mri=MINMAX, quantile=0.99))
        hopper_bn.reset_launches()
        hopper_norm.reset_launches()
        _, aux = step(TrainState(model, opt),
                      {k: torch.from_numpy(v).to(dev)
                       for k, v in batch.items()})
        torch.cuda.synchronize()
        results.append((float(aux["loss"]),
                        {n: p.grad.norm().item()
                         for n, p in model.named_parameters()},
                        dict(hopper_bn.LAUNCHES)))
    (loss_cpu, norms_cpu, _), (loss_gpu, norms_gpu, launches) = results
    np.testing.assert_allclose(loss_gpu, loss_cpu, rtol=1e-4)
    for name, norm in norms_cpu.items():
        np.testing.assert_allclose(norms_gpu[name], norm, rtol=1e-3,
                                   atol=1e-6, err_msg=name)
    n_bn = 1 + 4 * 2 + 3  # ResNet-10: stem, two per block, 3 downsamples
    expected = {"full": dict.fromkeys(hopper_bn.LAUNCHES, n_bn),
                "hybrid": {"bn_stats": n_bn, "bn_apply": 0,
                           "bn_grad_sum": 0, "bn_dx": 0},
                False: dict.fromkeys(hopper_bn.LAUNCHES, 0)}[fused_bn]
    assert launches == expected

