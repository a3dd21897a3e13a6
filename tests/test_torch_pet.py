"""The port's PET models and entry points against the JAX package (CPU).

``SmallPETCNN`` and ``PETResNetCNN`` from converted weights: logits and
both embedding taps in eval mode within rtol 1e-4, atol 1e-5 (the JAX
small CNN runs its default ``s2d_pool=True`` lowering, the port the plain
conv -> BN -> ReLU -> pool, which sum the convolutions in another order);
the ResNet at the model-parity tolerance rtol 1e-3, atol 1e-4
(tests/test_torch_anat_cnn.py). One train-mode step of ``SmallPETCNN`` with
dropout off: loss rtol 1e-4, every gradient rtol 2e-3 with atol 1e-3 of the
leaf's largest (tests/test_torch_train.py), the updated BatchNorm statistics
rtol 2e-4, atol 2e-5 (tests/test_torch_bn.py). The entry points are held
in tests/test_torch_pet_entry.py.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.losses import make_criterion as jax_criterion
from multimodal_alzheimer_tpu.models.pet_models import (
    train_pet_cnn as jax_train_pet_cnn,
    train_pet_resnet_cnn as jax_train_pet_resnet_cnn,
)
from multimodal_alzheimer_tpu.models.pet_models.pet_cnn import (
    SmallPETCNN as JaxSmallPETCNN,
)
from multimodal_alzheimer_tpu.models.pet_models.pet_resnet_cnn import (
    PETResNetCNN as JaxPETResNetCNN,
)
from multimodal_alzheimer_tpu_torch.losses.classification import (
    make_criterion,
)
from multimodal_alzheimer_tpu_torch.models.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from multimodal_alzheimer_tpu_torch.models.layers import (
    Dropout,
    set_dropout_generator,
)
from multimodal_alzheimer_tpu_torch.models.pet_models import (
    train_pet_cnn,
    train_pet_resnet_cnn,
)
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
    RandomBenchmarkAllCN,
    SmallPETCNN,
)
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_resnet_cnn import (
    PETResNetCNN,
)
from multimodal_alzheimer_tpu_torch.train.loop import Trainer
from torch_port_helpers import Trial, random_flax_variables, run_unfused
from torch_threads import torch_threads  # noqa: F401 (autouse)

GRID = (16, 18, 16)  # four 2^3 pools take it
PET_TOL = dict(rtol=1e-4, atol=1e-5)
RESNET_TOL = dict(rtol=1e-3, atol=1e-4)
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-3
STATS_TOL = dict(rtol=2e-4, atol=2e-5)


def _pair(jax_cls, port_cls, hparams, seed, shape=GRID):
    """(jax model, numpy variables, port model in eval mode), same
    weights."""
    jax_model = jax_cls.from_hparams(hparams)
    variables = random_flax_variables(jax_model, shape, seed, "pet1451")
    port = port_cls.from_hparams(hparams)
    port.load_state_dict(state_dict_from_flax(variables, port))
    return jax_model, variables, port.eval()


def _pet(batch, seed, shape=GRID):
    return np.random.default_rng(seed).normal(
        0.5, 0.5, (batch,) + shape).astype(np.float32)


def _small_hparams(batchnorm, linear_out, n_layers, **extra):
    return dict({"n_classes": 3, "conv_out": (4, 8, 8, 16)[:n_layers],
                 "filter_size": (5, 3, 3, 3)[:n_layers],
                 "batchnorm": batchnorm, "linear_out": linear_out}, **extra)


@pytest.mark.parametrize("n_layers", [3, 4])
@pytest.mark.parametrize("linear_out", [0, 64])
@pytest.mark.parametrize("batchnorm", [True, False])
def test_small_pet_cnn_matches_jax(batchnorm, linear_out, n_layers):
    hp = _small_hparams(batchnorm, linear_out, n_layers,
                        dropout_conv_p=0.1, dropout_dense_p=0.3)
    jax_model, variables, port = _pair(JaxSmallPETCNN, SmallPETCNN, hp, 0)
    x = _pet(2, 1)
    want = jax.jit(lambda v, b: jax_model.apply(v, b, train=False))(
        variables, {"pet1451": jnp.asarray(x)})
    with torch.inference_mode():
        got = port({"pet1451": torch.from_numpy(x)})
    assert set(got["embeddings"]) == set(want["embeddings"]) == (
        {"gap", "dense"} if linear_out else {"gap"})
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), **PET_TOL)
    for tap, value in want["embeddings"].items():
        np.testing.assert_allclose(got["embeddings"][tap].numpy(),
                                   np.asarray(value), **PET_TOL, err_msg=tap)


def test_small_pet_cnn_train_step_matches_jax():
    """Train mode, dropout off: loss, every gradient and the updated
    BatchNorm running statistics."""
    hp = dict(_small_hparams(True, 32, 3), loss_class_weights=[0.2, 0.5, 0.3])
    jax_model, variables, port = _pair(JaxSmallPETCNN, SmallPETCNN, hp, 2)
    x = _pet(3, 3)
    labels = np.array([0, 2, 1], np.int32)
    criterion = jax_criterion(hp)

    def loss_fn(params):
        out, mutated = jax_model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            {"pet1451": jnp.asarray(x)}, train=True, mutable=["batch_stats"])
        return criterion(out["logits"], jnp.asarray(labels)), mutated

    # Without XLA's fusion pass (run_unfused): fused, the s2d_pool lowering's
    # first BatchNorm gradients on the CPU are ones that finite differences
    # refute (ROADMAP.md, section C).
    (want_loss, mutated), want_grads = run_unfused(
        jax.value_and_grad(loss_fn, has_aux=True),
        jax.tree.map(jnp.asarray, variables["params"]))

    port.train()
    out = port({"pet1451": torch.from_numpy(x)})
    loss = make_criterion(hp)(out["logits"], torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    state, params = port.state_dict(), dict(port.named_parameters())
    grads = flax_from_state_dict({k: params[k].grad if k in params else v
                                  for k, v in state.items()})

    def close(got, want, scale=None):
        want = np.asarray(want)
        scale = np.abs(want).max() if scale is None else scale
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale)

    for i in range(3):
        got_block = grads["params"]["convs"][f"block_{i}"]
        want_block = want_grads["convs"][f"block_{i}"]
        # A conv bias under BatchNorm has gradient 0 but for rounding: held
        # at the scale of its kernel's gradient.
        close(got_block["conv"]["bias"], want_block["conv"]["bias"],
              np.abs(np.asarray(want_block["conv"]["kernel"])).max())
        got_block["conv"]["bias"] = want_block["conv"]["bias"]
    jax.tree.map(close, grads["params"], want_grads)
    stats = flax_from_state_dict(state)["batch_stats"]
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, np.asarray(w), **STATS_TOL), stats, mutated["batch_stats"])


def test_dropout_semantics():
    torch.manual_seed(0)
    x = torch.rand(64, 256) + 1.0
    layer = Dropout(0.25)
    gen = torch.Generator().manual_seed(11)
    layer.generator = gen
    state = gen.get_state()
    y = layer(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.02
    torch.testing.assert_close(y[kept], x[kept] / 0.75, rtol=0, atol=0)
    gen.set_state(state)
    torch.testing.assert_close(layer(x), y, rtol=0, atol=0)  # same state
    assert not torch.equal(layer(x), y)  # the state advanced
    layer.eval()
    assert layer(x) is x
    assert Dropout(0.0).train()(x) is x
    assert torch.equal(Dropout(1.0).train()(x), torch.zeros_like(x))


def test_trainer_threads_its_dropout_generator():
    """Every Dropout of the model draws from the Trainer's generator, made
    from its seed on its device; two Trainers of one seed take the same
    masks, so their steps are equal."""
    hp = dict(_small_hparams(False, 16, 3, dropout_conv_p=0.2,
                             dropout_dense_p=0.4), lr=1e-3)
    batch = {"pet1451": torch.from_numpy(_pet(2, 4)),
             "label": torch.tensor([0, 2])}
    losses = []
    for _ in range(2):
        model = SmallPETCNN.from_hparams(
            hp, generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, hp, torch.optim.Adam(model.parameters(),
                                                      1e-3),
                          make_criterion(hp), seed=7, device="cpu")
        dropouts = [m for m in model.modules() if isinstance(m, Dropout)]
        assert len(dropouts) == 4
        assert all(m.generator is trainer.dropout_generator
                   for m in dropouts)
        assert trainer.dropout_generator.device == torch.device("cpu")
        state = trainer.init_state()
        steps = [trainer.train_step(state, batch)[1]["loss"].item()
                 for _ in range(2)]
        losses.append(steps)
    assert losses[0] == losses[1]
    assert losses[0][0] != losses[0][1]
    set_dropout_generator(model, None)
    assert all(m.generator is None for m in dropouts)


@pytest.mark.parametrize("n_classes", [2, 3])
def test_random_benchmark_and_fusion_tap(n_classes):
    hp = _small_hparams(False, 32, 3, n_classes=n_classes)
    model = RandomBenchmarkAllCN.from_hparams(hp).eval()
    out = model({"pet1451": torch.from_numpy(_pet(3, 5))})
    want = np.zeros((3, n_classes), np.float32)
    want[:, 0] = 1.0
    np.testing.assert_array_equal(out["logits"].numpy(), want)
    assert set(out["embeddings"]) == {"gap", "dense"}
    jax_model = JaxSmallPETCNN.from_hparams(hp)
    assert model.fusion_tap() == jax_model.fusion_tap() == (
        "gap" if n_classes == 2 else "dense")


def test_pet_resnet_cnn_matches_jax():
    hp = {"n_classes": 2, "resnet_depth": 10, "linear_out": (16,),
          "batchnorm_dense": True}
    jax_model, variables, port = _pair(JaxPETResNetCNN, PETResNetCNN, hp, 6,
                                       (12, 14, 12))
    assert port.input_key == jax_model.input_key == "pet1451"
    x = _pet(2, 7, (12, 14, 12))
    want = jax.jit(lambda v, b: jax_model.apply(v, b, train=False))(
        variables, {"pet1451": jnp.asarray(x)})
    with torch.inference_mode():
        got = port({"pet1451": torch.from_numpy(x)})
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), **RESNET_TOL)
    np.testing.assert_allclose(
        got["embeddings"]["backbone_gap"].numpy(),
        np.asarray(want["embeddings"]["backbone_gap"]), **RESNET_TOL)
    wf = PETResNetCNN.from_hparams(hp, maxpool_impl="wf")
    assert wf.backbone.maxpool_impl == "wf" and wf.input_key == "pet1451"


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("module", ["pet_cnn", "pet_resnet_cnn"])
def test_sample_hparams_matches_jax(module, seed):
    port_mod, jax_mod = {
        "pet_cnn": (train_pet_cnn, jax_train_pet_cnn),
        "pet_resnet_cnn": (train_pet_resnet_cnn, jax_train_pet_resnet_cnn),
    }[module]
    port_trial, jax_trial = Trial(seed), Trial(seed)
    assert port_mod.sample_hparams(port_trial) == \
        jax_mod.sample_hparams(jax_trial)
    assert port_trial.calls == jax_trial.calls
    for name in ("SEED", "LOG_DIRECTORY", "EXPERIMENT_NAME"):
        assert getattr(port_mod, name) == getattr(jax_mod, name)
