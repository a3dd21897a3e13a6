"""The port's losses, metrics and bootstrap against the JAX package (CPU).

Same numpy inputs through both. Losses and their logit gradients within
rtol 1e-6 (both f32, log-softmax in another order); metrics from a
confusion matrix of exact counts within rtol 1e-6; the bootstrap is run on
the index matrix JAX draws, handed to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.losses import classification as jax_losses
from multimodal_alzheimer_tpu.metrics import bootstrap as jax_bootstrap
from multimodal_alzheimer_tpu.metrics import classification as jax_metrics
from multimodal_alzheimer_tpu_torch.losses import classification as losses
from multimodal_alzheimer_tpu_torch.metrics import bootstrap, classification
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator
from torch_threads import torch_threads  # noqa: F401 (autouse)

TOL = dict(rtol=1e-6, atol=1e-7)


def _logits_labels(n=16, c=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, c)).astype(np.float32) * 2,
            rng.integers(0, c, n).astype(np.int32))


def _value_and_grad_pair(jax_fn, port_fn, logits, labels):
    want, want_grad = jax.value_and_grad(jax_fn)(jnp.asarray(logits),
                                                jnp.asarray(labels))
    x = torch.tensor(logits, requires_grad=True)
    got = port_fn(x, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-7)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("weights", [None, [0.2, 0.5, 0.3]])
def test_weighted_cross_entropy(weights):
    logits, labels = _logits_labels()
    _value_and_grad_pair(
        lambda x, y: jax_losses.weighted_cross_entropy(
            x, y, None if weights is None else jnp.asarray(weights)),
        lambda x, y: losses.weighted_cross_entropy(x, y, weights),
        logits, labels)


def test_weighted_cross_entropy_is_torchs():
    logits, labels = _logits_labels(seed=1)
    w = [0.2, 0.5, 0.3]
    want = torch.nn.CrossEntropyLoss(weight=torch.tensor(w))(
        torch.from_numpy(logits), torch.from_numpy(labels).long())
    got = losses.weighted_cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(labels), w)
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)


@pytest.mark.parametrize("gamma", [0.0, 2.0])
@pytest.mark.parametrize("alpha", [None, 0.25, [0.3, 0.7]])
@pytest.mark.parametrize("size_average", [True, False])
def test_focal_loss(gamma, alpha, size_average):
    logits, labels = _logits_labels(c=2, seed=2)
    _value_and_grad_pair(
        lambda x, y: jax_losses.focal_loss(x, y, gamma, alpha, size_average),
        lambda x, y: losses.focal_loss(x, y, gamma, alpha, size_average),
        logits, labels)


@pytest.mark.parametrize("hparams", [
    {}, {"loss_class_weights": [0.7, 0.1, 0.2]}, {"fl_gamma": 2.0},
    {"fl_gamma": 0, "loss_class_weights": [0.5, 0.25, 0.25]}])
def test_make_criterion(hparams):
    logits, labels = _logits_labels(seed=3)
    _value_and_grad_pair(jax_losses.make_criterion(hparams),
                         losses.make_criterion(hparams), logits, labels)


def _preds_labels(n, c, seed, absent=None):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, n)
    preds = rng.integers(0, c, n)
    if absent is not None:
        labels[labels == absent] = (absent + 1) % c
        preds[preds == absent] = (absent + 1) % c
    return preds.astype(np.int32), labels.astype(np.int32)


METRICS = ["f1_per_class", "f1_macro", "matthews_corrcoef",
           "balanced_accuracy"]


@pytest.mark.parametrize("n_classes,absent", [(2, None), (3, None), (3, 1)])
def test_confusion_matrix_metrics(n_classes, absent):
    preds, labels = _preds_labels(40, n_classes, n_classes, absent)
    weights = np.random.default_rng(4).integers(0, 3, 40).astype(np.float32)
    for w in (None, weights):
        want = jax_metrics.confusion_matrix(
            jnp.asarray(preds), jnp.asarray(labels), n_classes,
            None if w is None else jnp.asarray(w))
        got = classification.confusion_matrix(
            torch.from_numpy(preds), torch.from_numpy(labels), n_classes,
            None if w is None else torch.from_numpy(w))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for name in METRICS:
            np.testing.assert_allclose(
                getattr(classification, name)(got).numpy(),
                np.asarray(getattr(jax_metrics, name)(want)), **TOL,
                err_msg=name)


def test_degenerate_confusion_matrices_give_zero():
    for cm in (np.zeros((3, 3), np.float32),
               np.diag([4.0, 0.0, 0.0]).astype(np.float32)):
        for name in METRICS[1:]:
            np.testing.assert_allclose(
                getattr(classification, name)(torch.from_numpy(cm)).numpy(),
                np.asarray(getattr(jax_metrics, name)(jnp.asarray(cm))),
                err_msg=name)


@pytest.mark.parametrize("n_classes", [2, 3])
def test_epoch_metrics(n_classes):
    logits, labels = _logits_labels(30, n_classes, seed=5)
    want = jax_metrics.epoch_metrics(jnp.asarray(logits),
                                     jnp.asarray(labels), n_classes)
    got = classification.epoch_metrics(torch.from_numpy(logits),
                                       torch.from_numpy(labels), n_classes)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(value),
                                   **TOL, err_msg=key)


@pytest.mark.parametrize("metric", ["f1_macro", "matthews_corrcoef"])
def test_bootstrap_on_jaxs_indices(metric):
    logits, labels = _logits_labels(25, 3, seed=6)
    key = jax.random.PRNGKey(11)
    n_drawings = 200
    want_mean, want_ci = jax_bootstrap.bootstrap_metric(
        getattr(jax_metrics, metric), jnp.asarray(logits),
        jnp.asarray(labels), 3, key, n_drawings)
    idx = np.array(jax.random.randint(key, (n_drawings, 25), 0, 25))
    got_mean, got_ci = bootstrap.bootstrap_from_indices(
        getattr(classification, metric), torch.from_numpy(logits),
        torch.from_numpy(labels), 3, torch.from_numpy(idx))
    np.testing.assert_allclose(got_mean.item(), float(want_mean), rtol=1e-5)
    np.testing.assert_allclose(got_ci.item(), float(want_ci), rtol=1e-4)


def test_bootstrap_draws_from_the_generator():
    logits, labels = _logits_labels(25, 3, seed=7)
    idx = bootstrap.draw_indices(25, 50, make_generator(3))
    assert idx.shape == (50, 25) and idx.dtype == torch.int64
    assert 0 <= int(idx.min()) and int(idx.max()) < 25
    assert torch.equal(idx, bootstrap.draw_indices(25, 50, make_generator(3)))
    a = bootstrap.bootstrap_metric(classification.f1_macro,
                                   torch.from_numpy(logits),
                                   torch.from_numpy(labels), 3,
                                   make_generator(3), 50)
    b = bootstrap.bootstrap_from_indices(classification.f1_macro,
                                         torch.from_numpy(logits),
                                         torch.from_numpy(labels), 3, idx)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
