"""The serving slice as a whole: raw MRI requests through preprocess + model.

JAX side: the JAX ``Predictor`` with the JAX device preprocess (on the CPU
it takes the sort path of the min-max quantiles). Port side: the port
``Predictor`` on ``device='cpu'`` (the kernels' plain versions). Same
converted weights; tolerance as tests/test_torch_anat_cnn.py.
"""

import threading
import types

import numpy as np
import pytest

from multimodal_alzheimer_tpu.data.dataset import MultiModalDataset
from multimodal_alzheimer_tpu.inference.predictor import (
    Predictor as JaxPredictor,
)
from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.inference.predictor import Predictor
from multimodal_alzheimer_tpu_torch.inference.server import BatchingServer
from multimodal_alzheimer_tpu_torch.ops import hopper_norm
from torch_port_helpers import model_pair
from torch_threads import torch_threads  # noqa: F401 (autouse)

TOL = dict(rtol=1e-3, atol=1e-4)
SHAPE = (12, 14, 12)
MINMAX = {"per_scan_norm": "min_max"}


def _requests(n, seed):
    """Raw requests: ``mri`` and ``mri_mask``, no memoised bounds."""
    rng = np.random.default_rng(seed)
    mri = rng.normal(900, 400, (n,) + SHAPE).astype(np.float32)
    mask = (rng.random((n,) + SHAPE) > 0.35).astype(np.float32)
    return [{"mri": mri[i], "mri_mask": mask[i]} for i in range(n)]


def _stack(samples):
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


@pytest.fixture(scope="module")
def predictors():
    jax_model, variables, port = model_pair(
        {"n_classes": 3, "resnet_depth": 10}, SHAPE, seed=11)
    holder = types.SimpleNamespace(normalize_pet=None, normalize_mri=MINMAX,
                                   quantile=0.99)
    jax_pred = JaxPredictor(
        jax_model, variables, batch_size=4, ladder=(2,),
        preprocess=MultiModalDataset.get_device_preprocess(holder))
    port_pred = Predictor(
        port, batch_size=4, ladder=(2,), device="cpu",
        preprocess=make_device_preprocess(normalize_mri=MINMAX,
                                          quantile=0.99))
    return jax_pred, port_pred


def _assert_outputs_close(got, want):
    np.testing.assert_allclose(got["logits"], want["logits"], **TOL)
    np.testing.assert_allclose(got["probs"], want["probs"], **TOL)
    np.testing.assert_allclose(got["embeddings"]["backbone_gap"],
                               np.asarray(want["embeddings"]["backbone_gap"]),
                               **TOL)


def test_predict_batch_matches_jax(predictors):
    """A ragged batch of 3, zero-padded to the rung of 4 on the host."""
    jax_pred, port_pred = predictors
    batch = _stack(_requests(3, seed=12))
    got = port_pred.predict_batch(batch)
    want = jax_pred.predict_batch(batch)
    assert got["logits"].shape == got["probs"].shape == (3, 3)
    assert got["embeddings"]["backbone_gap"].shape == (3, 512)
    assert np.isfinite(got["logits"]).all()
    _assert_outputs_close(got, want)


@pytest.mark.parametrize("n", [1, 3])
def test_predict_parts_matches_jax(predictors, n):
    """Per-sample dicts stacked on the device, padded by repeating the last
    sample up to the rung."""
    jax_pred, port_pred = predictors
    samples = _requests(n, seed=13)
    launches = dict(hopper_norm.LAUNCHES)
    got = port_pred.predict_parts(
        [port_pred.stage_sample(s) for s in samples])
    want = jax_pred.predict_parts(samples)
    assert got["logits"].shape == (n, 3)
    _assert_outputs_close(got, want)
    assert hopper_norm.LAUNCHES == launches  # CPU tensors launch nothing


def test_server_returns_single_sample_results(predictors):
    """The port's BatchingServer over the port Predictor (ladder 2/4)
    gives each request the numbers a single-sample predict_batch gives."""
    _, port_pred = predictors
    samples = _requests(6, seed=14)
    futures = [None] * len(samples)

    def client(indices):
        for i in indices:
            futures[i] = server.submit(samples[i])

    with BatchingServer(port_pred, max_wait_s=0.02) as server:
        threads = [threading.Thread(target=client, args=(range(k, 6, 2),))
                   for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        results = [f.result(timeout=120) for f in futures]
    assert sum(server.batch_histogram.values()) == server.batches_served
    assert server.samples_served == len(samples)
    for sample, result in zip(samples, results):
        single = port_pred.predict_batch(_stack([sample]))
        np.testing.assert_allclose(result["logits"], single["logits"][0],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(result["probs"], single["probs"][0],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            result["embeddings"]["backbone_gap"],
            single["embeddings"]["backbone_gap"][0], rtol=1e-6, atol=1e-7)
