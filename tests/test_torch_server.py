"""The port's BatchingServer: batching, validation, failure isolation, close.

A tiny torch model behind the port ``Predictor`` on the CPU. The same
requests through the JAX package's ``BatchingServer`` over the same
predictor give the same numbers.
"""

import threading

import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.inference.server import (
    BatchingServer as JaxBatchingServer,
)
from multimodal_alzheimer_tpu_torch.inference.predictor import Predictor
from multimodal_alzheimer_tpu_torch.inference.server import BatchingServer


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.weight = torch.nn.Parameter(torch.randn(9, 3, generator=gen))

    def forward(self, batch):
        h = torch.tanh(batch["x"])
        return {"logits": h @ self.weight, "embeddings": {"tanh": h}}


def _predictor(batch_size=8, ladder=None):
    return Predictor(_Tiny(), batch_size=batch_size, ladder=ladder,
                     device="cpu")


def _sample(rng):
    return {"x": rng.normal(size=(9,)).astype(np.float32)}


def test_results_match_direct_prediction():
    pred = _predictor()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(13, 9)).astype(np.float32)  # ragged against 8
    with BatchingServer(pred, max_wait_s=0.05) as server:
        futures = [server.submit({"x": x[i]}) for i in range(13)]
        results = [f.result(timeout=60) for f in futures]
    ref = np.concatenate([pred.predict_batch({"x": x[:8]})["logits"],
                          pred.predict_batch({"x": x[8:]})["logits"]])
    np.testing.assert_allclose(np.stack([r["logits"] for r in results]), ref,
                               rtol=1e-6, atol=1e-7)
    for r in results:
        assert r["probs"].shape == (3,)
        assert r["embeddings"]["tanh"].shape == (9,)


@pytest.mark.parametrize("server_cls", [BatchingServer, JaxBatchingServer],
                         ids=["port", "jax"])
def test_concurrent_clients_same_as_jax_server(server_cls):
    """Both servers over the port Predictor give each client its
    single-sample numbers."""
    pred = _predictor(batch_size=4, ladder=(2,))
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(16, 9)).astype(np.float32)
    ref = np.concatenate([pred.predict_batch({"x": xs[i:i + 1]})["logits"]
                          for i in range(16)])
    got = np.zeros_like(ref)
    errors = []
    with server_cls(pred, max_wait_s=0.02) as server:
        def client(i):
            try:
                got[i] = server.submit({"x": xs[i]}).result(
                    timeout=60)["logits"]
            except Exception as e:  # surfaced below
                errors.append(e)
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    assert not errors
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert server.samples_served == 16
    assert sum(k * v for k, v in server.batch_histogram.items()) == 16


def test_full_batch_serves_as_one_launch():
    pred = _predictor(batch_size=4)
    rng = np.random.default_rng(1)
    server = BatchingServer(pred, max_wait_s=2.0)
    futures = [server.submit(_sample(rng)) for _ in range(8)]
    for f in futures:
        f.result(timeout=60)
    server.close()
    assert server.samples_served == 8
    assert server.batch_histogram == {4: 2}  # two full batches


def test_lone_request_runs_the_small_rung():
    pred = _predictor(batch_size=8, ladder=(2,))
    calls = []
    real = pred._serve

    def spy(batch, n):
        calls.append(len(batch["x"]))
        return real(batch, n)

    pred._serve = spy
    with BatchingServer(pred, max_wait_s=0.01) as server:
        out = server.submit(_sample(np.random.default_rng(3))).result(
            timeout=60)
    assert out["logits"].shape == (3,)
    assert calls == [2] and server.batch_histogram == {1: 1}


def test_submit_validates_shape_dtype_and_keys():
    pred = _predictor()
    with BatchingServer(pred, max_wait_s=0.01) as server:
        server.submit({"x": np.zeros(9, np.float32)}).result(timeout=60)
        with pytest.raises(ValueError, match="committed"):
            server.submit({"x": np.zeros(7, np.float32)})
        with pytest.raises(ValueError, match="committed"):
            server.submit({"x": np.zeros(9, np.float64)})
        with pytest.raises(ValueError, match="keys"):
            server.submit({"y": np.zeros(9, np.float32)})


def test_batch_failure_is_isolated():
    pred = _predictor()
    calls = {"n": 0}
    real = pred.predict_parts

    def flaky(samples):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected device failure")
        return real(samples)

    pred.predict_parts = flaky
    server = BatchingServer(pred, max_wait_s=0.01)
    bad = server.submit({"x": np.zeros(9, np.float32)})
    with pytest.raises(RuntimeError, match="injected"):
        bad.result(timeout=60)
    good = server.submit({"x": np.zeros(9, np.float32)})
    assert good.result(timeout=60)["logits"].shape == (3,)
    server.close()
    assert server.batches_served == 1  # the failed batch is not counted


def test_cancelled_future_does_not_kill_worker():
    pred = _predictor(batch_size=4)
    server = BatchingServer(pred, max_wait_s=0.2)
    futures = [server.submit({"x": np.zeros(9, np.float32)})
               for _ in range(3)]
    won = futures[1].cancel()  # False only if the worker claimed it first
    for i, f in enumerate(futures):
        if i == 1 and won:
            assert f.cancelled()
        else:
            assert f.result(timeout=60)["logits"].shape == (3,)
    late = server.submit({"x": np.zeros(9, np.float32)})
    assert late.result(timeout=60)["logits"].shape == (3,)
    server.close()


def test_every_staged_sample_is_released():
    """Served, cancelled and raced-against-close requests all release
    their staged sample."""
    pred = _predictor(batch_size=4)
    released = []
    real = pred.stage_sample

    def stage(sample):
        staged = real(sample)
        staged.release = lambda: released.append(staged)
        return staged

    pred.stage_sample = stage
    server = BatchingServer(pred, max_wait_s=5.0)
    f1 = server.submit({"x": np.zeros(9, np.float32)})
    f2 = server.submit({"x": np.zeros(9, np.float32)})
    assert f2.cancel()  # still queued behind the batching window
    server.close()  # drains: serves f1, releases f2 too
    assert f1.result(timeout=60)["logits"].shape == (3,)
    assert len(released) == 2


def test_close_semantics():
    pred = _predictor()
    server = BatchingServer(pred, max_wait_s=0.01)
    server.submit({"x": np.zeros(9, np.float32)}).result(timeout=60)
    assert server._spec is not None
    server.close()
    assert server._spec is None  # a closed server holds no commitment
    with pytest.raises(RuntimeError, match="closed"):
        server.submit({"x": np.zeros(9, np.float32)})
    server.close()  # a second close neither deadlocks nor raises


def test_close_without_drain_answers_every_future():
    pred = _predictor(batch_size=8)
    server = BatchingServer(pred, max_wait_s=30.0)
    futures = [server.submit({"x": np.zeros(9, np.float32)})
               for _ in range(3)]
    server.close(drain=False)
    assert all(f.done() for f in futures)
    for f in futures:
        exc = f.exception()
        if exc is not None:
            assert "closed" in str(exc)
        else:
            assert f.result()["logits"].shape == (3,)


def test_predictor_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        assert Predictor(_Tiny()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Predictor(_Tiny())
    assert Predictor(_Tiny(), device="cpu").device.type == "cpu"
