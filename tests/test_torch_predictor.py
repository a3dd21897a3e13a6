"""The port's ``Predictor`` with a prebuilt serve core (``serve_fn=``) and
``predict`` over datasets, against the JAX package's on the CPU.

- ``Predictor(serve_fn=...)`` with the int8 core pads a ragged batch to its
  rung and strips the padding: bit for bit the bare core's rows (the int8
  graph computes each sample on its own, so batch composition changes
  nothing).
- ``predict`` over an indexable dataset and over an iterable of batches
  equals JAX's ``Predictor.predict`` on the same converted weights and raw
  scans, within the model-parity tolerance of tests/test_torch_serve.py
  (rtol 1e-3, atol 1e-4); an empty set gives JAX's (0, n_classes) outputs.
- A core without embedding taps (an exported artifact) predicts with an
  empty ``embeddings`` dict, as in JAX.
- ``mesh=`` over two gloo ranks (``tests/torch_dp_ranks.py``): ``predict``,
  ``predict_batch`` and a ``BatchingServer`` round trip served from rank 0
  (rank 1 following) equal the one-process predictor within rtol 1e-5,
  atol 1e-6 (each rank runs half the rung) with the argmax equal; a rung
  that does not split over the ranks is refused at construction, as in
  JAX.
"""

import types

import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.data.dataset import MultiModalDataset
from multimodal_alzheimer_tpu.data.synthetic import (
    ArrayDataset as JaxArrayDataset,
)
from multimodal_alzheimer_tpu.inference.predictor import (
    Predictor as JaxPredictor,
)
from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.data.synthetic import ArrayDataset
from multimodal_alzheimer_tpu_torch.inference import export as E
from multimodal_alzheimer_tpu_torch.inference import quantize as Q
from multimodal_alzheimer_tpu_torch.inference.predictor import Predictor
from multimodal_alzheimer_tpu_torch.parallel import Mesh
from multimodal_alzheimer_tpu_torch.parallel.launch import run_ranks
from torch_dp_ranks import predictor_on_ranks
from torch_port_helpers import model_pair
from torch_threads import torch_threads  # noqa: F401 (autouse)

TOL = dict(rtol=1e-3, atol=1e-4)
SHAPE = (12, 14, 12)
MINMAX = {"per_scan_norm": "min_max"}


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return {"mri": rng.normal(900, 400, (n,) + SHAPE).astype(np.float32),
            "mri_mask": (rng.random((n,) + SHAPE) > 0.35).astype(np.float32),
            "label": (np.arange(n) % 3).astype(np.int32)}


@pytest.fixture(scope="module")
def pair():
    jax_model, variables, port = model_pair(
        {"n_classes": 3, "resnet_depth": 10}, SHAPE, seed=11)
    holder = types.SimpleNamespace(normalize_pet=None, normalize_mri=MINMAX,
                                   quantile=0.99)
    jax_pred = JaxPredictor(
        jax_model, variables, batch_size=4,
        preprocess=MultiModalDataset.get_device_preprocess(holder))
    preprocess = make_device_preprocess(normalize_mri=MINMAX, quantile=0.99)
    port_pred = Predictor(port, batch_size=4, device="cpu",
                          preprocess=preprocess)
    return jax_pred, port_pred, port, preprocess


def test_serve_fn_core_pads_ragged_tail(pair):
    _, _, port, preprocess = pair
    data = _data(6, seed=1)
    batch = {k: torch.from_numpy(v) for k, v in data.items()
             if k != "label"}
    serve, _ = Q.quantize_anat_cnn(port, [batch], preprocess)
    ref = serve(batch)
    pred = Predictor(port, batch_size=4, ladder=(2,), serve_fn=serve,
                     device="cpu")
    for lo, hi in ((0, 1), (1, 4), (4, 6)):
        out = pred.predict_batch({k: v[lo:hi].numpy()
                                  for k, v in batch.items()})
        assert out["logits"].shape == (hi - lo, 3)
        np.testing.assert_array_equal(out["logits"],
                                      ref["logits"][lo:hi].numpy())
        np.testing.assert_array_equal(
            out["embeddings"]["backbone_gap"],
            ref["embeddings"]["backbone_gap"][lo:hi].numpy())


@pytest.mark.parametrize("source", ["dataset", "batches"])
def test_predict_matches_jax(pair, source):
    jax_pred, port_pred, _, _ = pair
    data = _data(7, seed=2)  # ragged against batch 4
    if source == "dataset":
        want = jax_pred.predict(JaxArrayDataset(data))
        got = port_pred.predict(ArrayDataset(data))
    else:
        parts = [{k: v[:4] for k, v in data.items()},
                 {k: v[4:] for k, v in data.items()}]
        want = jax_pred.predict(iter(parts))
        got = port_pred.predict(iter(parts))
    assert got["logits"].shape == (7, 3)
    for key in ("logits", "probs"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), **TOL)
    assert set(got["embeddings"]) == set(want["embeddings"])
    np.testing.assert_allclose(got["embeddings"]["backbone_gap"],
                               want["embeddings"]["backbone_gap"], **TOL)


def test_predict_empty_sets(pair):
    jax_pred, port_pred, _, _ = pair
    want = jax_pred.predict(iter(()))
    empty = {k: v[:0] for k, v in _data(1, seed=3).items()}
    for got in (port_pred.predict(iter(())),
                port_pred.predict(ArrayDataset(empty))):
        for key in ("logits", "probs"):
            assert got[key].shape == want[key].shape == (0, 3)
        assert got["embeddings"] == want["embeddings"] == {}
    bare = Predictor(serve_fn=port_pred.serve_fn, batch_size=4,
                     device="cpu")
    assert bare.predict(iter(()))["logits"].shape == (0, 0)


def test_predict_over_exported_artifact(pair):
    _, port_pred, port, preprocess = pair
    data = _data(5, seed=4)
    example = {k: torch.from_numpy(v[:4]) for k, v in data.items()
               if k != "label"}
    serve = E.load_exported(E.export_model(port, example, preprocess))
    pred = Predictor(port, batch_size=4, serve_fn=serve, device="cpu")
    out = pred.predict(ArrayDataset(data))
    assert out["embeddings"] == {}
    ref = port_pred.predict(ArrayDataset(data))
    np.testing.assert_array_equal(out["logits"], ref["logits"])


def _two_ranks():
    """A mesh of two ranks, for checks that refuse before any collective."""
    return Mesh(None, 0, 2, torch.device("cpu"), "gloo")


def test_mesh_and_missing_model_are_refused():
    with pytest.raises(ValueError, match="not multiples"):
        Predictor(torch.nn.Linear(1, 1), batch_size=4, ladder=(1, 2),
                  device="cpu", mesh=_two_ranks())
    Predictor(torch.nn.Linear(1, 1), batch_size=4, ladder=(2,),
              mesh=_two_ranks())
    with pytest.raises(ValueError, match="model or a serve_fn"):
        Predictor(device="cpu")


def test_mesh_predictor_and_server_match_one_process(pair):
    _, port_pred, port, _ = pair
    data = _data(7, seed=5)
    ranks = run_ranks(predictor_on_ranks, 2, "gloo", port.state_dict(),
                      {"n_classes": 3, "resnet_depth": 10}, data,
                      device="cpu", timeout=180)
    want = port_pred.predict(ArrayDataset(data))
    parts = [{k: v[lo:hi] for k, v in data.items() if k != "label"}
             for lo, hi in ((0, 1), (1, 4), (3, 7))]
    want_batches = [port_pred.predict_batch(p) for p in parts]

    def close(got, ref):
        for key in ("logits", "probs"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-5,
                                       atol=1e-6)
        np.testing.assert_allclose(got["embeddings"]["backbone_gap"],
                                   ref["embeddings"]["backbone_gap"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got["logits"].argmax(-1),
                                      ref["logits"].argmax(-1))

    for rank in ranks:
        close(rank["predict"], want)
        for got, ref in zip(rank["batches"], want_batches):
            close(got, ref)
    served = ranks[0]["served"]
    assert len(served) == 7
    for i, result in enumerate(served):
        close({k: v[None] if k != "embeddings" else
               {t: e[None] for t, e in v.items()}
               for k, v in result.items()},
              {k: v[i:i + 1] if k != "embeddings" else
               {t: e[i:i + 1] for t, e in v.items()}
               for k, v in want.items()})
    assert ranks[1]["followed"] == sum(ranks[0]["histogram"].values())
