"""The port's dataset-level quality harness (``inference/quality.py``)
against the JAX package's on the CPU.

Both packages evaluate cores that hand back a fixed probability table (the
batch's ``'x'``), so both see the same predictions: f1, MCC, balanced
accuracy, the confusion matrix, the predicted counts, agreement, the deltas
and the maximum probability gap must be equal, and so must the rendered
table without bootstrap. The bootstrap draws other indices than JAX's
(``torch.Generator``), so its CIs are held to their properties: a paired
delta CI of exactly 0 for an identical core, a positive one for another
core, and every draw equal (to float32 rounding, rtol 1e-6) to a numpy
recomputation over the port's own index matrix.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.inference import quality as JQ
from multimodal_alzheimer_tpu_torch.inference import quality as Q
from multimodal_alzheimer_tpu_torch.metrics.bootstrap import draw_indices
from torch_threads import torch_threads  # noqa: F401 (autouse)

N_CLASSES = 3


def _tables(n, seed):
    """Two probability tables: a noisy classifier and a perturbed copy."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, N_CLASSES, n).astype(np.int32)
    logits = rng.normal(size=(n, N_CLASSES)) + 1.5 * np.eye(N_CLASSES)[labels]
    p0 = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    p1 = np.roll(p0, 1, axis=1) * 0.3 + p0 * 0.7
    return labels, p0.astype(np.float32), p1.astype(np.float32)


def _core(offset: int):
    """A core (for either package) reading its probabilities from columns
    offset..offset+2 of the batch's ``'x'``."""
    def serve(batch):
        p = batch["x"][:, offset:offset + N_CLASSES]
        return {"logits": p, "probs": p}
    return serve


def _data(n, seed):
    labels, p0, p1 = _tables(n, seed)
    return {"x": np.concatenate([p0, p1], axis=1), "label": labels}


CORES = {"float": 0, "same": 0, "other": N_CLASSES}
KEYS = ("f1", "mcc", "balanced_acc", "n", "pred_counts", "delta_f1",
        "delta_mcc", "agreement", "max_prob_abs_err")


def _compare(data, batch_size, bootstrap=0):
    jax_res = JQ.compare_serve_cores(
        {k: _core(o) for k, o in CORES.items()},
        {k: jnp.asarray(v) if k != "label" else v for k, v in data.items()},
        N_CLASSES, batch_size=batch_size, bootstrap=bootstrap)
    port_res = Q.compare_serve_cores(
        {k: _core(o) for k, o in CORES.items()}, data, N_CLASSES,
        batch_size=batch_size, bootstrap=bootstrap, device="cpu")
    return jax_res, port_res


@pytest.mark.parametrize("n,batch_size", [(40, 8), (37, 8), (5, 32)])
def test_compare_serve_cores_matches_jax(n, batch_size):
    jax_res, port_res = _compare(_data(n, seed=n), batch_size)
    for name in CORES:
        for key in KEYS:
            assert port_res[name][key] == jax_res[name][key], (name, key)
        np.testing.assert_array_equal(port_res[name]["confusion"],
                                      np.asarray(jax_res[name]["confusion"]))
        np.testing.assert_array_equal(port_res[name]["preds"],
                                      np.asarray(jax_res[name]["preds"]))
    assert port_res["float"]["n"] == min(n, n - n % batch_size or n)
    assert port_res["same"]["agreement"] == 1.0
    assert port_res["other"]["max_prob_abs_err"] > 0.0
    assert Q.format_comparison(port_res) == JQ.format_comparison(jax_res)


def _np_metrics(preds, labels):
    cm = np.zeros((N_CLASSES, N_CLASSES))
    np.add.at(cm, (labels, preds), 1)
    tp = np.diag(cm)
    denom = 2 * tp + (cm.sum(0) - tp) + (cm.sum(1) - tp)
    f1 = np.where(denom > 0, 2 * tp / np.where(denom > 0, denom, 1), 0).mean()
    t, p, c, s = cm.sum(1), cm.sum(0), np.trace(cm), cm.sum()
    den = np.sqrt((s * s - t @ t) * (s * s - p @ p))
    mcc = (c * s - t @ p) / den if den > 0 else 0.0
    support = cm.sum(1)
    recall = np.where(support > 0, tp / np.where(support > 0, support, 1), 0)
    bal = recall.sum() / max((support > 0).sum(), 1)
    return f1, mcc, bal


def test_bootstrap_cis_and_paired_deltas():
    data = _data(96, seed=5)
    _, res = _compare(data, 16, bootstrap=200)
    for r in res.values():
        assert 0 < r["f1_ci"] < 1 and 0 < r["mcc_ci"]
    assert res["same"]["delta_f1_ci"] == 0.0
    assert res["same"]["delta_mcc_ci"] == 0.0
    assert res["other"]["delta_f1_ci"] > 0
    assert "±" in Q.format_comparison(res)

    idx = draw_indices(96, 200, torch.Generator().manual_seed(0)).numpy()
    preds = res["other"]["preds"]
    want = np.array([_np_metrics(preds[row], data["label"][row])
                     for row in idx])
    np.testing.assert_allclose(res["other"]["boot_draws"], want, rtol=1e-6,
                               atol=1e-7)
    ci = 1.96 * want.std(axis=0, ddof=1)
    assert res["other"]["f1_ci"] == pytest.approx(ci[0], rel=1e-5)


def test_evaluate_serve_small_and_empty_sets():
    data = {"x": np.zeros((5, 3), np.float32),
            "label": np.arange(5, dtype=np.int32) % 3}
    data["x"][np.arange(5), data["label"]] = 1.0
    oracle = _core(0)
    r = Q.evaluate_serve(oracle, data, 3, batch_size=32, device="cpu")
    assert r["n"] == 5 and r["f1"] == 1.0 and r["mcc"] == 1.0
    empty = {"x": np.zeros((0, 3), np.float32),
             "label": np.zeros((0,), np.int32)}
    with pytest.raises(ValueError, match="empty eval set"):
        Q.evaluate_serve(oracle, empty, 3, batch_size=8, device="cpu")
    with pytest.raises(ValueError, match="empty eval set"):
        JQ.evaluate_serve(oracle, empty, 3, batch_size=8)
