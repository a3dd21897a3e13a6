"""The port's utilities against the JAX package's, on the CPU.

Ports ``tests/test_misc_utils.py``'s soft vote, split, subject-leakage and
label-distribution cases, the six cases of ``tests/test_plot_performance.py``
(rendering needs matplotlib: those skip where it is absent, as on the
card's machine) and ``tests/test_property_fuzz.py``'s trace case (the
port's trace file exists on the CPU). Also: ``soft_vote`` against JAX's on
random logits and weights, ``pairing_time_deltas`` and
``check_manifest_shapes`` on the port's rows and the host benchmark's
line.
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from multimodal_alzheimer_tpu.data.dataset import (
    MultiModalDataset as JaxDataset,
)
from multimodal_alzheimer_tpu.utils import plot_performance as jax_plots
from multimodal_alzheimer_tpu.utils import plots_dataset as jax_dataset_plots
from multimodal_alzheimer_tpu.utils.majority_voting import (
    soft_vote as jax_soft_vote,
)
from multimodal_alzheimer_tpu_torch.data.csv_table import read_csv_rows
from multimodal_alzheimer_tpu_torch.data.dataset import MultiModalDataset
from multimodal_alzheimer_tpu_torch.data.split import split_ids
from multimodal_alzheimer_tpu_torch.data.synthetic import (
    write_synthetic_split,
)
from multimodal_alzheimer_tpu_torch.tools import bench_host
from multimodal_alzheimer_tpu_torch.utils.majority_voting import soft_vote
from multimodal_alzheimer_tpu_torch.utils.plot_performance import (
    STAGE_ORDER,
    collect_scores,
    limit_err_values,
    order_models,
    plot_experiment_comparison,
    plot_scores,
    plot_stage_comparison,
    plot_two_vs_three,
)
from multimodal_alzheimer_tpu_torch.utils.plots_dataset import (
    check_manifest_shapes,
    check_no_subject_leakage,
    label_distribution_frame,
    pairing_time_deltas,
)
from multimodal_alzheimer_tpu_torch.utils.profiling import trace
from torch_threads import torch_threads  # noqa: F401 (autouse)


def test_soft_vote_unweighted_and_weighted():
    l1 = torch.tensor([[10.0, 0.0], [0.0, 10.0]])
    l2 = torch.tensor([[0.0, 1.0], [0.0, 1.0]])
    # unweighted: sample 0 -> model1 dominates (prob ~1 vs ~0.27)
    preds = soft_vote([l1, l2])
    np.testing.assert_array_equal(preds.numpy(), [0, 1])
    # heavily weight model 2 -> its preference wins sample 0
    preds_w = soft_vote([l1, l2], weights=[0.01, 0.99])
    np.testing.assert_array_equal(preds_w.numpy(), [1, 1])


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("weighted", [False, True])
def test_soft_vote_matches_jax(seed, weighted):
    rng = np.random.default_rng(seed)
    m, n, c = int(rng.integers(2, 5)), 64, int(rng.integers(2, 4))
    logits = [rng.normal(size=(n, c)).astype(np.float32) * 3
              for _ in range(m)]
    weights = rng.uniform(0.1, 1.0, m).tolist() if weighted else None
    got = soft_vote([torch.from_numpy(x) for x in logits], weights)
    want = jax_soft_vote([jnp.asarray(x) for x in logits], weights)
    assert got.dtype == torch.int64 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_soft_vote_ties_take_the_first_class_as_jax():
    logits = [torch.zeros(3, 4), torch.zeros(3, 4)]
    np.testing.assert_array_equal(soft_vote(logits).numpy(),
                                  np.asarray(jax_soft_vote(
                                      [jnp.zeros((3, 4))] * 2)))


def test_split_ids_deterministic():
    ids = list(range(100))
    s1 = split_ids(ids)
    s2 = split_ids(ids)
    assert s1 == s2
    assert len(s1["test"]) == 10
    assert len(s1["val"]) == 9  # 10% of the remaining 90
    all_ids = s1["train"] + s1["val"] + s1["test"]
    assert sorted(all_ids) == list(range(100))


def test_subject_leakage_check():
    check_no_subject_leakage({"train": [1, 2], "val": [3], "test": [4]})
    with pytest.raises(ValueError, match="leaks") as got:
        check_no_subject_leakage({"train": [1, 2], "val": [2]})
    with pytest.raises(ValueError) as want:
        jax_dataset_plots.check_no_subject_leakage({"train": [1, 2],
                                                    "val": [2]})
    assert str(got.value) == str(want.value)


def test_label_distribution_frame():
    rows = [{"label": "CN"}, {"label": "CN"}, {"label": "MCI"}]
    out = label_distribution_frame({"train": rows})
    assert set(out["label"]) == {"CN", "MCI"}
    assert out.loc[out["label"] == "CN", "count"].iloc[0] == 2


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("split")
    return write_synthetic_split(str(root / "data"), n_subjects=(6, 3, 3),
                                 seed=2, volume_shape=(12, 14, 12))


def test_label_distribution_matches_jax(split):
    """CSV paths and the port's rows give JAX's frame (ties in file
    order)."""
    got = label_distribution_frame({m: split[m] for m in split})
    want = jax_dataset_plots.label_distribution_frame(
        {m: split[m] for m in split})
    pd.testing.assert_frame_equal(got, want)
    rows = label_distribution_frame({"train": read_csv_rows(
        split["train"])})
    pd.testing.assert_frame_equal(
        rows, jax_dataset_plots.label_distribution_frame(
            {"train": split["train"]}))


def test_pairing_time_deltas_matches_jax(split):
    mods = ["pet1451", "t1w", "tabular"]
    port = MultiModalDataset(split["train"], modalities=mods)
    jax = JaxDataset(split["train"], modalities=mods)
    assert len(port) > 0
    np.testing.assert_array_equal(
        pairing_time_deltas(port.rows),
        jax_dataset_plots.pairing_time_deltas(jax.ds))


def test_check_manifest_shapes(split):
    check_manifest_shapes(split["train"], expected_shape=(12, 14, 12))
    check_manifest_shapes(read_csv_rows(split["val"]),
                          expected_shape=(12, 14, 12))
    with pytest.raises(ValueError) as got:
        check_manifest_shapes(split["val"])
    with pytest.raises(ValueError) as want:
        jax_dataset_plots.check_manifest_shapes(pd.read_csv(split["val"]))
    assert str(got.value) == str(want.value)


def _scores(seed=0):
    rng = np.random.default_rng(seed)
    f1, f1_ci = rng.uniform(0.4, 0.99, 7), rng.uniform(0.0, 0.08, 7)
    mcc, mcc_ci = rng.uniform(0.2, 0.9, 7), rng.uniform(0.0, 0.08, 7)
    return [{"model": m, "f1": float(f1[i]), "f1_ci": float(f1_ci[i]),
             "mcc": float(mcc[i]), "mcc_ci": float(mcc_ci[i])}
            for i, m in enumerate(STAGE_ORDER)]


def test_limit_err_values_clips_to_unit_interval():
    err = limit_err_values([0.99, 0.5, 0.003], [0.05, 0.1, 0.05])
    vals = np.asarray([0.99, 0.5, 0.003])
    assert np.all(vals + err[1] <= 1.0)
    assert np.all(vals - err[0] >= 0.0)
    # untouched where no clipping needed
    assert err[0][1] == err[1][1] == 0.1
    np.testing.assert_array_equal(
        err, jax_plots.limit_err_values([0.99, 0.5, 0.003],
                                        [0.05, 0.1, 0.05]))


def test_order_models_canonical_stage_order():
    rows = _scores()
    shuffled = [rows[i] for i in np.random.default_rng(3).permutation(7)]
    shuffled.append({"model": "Custom", "f1": 0.5, "f1_ci": 0,
                     "mcc": 0.4, "mcc_ci": 0})
    shuffled.insert(2, {"model": "Other", "f1": 0.5, "f1_ci": 0,
                        "mcc": 0.4, "mcc_ci": 0})
    out = order_models(shuffled)
    assert [r["model"] for r in out[:7]] == STAGE_ORDER
    assert [r["model"] for r in out[7:]] == ["Other", "Custom"]
    assert out == jax_plots.order_models(
        pd.DataFrame(shuffled)).to_dict("records")


@pytest.mark.parametrize("color_by_modality", [False, True])
def test_stage_comparison_renders(tmp_path, color_by_modality):
    pytest.importorskip("matplotlib")
    path = str(tmp_path / "stage.png")
    fig, ax = plot_stage_comparison(_scores(), binary=True,
                                    color_by_modality=color_by_modality,
                                    out_path=path)
    assert os.path.exists(path) and os.path.getsize(path) > 10_000
    # 7 models x 2 metrics = 14 bars
    assert len([p for p in ax.patches
                if p.get_height() > 0]) >= 14


def test_two_vs_three_comparison_figure(tmp_path):
    pytest.importorskip("matplotlib")
    path = str(tmp_path / "two_vs_three.png")
    fig, axes = plot_two_vs_three(_scores(1), _scores(2), out_path=path)
    assert os.path.exists(path) and os.path.getsize(path) > 10_000
    assert axes[0].get_xlabel() == "2 Targets"
    assert axes[1].get_xlabel() == "3 Targets"


def test_experiment_comparison(tmp_path):
    pytest.importorskip("matplotlib")
    rows = _scores()[:5]
    for row, name in zip(rows, ["EF-same", "EF-diff", "FMF-concat",
                                "FMF-max", "FC"]):
        row["model"] = name
    path = str(tmp_path / "exp.png")
    plot_experiment_comparison(
        rows, [("Early Fusion", 2), ("CNN Fusion", 2), ("FC Fusion", 1)],
        out_path=path)
    assert os.path.exists(path) and os.path.getsize(path) > 10_000


def test_collect_scores_then_plot(tmp_path):
    metrics = {"PET": {"test_f1_epoch_boot": 0.9, "test_f1_epoch_ci": 0.02,
                       "test_mcc_epoch_boot": 0.8,
                       "test_mcc_epoch_ci": 0.03},
               "MRI": {"test_f1_epoch": 0.84,
                       "test_mcc_epoch_boot": 0.7}}
    rows = collect_scores(metrics)
    assert next(r for r in rows if r["model"] == "PET")["f1"] == 0.9
    assert rows == jax_plots.collect_scores(metrics).to_dict("records")
    pytest.importorskip("matplotlib")
    plot_scores(rows, out_path=str(tmp_path / "s.png"))
    assert os.path.getsize(tmp_path / "s.png") > 5_000


def test_profiler_trace_smoke(tmp_path):
    """utils/profiling.trace writes a Chrome/TensorBoard trace file."""
    x = torch.ones(64, 64)
    with trace(str(tmp_path)) as prof:
        (x @ x).sum()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1, "no trace written"
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_bench_host_line(capsys):
    out = bench_host.main()
    line = json.loads(capsys.readouterr().out)
    assert line == out
    assert set(line) == {"memcpy_steady_mb_s", "memcpy_fresh_alloc_mb_s",
                         "convert_mb_s", "gzip_inflate_mb_s", "cpu_count",
                         "healthy"}
