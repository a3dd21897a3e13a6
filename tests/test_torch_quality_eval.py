"""The port's serve-path quality study
(``multimodal_alzheimer_tpu_torch/tools/quality_eval.py``) at the JAX
tool's CPU smoke flags.

Running the JAX package's ``tools/quality_eval.main`` here would compile a
bf16 train step, eval steps and five serve graphs (well past a minute of
one worker), so the record is held to the lists the JAX tool writes, read
from its source: the top-level keys, each phase's cores and each core's
result keys. The port's own record must have exactly those, ``folded``
must agree with ``float`` on every prediction, and ``float``'s deltas are
0 by construction. ``_DeviceLoader`` is held to JAX's on its batch order.
"""

import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import quality_eval as jax_quality  # noqa: E402

from multimodal_alzheimer_tpu_torch.tools import quality_eval  # noqa: E402
from torch_threads import torch_threads  # noqa: E402,F401 (autouse)

SMOKE = ["--volume-shape", "12", "14", "12", "--depth", "10",
         "--train-n", "48", "--eval-n", "32", "--epochs", "2",
         "--batch", "8", "--bootstrap", "100"]
TOP_LEVEL = {"metric", "volume_shape", "depth", "train_n", "eval_n",
             "epochs"}
CORES = {"flagship": {"float", "folded", "int8", "int8_badcalib", "fast"},
         "fusion": {"float", "folded", "int8_mri", "int8_mri_pet"}}


def _jax_result_keys(phase: str) -> set:
    """The tuple of result keys JAX's ``phase`` keeps per core (its
    ``if k in (...)`` filter)."""
    tree = ast.parse((REPO / "tools" / "quality_eval.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == phase)
    for node in ast.walk(fn):
        if (isinstance(node, ast.Compare)
                and isinstance(node.ops[0], ast.In)
                and isinstance(node.comparators[0], ast.Tuple)):
            return {ast.literal_eval(e) for e in node.comparators[0].elts}
    raise AssertionError(f"no result-key filter in {phase}")


def _jax_core_names(phase: str) -> set:
    """The core names JAX's ``phase`` puts in its ``cores`` dict (and the
    ``fast`` core it adds)."""
    tree = ast.parse((REPO / "tools" / "quality_eval.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == phase)
    names = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "cores"):
            names |= {ast.literal_eval(k) for k in node.value.keys}
        if (isinstance(node, ast.Subscript)
                and getattr(node.value, "id", None) == "cores"
                and isinstance(node.ctx, ast.Store)):
            names.add(ast.literal_eval(node.slice))
    return names


def test_the_key_lists_are_jax_s():
    assert set(quality_eval.RESULT_KEYS) == _jax_result_keys(
        "_flagship_phase") == _jax_result_keys("_fusion_phase")
    assert CORES["flagship"] == _jax_core_names("_flagship_phase")
    assert CORES["fusion"] == _jax_core_names("_fusion_phase")


def _run(capsys, argv, phases):
    record = quality_eval.main(SMOKE + argv, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == record
    assert record["metric"] == "serve_quality"
    assert set(record) == TOP_LEVEL | set(phases)
    for phase in phases:
        res = record[phase]
        assert set(res) == CORES[phase], phase
        for name, r in res.items():
            assert set(r) == set(quality_eval.RESULT_KEYS), (phase, name)
            assert r["n"] == 32 and np.isfinite(r["f1"]), (phase, name)
        assert res["float"]["delta_f1"] == 0.0
        assert res["float"]["agreement"] == 1.0
        assert res["folded"]["agreement"] == 1.0, phase
        assert res["folded"]["delta_f1"] == 0.0, phase
    return record


def test_quality_eval_flagship_smoke(capsys):
    _run(capsys, [], ["flagship"])


def test_quality_eval_fusion_smoke(capsys):
    _run(capsys, ["--fusion", "--skip-flagship"], ["fusion"])


@pytest.mark.parametrize("shuffle", [False, True])
def test_device_loader_batches_as_jax(shuffle):
    """Same batches in the same order as JAX's loader (one numpy
    permutation per epoch from the same seed), the tail dropped."""
    rng = np.random.default_rng(0)
    data = {"mri": rng.normal(size=(11, 3, 2)).astype(np.float32),
            "label": rng.integers(0, 3, 11).astype(np.int32)}
    port = quality_eval._DeviceLoader(data, 4, shuffle, seed=5,
                                      device="cpu")
    jax_loader = jax_quality._DeviceLoader(data, 4, shuffle, seed=5)
    assert len(port) == len(jax_loader) == 2
    for _ in range(2):  # two epochs: the permutation advances alike
        got, want = list(port), list(jax_loader)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for key in data:
                assert torch.equal(g[key],
                                   torch.from_numpy(np.array(w[key])))
