"""The port's fast-mode study
(``multimodal_alzheimer_tpu_torch/tools/fast_mode_study.py``) against the
JAX package's root ``tools/fast_mode_study.py``, both on the CPU at the JAX
tool's smoke flags.

The seeds' draws differ by design (torch generators where JAX folds keys,
ROADMAP section C), so the values are not compared: both JSON lines must
have the same keys, per arch the same keys and list lengths, and every
number finite. The flags and their defaults are JAX's.
"""

import contextlib
import io
import json
import math
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import fast_mode_study as jax_study  # noqa: E402

from multimodal_alzheimer_tpu_torch.tools import (  # noqa: E402
    fast_mode_study,
)
from torch_threads import torch_threads  # noqa: E402,F401 (autouse)

SMOKE = ["--volume-shape", "12", "14", "12", "--depth", "10", "--seeds",
         "2", "--train-n", "32", "--eval-n", "16", "--epochs", "2",
         "--batch", "8"]
ARCHES = ("dilated", "fast")


@pytest.fixture(scope="module")
def lines():
    """(the port's record, JAX's record) at the smoke flags."""
    capture = _Capture()
    return (capture.run(lambda argv: fast_mode_study.main(argv,
                                                          device="cpu")),
            capture.run(jax_study.main))


class _Capture:
    """stdout and stderr of a main, outside pytest's per-test capture (the
    fixture is module-scoped)."""

    def run(self, main) -> tuple:
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            main(SMOKE)
        return out.getvalue(), err.getvalue()


def _record(text: str) -> dict:
    lines = text.strip().splitlines()
    assert len(lines) == 1, text  # ONE JSON line on stdout
    return json.loads(lines[0])


def _numbers(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _numbers(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _numbers(v)
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield tree


def test_the_flags_and_defaults_are_jax_s():
    mine = fast_mode_study._parser().parse_args([])
    theirs = {a.dest: a.default for a in _jax_actions()}
    assert vars(mine) == {k: v for k, v in theirs.items() if k != "help"}


def _jax_actions():
    """The argparse actions of JAX's main, read by running its parser
    setup on a stub that stops before any work."""
    import argparse

    seen = []
    real = argparse.ArgumentParser.parse_args

    def stop(self, argv=None, namespace=None):
        seen.extend(self._actions)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = stop
    try:
        with pytest.raises(SystemExit):
            jax_study.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen


def test_json_lines_match_jax_s_keys_and_lengths(lines):
    (port_out, port_err), (jax_out, jax_err) = lines
    port, theirs = _record(port_out), _record(jax_out)
    assert port["metric"] == theirs["metric"] == "fast_mode_convergence"
    assert set(port) == set(theirs)
    for key in set(port) - set(ARCHES):
        assert port[key] == theirs[key], key
    for arch in ARCHES:
        assert set(port[arch]) == set(theirs[arch]), arch
        for key, value in theirs[arch].items():
            if isinstance(value, (list, dict)):
                assert len(port[arch][key]) == len(value), (arch, key)
                if isinstance(value, dict):
                    assert set(port[arch][key]) == set(value), (arch, key)
    for err in (port_err, jax_err):
        assert all(f"{arch}: best val loss" in err for arch in ARCHES)
        assert "verdict: fast - dilated eval F1 delta" in err


@pytest.mark.parametrize("which", ["port", "jax"])
def test_every_number_is_finite(lines, which):
    out = lines[0 if which == "port" else 1][0]
    numbers = list(_numbers(_record(out)))
    assert numbers and all(math.isfinite(v) for v in numbers)


def test_cpu_bfloat16_conv_runs_in_float32():
    """The strided arch's layer-3/4 convs see 1-voxel maps at the smoke
    size, where oneDNN's bfloat16 conv3d backward returns NaN weight
    gradients at random; ``models.layers.Conv3d`` runs such a bfloat16 conv
    on the CPU in float32 on the rounded operands and rounds once (XLA's
    CPU lowering), forward and backward: the output and the cotangents of
    x and the weight are the float32 conv's, rounded to bfloat16."""
    import torch
    import torch.nn.functional as F

    from multimodal_alzheimer_tpu_torch.models.layers import Conv3d

    gen = torch.Generator().manual_seed(0)
    conv = Conv3d(256, 512, 3, stride=2, padding=1, bias=False,
                  compute_dtype=torch.bfloat16)
    conv.weight.data.normal_(0, 0.02, generator=gen)
    x = torch.randn(8, 256, 1, 1, 1, generator=gen).requires_grad_(True)
    g = torch.randn(8, 512, 1, 1, 1, generator=gen).to(torch.bfloat16)
    y = conv(x)
    y.backward(g)
    xr = x.detach().to(torch.bfloat16).float().requires_grad_(True)
    wr = conv.weight.detach().to(torch.bfloat16).float().requires_grad_(True)
    want = F.conv3d(xr, wr, None, 2, 1)
    want.to(torch.bfloat16).backward(g)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, want.to(torch.bfloat16))
    assert torch.isfinite(conv.weight.grad).all()
    # the cotangents come back through the casts: rounded to bfloat16
    for got, ref in ((conv.weight.grad, wr.grad), (x.grad, xr.grad)):
        torch.testing.assert_close(got, ref.to(torch.bfloat16).float(),
                                   rtol=0, atol=0)
