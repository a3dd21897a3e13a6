"""K9's fused epilogue (``ops/int8_conv.int8_conv3d_fused``) on the CPU.

The plain fused op equals, bit for bit, the unfused composition the int8
graph ran before the fusion: ``int8_conv3d_plain``, then ``_Int8Ctx``'s
torch operations in ``_backbone_forward``'s order (``+`` the residual, an
int8 one through ``_Int8Ctx.dequant``; ``F.relu``; ``_Int8Ctx.requant``).
Every residual kind (none, float32, int8) with and without ReLU, to float32
and to int8, over the geometries of ``test_torch_quantize.CONV_CASES``. The
output scale clamps the largest values, so the requant's clamp and its
rounding are both reached. The wrapper refuses residuals it cannot take.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_alzheimer_tpu_torch.inference import quantize as Q
from multimodal_alzheimer_tpu_torch.ops import int8_conv
from test_torch_quantize import CONV_CASES
from torch_threads import torch_threads  # noqa: F401 (autouse)

MODES = [(residual, relu, out)
         for residual in (None, "float32", "int8")
         for relu in (False, True)
         for out in ("float32", "int8")]


def _operands(case, seed):
    cin, f, kernel, stride, dilation, pads = case
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 9, 10, 8, cin))
                         .astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (f, cin) + kernel)
                          .astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, f).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=f).astype(np.float32))
    return (x, int8_conv.pack_weight(wq), scale, bias,
            (kernel, stride, dilation, pads), rng)


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "-".join(map(str, m)))
@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_fused_plain_equals_the_unfused_composition(case, mode):
    residual_kind, relu, out = mode
    x, w, scale, bias, args, rng = _operands(case, seed=len(case[2]) * 7
                                             + case[0])
    v = int8_conv.int8_conv3d_plain(x, w, scale, bias, *args)
    amax = float(v.abs().max())
    scales = {"res": amax / 127, "out": amax / 2 / 127}
    ctx = Q._Int8Ctx(scales)
    kw = {"relu": relu}
    want = v
    if residual_kind == "float32":
        kw["residual"] = torch.from_numpy(
            (rng.normal(size=v.shape) * amax / 4).astype(np.float32))
        want = want + kw["residual"]
    elif residual_kind == "int8":
        kw["residual"] = torch.from_numpy(
            rng.integers(-127, 128, v.shape).astype(np.int8))
        kw["residual_scale"] = scales["res"]
        want = want + ctx.dequant("res", kw["residual"])
    if relu:
        want = F.relu(want)
    if out == "int8":
        kw["out_scale"] = scales["out"]
        want = ctx.requant("out", want)
        assert 0 < int((want.abs() == 127).sum()) < want.numel()
    got = int8_conv.int8_conv3d_fused(x, w, scale, bias, *args, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_fused_refusals():
    x, w, scale, bias, args, _ = _operands(CONV_CASES[2], seed=3)
    out = int8_conv.int8_conv3d(x, w, scale, bias, *args)
    with pytest.raises(TypeError, match="residual"):
        int8_conv.int8_conv3d_fused(x, w, scale, bias, *args,
                                    residual=out.double())
    with pytest.raises(ValueError, match="residual"):
        int8_conv.int8_conv3d_fused(x, w, scale, bias, *args,
                                    residual=out[:1])
    with pytest.raises(ValueError, match="residual"):
        int8_conv.int8_conv3d_fused(x, w, scale, bias, *args,
                                    residual=out.transpose(1, 2))
