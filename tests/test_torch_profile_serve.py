"""The serving profile's trace arithmetic, on hand-made Chrome traces.

The script itself needs an NVIDIA GPU; what it computes from a trace
(device busy time inside each call's span, idle share, time by kind) is
checked here.
"""

import pytest

from multimodal_alzheimer_tpu_torch.tools import profile_serve as ps
from torch_threads import torch_threads  # noqa: F401 (autouse)


def _span(ts, dur):
    return {"name": ps.SPAN, "cat": "user_annotation", "ts": ts, "dur": dur}


def _dev(name, ts, dur, cat="kernel"):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur}


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0),
    ([(0, 1000)], 1.0),
    ([(0, 1000), (500, 1500)], 1.5),  # overlap counted once
    ([(0, 1000), (200, 300)], 1.0),  # nested
    ([(2000, 2500), (0, 1000)], 1.5),  # unsorted, disjoint
])
def test_union_ms(intervals, want):
    assert ps.union_ms(intervals) == pytest.approx(want)


@pytest.mark.parametrize("event, want", [
    (_dev("keys_kernel(float const*, float const*)", 0, 1), "K1"),
    (_dev("digit_pick_kernel(unsigned int const*)", 0, 1), "K1"),
    (_dev("minmax_apply_kernel(float const*)", 0, 1), "K2"),
    (_dev("select_cluster_kernel(float const*, float const*)", 0, 1), "K1"),
    (_dev("int8_conv3d_kernel<true>(signed char const*)", 0, 1), "K9"),
    (_dev("vectorized_elementwise_kernel<4, round_kernel_cuda>", 0, 1),
     "requant"),
    (_dev("vectorized_elementwise_kernel<4, launch_clamp_scalar>", 0, 1),
     "requant"),
    (_dev("vectorized_elementwise_kernel<4, MulFunctor<float>>", 0, 1),
     "other"),
    (_dev("direct_copy_kernel_cuda", 0, 1), "copy"),
    (_dev("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32", 0, 1),
     "conv_gemm"),
    (_dev("void cudnn::ops::nchwToNhwcKernel", 0, 1), "other"),
    (_dev("max_pool3d_with_indices_single_out_frame", 0, 1), "pooling"),
    (_dev("Memcpy DtoH (Device -> Pinned)", 0, 1, "gpu_memcpy"), "memory"),
    (_dev("Memset (Device)", 0, 1, "gpu_memset"), "memory"),
])
def test_kind(event, want):
    assert ps.kind(event) == want


def test_breakdown_clips_device_time_to_each_call():
    trace = {"traceEvents": [
        _span(0, 10_000), _span(20_000, 10_000),
        {"name": "aten::conv3d", "cat": "cpu_op", "ts": 1, "dur": 5},
        _dev("keys_kernel", 1_000, 1_000),
        _dev("sm80_xmma_fprop", 1_500, 4_000),  # overlaps keys_kernel
        _dev("minmax_apply_kernel", 9_000, 2_000),  # runs past the span
        _dev("sm80_xmma_fprop", 21_000, 6_000),
        _dev("Memcpy DtoH", 27_000, 1_000, "gpu_memcpy"),
        _dev("sm80_xmma_fprop", 40_000, 1_000),  # outside every span
    ]}
    got = ps.breakdown(trace, calls=2)
    assert got["host_ms"] == [10.0, 10.0]
    assert got["busy_ms"] == pytest.approx([5.5, 7.0])
    assert got["idle_share"] == pytest.approx(1 - 12.5 / 20)
    assert got["kind_ms"] == pytest.approx(
        {"K1": 0.5, "K2": 0.5, "conv_gemm": 5.0, "memory": 0.5})
    assert sum(got["share"].values()) == pytest.approx(1.0)
    assert list(got["kernels_ms"])[0] == "sm80_xmma_fprop"


def test_breakdown_refuses_a_trace_without_device_time():
    trace = {"traceEvents": [_span(0, 10)]}
    with pytest.raises(RuntimeError, match="no device events"):
        ps.breakdown(trace, calls=1)
    with pytest.raises(RuntimeError, match="spans"):
        ps.breakdown(trace, calls=2)
