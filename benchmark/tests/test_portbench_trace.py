"""The trace readers on a small recorded-style trace: the traced window,
the union of device intervals, kernel sums by name pattern, the breakdown,
and the per-layer metric readers."""

import json
from pathlib import Path

import pytest

from benchmark.lib import readers, spec, trace, yardstick

EVENTS = json.loads((Path(__file__).parent / "fixtures" /
                     "trace_small.json").read_text())["traceEvents"]


def test_traced_window_and_union():
    assert trace.traced_window(EVENTS) == (1000.0, 2000.0)
    busy, span = trace.busy_idle(EVENTS)
    # [1000, 1700] and [1800, 1950]; the kernels outside the window and the
    # part of one before it do not count
    assert busy == pytest.approx(850e-6)
    assert span == pytest.approx(1000e-6)


def test_union_of_overlapping_intervals():
    assert trace.union_us([(0, 10), (5, 20), (30, 40), (35, 36)]) == 30
    assert trace.union_us([]) == 0


def test_kernel_sums_by_pattern_leave_out_the_library():
    dev = trace.device_events(EVENTS, trace.traced_window(EVENTS))
    bn = ("::reduce_kernel<", "::apply_kernel<", "::dx_kernel<")
    seconds, launches = trace.kernel_seconds(dev, bn, readers.NOT_PORT)
    assert launches == 4
    assert seconds == pytest.approx(350e-6)


def test_breakdown_names_device_ops_and_idle_gaps():
    b = trace.breakdown(EVENTS)
    assert b["device_ops"][0][1] == pytest.approx(250e-6)
    gaps = dict(b["idle_gaps"])
    assert gaps["portbench.step / aten::copy_"] == pytest.approx(100e-6)
    assert gaps["portbench.step / cudaStreamSynchronize"] == pytest.approx(
        50e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def _cell(name):
    return spec.Cell(name)


def _train_ctx(cell):
    c = _cell(cell)
    return {"config": c.config, "regime": c.traffic["regime"], "batch": 32,
            "grid": tuple(c.config["grid"]), "dtype": "torch.bfloat16",
            "bench_dir": spec.BENCH_DIR,
            "traced_steps": 1, "trace": EVENTS, "loader_wait_ms": 0.5,
            "samples_per_s": 100.0}


def test_bn_roofline_reader():
    ctx = _train_ctx("anat_r18.train.b32")
    got = _cell("anat_r18.train.b32").reader("bn_roofline.train").read(ctx)
    bound = readers.bn_step_bound_s(ctx, ("bn_stats", "bn_apply",
                                          "bn_grad_sum", "bn_dx"))
    assert got == pytest.approx(100 * bound / 350e-6)


def test_frozen_towers_count_k4_k5_once():
    ctx = _train_ctx("allmod_r18.train_frozen.b32")
    trained = dict(ctx, regime={"lr_pretrained": 1e-5})
    frozen = readers.bn_step_bound_s(ctx, ("bn_stats", "bn_apply"))
    both = readers.bn_step_bound_s(trained, ("bn_stats", "bn_apply"))
    assert both == pytest.approx(2 * frozen)


def test_preprocess_and_conv_readers():
    ctx = _train_ctx("anat_r18.train.b32")
    cell = _cell("anat_r18.train.b32")
    k3 = yardstick.norm_bound_s(32, 91 * 109 * 91)["zscore"]
    assert cell.reader("preprocess_roofline.train").read(ctx) == \
        pytest.approx(100 * k3 / 50e-6)
    # conv time: the clipped fprop (50), the wgrad (250), the transpose (50)
    flops = yardstick.conv_flops_per_sample(ctx["config"],
                                            spec.BENCH_DIR) * 32
    assert cell.reader("conv_roofline.train").read(ctx) == pytest.approx(
        100 * flops / yardstick.BF16_FLOP_PER_S / 350e-6)
    assert cell.reader("device_idle.train").read(ctx) == pytest.approx(15.0)
    assert cell.reader("mfu.train").read(ctx) == pytest.approx(
        100 * yardstick.conv_flops_per_sample(ctx["config"], spec.BENCH_DIR)
        * 100.0
        / yardstick.BF16_FLOP_PER_S)


def test_serve_readers_weight_rungs_by_the_histogram():
    c = _cell("anat_r18.serve_int8.c64")
    counters = ((0, 0, {32: 10, 3: 1}), (4, 100, {32: 13, 3: 2}))
    ctx = {"config": c.config, "grid": (91, 109, 91), "batch": 32,
           "bench_dir": spec.BENCH_DIR,
           "ladder": [8], "trace": EVENTS, "traced_counters": counters,
           "window": ((0, 0, {}), (10, 300, {})), "scans_per_s": 1000.0,
           "stage_ms": 2.0}
    assert readers.rung_weights(ctx, counters) == {32: 0.75, 8: 0.25}
    convs = yardstick.backbone_convs(c.config, spec.BENCH_DIR)
    per_launch = (0.75 * yardstick.k9_forward_bound_s(convs, 32)
                  + 0.25 * yardstick.k9_forward_bound_s(convs, 8)) / 20
    assert c.reader("k9_roofline.serve").read(ctx) == pytest.approx(
        100 * 2 * per_launch / 100e-6)
    # K1 and K2 ran outside the traced window: nothing to read
    assert c.reader("preprocess_roofline.serve").read(ctx) is None
    assert c.reader("server_batch_fill.serve").read(ctx) == pytest.approx(
        100 * 300 / (10 * 32))
    assert c.reader("stage_ms.serve").read(ctx) == 2.0


def test_a_reader_without_a_trace_reads_nothing():
    ctx = dict(_train_ctx("anat_r18.train.b32"), trace=None)
    cell = _cell("anat_r18.train.b32")
    for name in ("bn_roofline.train", "conv_roofline.train",
                 "preprocess_roofline.train", "device_idle.train"):
        assert cell.reader(name).read(ctx) is None
