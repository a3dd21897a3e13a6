"""The readers of the program's own spans (``lib/spans.py`` and the
``loader_*_ms`` and ``step_*_ms`` metrics) on a small trace with a caller,
a producer and another thread: each reads its hand-computed value, the idle
readers count the caller's thread alone, and each reads nothing from a
trace without the program's spans (``trace_small.json``)."""

import json
from pathlib import Path

import pytest

from benchmark.lib import spans, spec, trace

FIXTURES = Path(__file__).parent / "fixtures"
EVENTS = json.loads((FIXTURES / "trace_spans.json").read_text())[
    "traceEvents"]
SMALL = json.loads((FIXTURES / "trace_small.json").read_text())[
    "traceEvents"]
CELLS = {"train": "anat_r18.train.b32", "fusion": "allmod_r18.train.b32"}
METRICS = ("loader_collate_ms", "loader_idle_ms", "step_idle_ms",
           "step_host_ms")

# device idle in the traced stretch [1000, 2000]: [1010, 1030],
# [1100, 1150], [1400, 1420], [1700, 1750], [1950, 2000]; two traced steps
WANT = {
    # the collates that start inside the stretch: 300 and 250 us
    "loader_collate_ms": 0.275,
    # the caller's one wait [1000, 1060] holds the gap [1010, 1030]
    "loader_idle_ms": 20 / 2 / 1e3,
    # the caller's steps hold 50 + 20 and 50 + 30 us of the gaps
    "step_idle_ms": 150 / 2 / 1e3,
    # the caller's steps last 420 and 480 us
    "step_host_ms": 0.45,
}


def _read(metric, split, events, steps=2):
    cell = spec.Cell(CELLS[split])
    return cell.reader(f"{metric}.{split}").read(
        {"trace": events, "traced_steps": steps})


def test_the_caller_is_the_traced_spans_thread():
    assert spans.caller_tid(EVENTS) == 100


def test_named_spans_start_in_the_stretch_on_the_thread_asked_for():
    assert spans.named(EVENTS, spans.STEP, 100) == [(1060.0, 1480.0),
                                                    (1500.0, 1980.0)]
    # any thread, the device row's copy of the range left out
    assert spans.named(EVENTS, spans.STEP) == [(1005.0, 1035.0),
                                               (1060.0, 1480.0),
                                               (1500.0, 1980.0)]
    # the collate that started before the stretch is not counted
    assert spans.named(EVENTS, spans.LOADER_COLLATE) == [(1200.0, 1500.0),
                                                         (1600.0, 1850.0)]


def test_device_idle_inside_intervals():
    assert spans.device_idle_us(EVENTS, [(1000.0, 2000.0)]) == \
        pytest.approx(190.0)
    assert spans.device_idle_us(EVENTS, [(1390.0, 1410.0),
                                         (1940.0, 1960.0)]) == \
        pytest.approx(20.0)
    assert spans.device_idle_us(EVENTS, []) == 0.0
    busy, span = trace.busy_idle(EVENTS)
    assert span - busy == pytest.approx(190e-6)


@pytest.mark.parametrize("split", sorted(CELLS))
@pytest.mark.parametrize("metric", METRICS)
def test_each_reader_reads_its_hand_computed_value(metric, split):
    assert _read(metric, split, EVENTS) == pytest.approx(WANT[metric])


def test_the_idle_readers_count_the_callers_thread_alone():
    # were the other thread's step [1005, 1035] and wait [1950, 2000]
    # counted, these would read 170 / 2 and 70 / 2 us
    assert _read("step_idle_ms", "train", EVENTS) == pytest.approx(0.075)
    assert _read("loader_idle_ms", "train", EVENTS) == pytest.approx(0.010)


def test_a_loader_that_never_blocked_reads_zero():
    events = [e for e in EVENTS if e["name"] != spans.LOADER_WAIT
              or e["tid"] != 100]
    assert _read("loader_idle_ms", "train", events) == 0.0


@pytest.mark.parametrize("split", sorted(CELLS))
@pytest.mark.parametrize("metric", METRICS)
def test_a_trace_without_the_programs_spans_reads_nothing(metric, split):
    assert _read(metric, split, SMALL, steps=1) is None
    assert _read(metric, split, None) is None


def test_the_breakdown_labels_the_callers_gaps_by_the_programs_spans():
    gaps = dict(trace.breakdown(EVENTS)["idle_gaps"])
    # a gap inside the backward: the shortest of the spans holding it
    assert gaps["mmalz.step.backward / idle host"] == pytest.approx(20e-6)
    # the limit of labelling by any thread's span: the producer's decode
    # takes a gap of the caller's forward
    assert gaps["mmalz.loader.decode / idle host"] == pytest.approx(50e-6)
