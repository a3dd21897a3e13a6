"""The port's spans (``utils.profiling.span``) on the CPU: where the loader's
and the train step's ``mmalz.*`` ranges land in a ``torch.profiler`` trace
that records every thread, as the benchmark's traced runs take it, and that
they change no arithmetic.

The loader's producer thread records ``mmalz.loader.decode`` and
``.collate`` once a batch; the consumer alone records
``mmalz.loader.wait``, only when no batch was ready; a train step records
``mmalz.step`` holding its five phases in order.
"""

import contextlib
import glob
import json
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from multimodal_alzheimer_tpu_torch.data.pipeline import DataLoader
from multimodal_alzheimer_tpu_torch.data.synthetic import ArrayDataset
from multimodal_alzheimer_tpu_torch.losses.classification import (
    make_criterion,
)
from multimodal_alzheimer_tpu_torch.parallel.mesh import (
    make_mesh,
    shard_batch,
)
from multimodal_alzheimer_tpu_torch.train.state import (
    TrainState,
    make_train_step,
)
from multimodal_alzheimer_tpu_torch.utils.profiling import span, trace
from torch_threads import torch_threads  # noqa: F401 (autouse)

PHASES = ["mmalz.step.preprocess", "mmalz.step.forward", "mmalz.step.loss",
          "mmalz.step.backward", "mmalz.step.optimizer"]


def _profiler():
    """A CPU profiler over every thread, as the benchmark runs it."""
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=config)


def _events(prof, tmp_path) -> list:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _spans(events, prefix="mmalz.") -> list:
    """The program's spans, sorted by start."""
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith(prefix)), key=lambda e: e["ts"])


def _names(spans) -> list:
    return [e["name"] for e in spans]


class SlowDataset(ArrayDataset):
    """An in-memory dataset whose rows take ``delay`` seconds each."""

    def __init__(self, n: int, delay: float = 0.0):
        rng = np.random.default_rng(0)
        super().__init__({"label": np.arange(n, dtype=np.int64) % 3,
                          "x": rng.normal(size=(n, 6)).astype(np.float32)})
        self.delay = delay

    def __getitem__(self, i):
        if self.delay:
            time.sleep(self.delay)
        return super().__getitem__(i)


def test_span_records_nothing_without_a_profiler():
    assert isinstance(span("mmalz.step"), contextlib.nullcontext)


def test_span_is_a_record_function_under_the_profiler():
    with _profiler():
        assert isinstance(span("mmalz.step"),
                          torch.profiler.record_function)
    assert isinstance(span("mmalz.step"), contextlib.nullcontext)


@pytest.mark.parametrize("n,batch,pad_last", [(12, 4, False), (10, 4, True),
                                              (10, 4, False)])
def test_decode_and_collate_once_a_batch_on_the_producer(tmp_path, n, batch,
                                                          pad_last):
    loader = DataLoader(SlowDataset(n), batch, num_workers=2, device="cpu",
                        pad_last=pad_last)
    with _profiler() as prof:
        batches = list(loader)
    spans = _spans(_events(prof, tmp_path))
    consumer = threading.get_native_id()
    for name in ("mmalz.loader.decode", "mmalz.loader.collate"):
        mine = [e for e in spans if e["name"] == name]
        assert len(mine) == len(batches) == len(loader), name
        assert all(e["tid"] != consumer for e in mine), name
    # each batch decodes, then collates (the padding and the mask in it)
    producer = [e for e in spans if e["name"] != "mmalz.loader.wait"]
    assert _names(producer) == ["mmalz.loader.decode",
                                "mmalz.loader.collate"] * len(batches)
    if pad_last:
        assert batches[-1]["sample_mask"].tolist() == [1, 1, 0, 0]


def test_a_producer_started_before_the_profiler_is_recorded(tmp_path):
    loader = iter(DataLoader(SlowDataset(20), 4, num_workers=2,
                             device="cpu", prefetch=1))
    next(loader)  # the producer thread runs before the profiler starts
    with _profiler() as prof:
        rest = list(loader)
    collate = [e for e in _spans(_events(prof, tmp_path))
               if e["name"] == "mmalz.loader.collate"]
    assert 1 <= len(collate) <= len(rest) == 4
    assert all(e["tid"] != threading.get_native_id() for e in collate)


def test_wait_only_on_the_consumer_and_only_when_no_batch_is_ready(
        tmp_path):
    loader = DataLoader(SlowDataset(8, delay=0.01), 4, num_workers=1,
                        device="cpu")
    with _profiler() as prof:
        list(loader)
    waits = [e for e in _spans(_events(prof, tmp_path))
             if e["name"] == "mmalz.loader.wait"]
    assert waits, "the consumer outran a 40 ms decode without waiting"
    assert {e["tid"] for e in waits} == {threading.get_native_id()}


def test_no_wait_span_when_the_batches_are_ready(tmp_path):
    loader = iter(DataLoader(SlowDataset(8), 4, num_workers=1, device="cpu",
                             prefetch=2))
    deadline = time.monotonic() + 10
    first = next(loader)
    # both batches queued: the rest of the epoch is taken without waiting
    while loader.gi_frame is not None and time.monotonic() < deadline:
        out_q = loader.gi_frame.f_locals["out_q"]
        if out_q.qsize() == 2:  # the second batch and the end mark
            break
        time.sleep(0.005)
    with _profiler() as prof:
        rest = list(loader)
    assert len(rest) == 1 and first["label"].shape == (4,)
    assert not [e for e in _spans(_events(prof, tmp_path))
                if e["name"] == "mmalz.loader.wait"]


class Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.body = torch.nn.Sequential(torch.nn.Linear(6, 8),
                                        torch.nn.BatchNorm1d(8),
                                        torch.nn.ReLU(),
                                        torch.nn.Linear(8, 3))

    def forward(self, batch):
        logits = self.body(batch["x"])
        return {"logits": logits, "embeddings": logits}


def _preprocess(batch):
    return dict(batch, x=(batch["x"] - 0.5) * 2.0)


def _two_steps(profiled: bool, tmp_path=None, mesh=None):
    """(losses, parameters, the trace's events or None) of two steps of a
    tiny model from seed 0."""
    torch.manual_seed(0)
    model = Tiny()
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = make_train_step(model, make_criterion(
        {"loss_class_weights": [0.4, 0.3, 0.3]}), optimizer, _preprocess,
        mesh=mesh)
    state = TrainState(model, optimizer)
    data = SlowDataset(16).data
    batches = [{k: torch.from_numpy(v[i * 8:(i + 1) * 8])
                for k, v in data.items()} for i in range(2)]
    if mesh is not None:
        batches = [shard_batch(b, mesh) for b in batches]
    losses = []
    with (_profiler() if profiled else contextlib.nullcontext()) as prof:
        for b in batches:
            state, aux = step(state, b)
            losses.append(aux["loss"])
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return losses, params, _events(prof, tmp_path) if profiled else None


def _assert_two_steps_with_their_phases(events):
    spans = _spans(events, "mmalz.step")
    steps = [e for e in spans if e["name"] == "mmalz.step"]
    assert len(steps) == 2
    for s in steps:
        inside = [e for e in spans if e is not s and s["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= s["ts"] + s["dur"]]
        assert _names(inside) == PHASES
        assert {e["tid"] for e in inside} == {s["tid"]}
        # the phases follow one another
        for a, b in zip(inside, inside[1:]):
            assert a["ts"] + a["dur"] <= b["ts"]


def test_a_train_step_holds_its_five_phases_in_order(tmp_path):
    _, _, events = _two_steps(True, tmp_path)
    _assert_two_steps_with_their_phases(events)


def test_the_spans_change_no_arithmetic(tmp_path):
    plain_losses, plain_params, _ = _two_steps(False)
    traced_losses, traced_params, _ = _two_steps(True, tmp_path)
    for a, b in zip(plain_losses, traced_losses):
        assert torch.equal(a, b)
    assert plain_params.keys() == traced_params.keys()
    for k, v in plain_params.items():
        assert torch.equal(v, traced_params[k]), k


@pytest.fixture
def one_rank_mesh(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_the_mesh_all_reduces_fall_in_the_optimizer_phase(tmp_path,
                                                          one_rank_mesh):
    losses, params, events = _two_steps(True, tmp_path, one_rank_mesh)
    _assert_two_steps_with_their_phases(events)
    optimizer = [e for e in _spans(events, "mmalz.step.optimizer")]
    reduces = [e for e in events if e.get("cat") == "cpu_op"
               and "allreduce" in e["name"]
               and e["tid"] == optimizer[0]["tid"]]
    assert reduces
    # the gradients' and the loss's all-reduces: two a step, in its phase
    for phase in optimizer:
        within = [e for e in reduces if phase["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= phase["ts"] + phase["dur"]]
        assert len(within) >= 2
    # a one-rank mesh steps as the mesh-free step does, bit for bit
    plain_losses, plain_params, _ = _two_steps(False)
    for a, b in zip(plain_losses, losses):
        assert torch.equal(a, b)
    for k, v in plain_params.items():
        assert torch.equal(v, params[k]), k


def test_trace_writes_the_producers_spans(tmp_path):
    loader = DataLoader(SlowDataset(8), 4, num_workers=2, device="cpu")
    with trace(str(tmp_path)):
        list(loader)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1, "no trace written"
    with open(files[0]) as f:
        collate = [e for e in _spans(json.load(f)["traceEvents"])
                   if e["name"] == "mmalz.loader.collate"]
    assert len(collate) == 2
    assert all(e["tid"] != threading.get_native_id() for e in collate)
