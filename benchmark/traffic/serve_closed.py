"""Traffic kind ``serve_closed``: concurrent clients in a closed loop
against the program's ``BatchingServer``.

Set-up draws the weights and two calibration batches from the seed, builds
the int8 core behind ``Predictor`` and ``BatchingServer``, warms every rung
of the ladder, and runs the clients for ``warm_seconds``. In the window
``clients`` threads each keep ``depth`` raw requests in flight: a client
submits, and when its oldest request resolves it submits the next. A
request's latency runs from its ``submit`` call to its future resolving.
Requests walk a host pool of distinct raw scans drawn from the seed.

Mix parameters (``traffic/<mix>.json``): ``clients``, ``depth``, ``pool``,
``batch`` and ``ladder`` (the predictor's rungs), ``max_wait_s`` (null: the
server's default), ``warm_seconds``, ``trace_seconds``,
``calibration`` ({"batches", "batch"}), ``check_requests`` (how many
answers of the window the reference checks, drawn from the seed).
"""

from __future__ import annotations

import gc
import threading
import time
from collections import deque

import numpy as np
import torch

from benchmark.lib import compare, inputs, port, window
from benchmark.lib.trace import Profiled
from benchmark.reference import int8 as ref_int8
from benchmark.reference import nets

TRACE_AT = 0.4
RESULT_TIMEOUT_S = 120.0


class Clients:
    """``clients`` threads, each keeping ``depth`` requests in flight until
    ``stop()``; every request's (pool index, submitted, resolved, submit
    seconds, answer or exception) is kept."""

    def __init__(self, server, requests: list, clients: int, depth: int):
        self.server, self.requests = server, requests
        self.depth = depth
        self.records: list = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._client, args=(c,
                                                                      clients),
                                          daemon=True)
                         for c in range(clients)]
        self.errors: list = []

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(RESULT_TIMEOUT_S)
        if any(t.is_alive() for t in self._threads):
            raise RuntimeError("a client did not finish its requests")
        if self.errors:
            raise self.errors[0]

    def _client(self, c: int, stride: int) -> None:
        try:
            inflight: deque = deque()
            k = c
            while not self._stop.is_set() or inflight:
                while not self._stop.is_set() and len(inflight) < self.depth:
                    idx = k % len(self.requests)
                    k += stride
                    rec = [idx, time.perf_counter(), None, 0.0, None]
                    fut = self.server.submit(self.requests[idx])
                    rec[3] = time.perf_counter() - rec[1]
                    fut.add_done_callback(
                        lambda f, rec=rec: rec.__setitem__(
                            2, time.perf_counter()))
                    inflight.append((rec, fut))
                rec, fut = inflight.popleft()
                try:
                    res = fut.result(RESULT_TIMEOUT_S)
                    rec[4] = (res["logits"], res["probs"])
                except Exception as exc:  # a failed request counts as failed
                    rec[4] = exc
                with self._lock:
                    self.records.append(rec)
        except Exception as exc:  # surfaced by stop()
            self.errors.append(exc)


def admit(cell) -> None:
    """Refuse, when the cell is loaded, a backbone whose blocks the int8
    rule does not take (ValueError)."""
    ref_int8.check(cell.backbone)


def calibration(seed: int, mix: dict, grid, device) -> list:
    """The calibration batches: raw scans drawn from their own stream."""
    g = inputs.generator(seed, "calibration", device)
    out = []
    for _ in range(mix["calibration"]["batches"]):
        mri, mask = inputs.brain_scans(g, mix["calibration"]["batch"], grid,
                                       "mri", device)
        out.append({"mri": mri, "mri_mask": mask})
    return out


class Session:
    def __init__(self, cell, seed: int, device, overrides: dict):
        cfg, mix = cell.config, cell.traffic
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.layers = cell.backbone.LAYERS
        self.grid = tuple(overrides.get("grid", cfg["grid"]))
        self.pool = inputs.host_pool(seed, overrides.get("pool", mix["pool"]),
                                     self.grid, ["mri"], cfg["n_classes"],
                                     device)
        self.requests = [{"mri": self.pool["mri"][i],
                          "mri_mask": self.pool["mri_mask"][i]}
                         for i in range(len(self.pool["label"]))]
        template = {}

        def weights(t):
            template.update({k: torch.empty(v.shape, dtype=v.dtype,
                                            device="meta")
                             for k, v in t.items()})
            return inputs.make_weights(t, seed, device, cfg)

        self.batch = overrides.get("batch", mix["batch"])
        self.ladder = overrides.get("ladder", mix["ladder"])
        self.predictor, self.server = port.build_int8_serve(
            cfg, device, weights, calibration(seed, mix, self.grid, device),
            self.batch, self.ladder, mix.get("max_wait_s"))
        self.template = template
        self.clients = mix["clients"]
        self.depth = mix["depth"]
        example = {k: v[:1] for k, v in self.pool.items() if k != "label"}
        self.predictor.warmup(example, parts=True)
        self.burst(overrides.get("warm_seconds", mix["warm_seconds"]))

    def burst(self, seconds: float) -> Clients:
        clients = Clients(self.server, self.requests, self.clients,
                          self.depth)
        clients.start()
        time.sleep(seconds)
        clients.stop()
        return clients

    def counters(self) -> tuple:
        return (self.server.batches_served, self.server.samples_served,
                dict(self.server.batch_histogram))

    def close(self) -> None:
        self.server.close()
        del self.server, self.predictor
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference(session: Session, indices, bits: int = 8) -> dict:
    """The reference's answers to the pool's requests ``indices``: its own
    int8 model from the same seed's weights and calibration batches, in
    blocks of ``batch`` scans."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = session.device
    P = inputs.make_weights(session.template, session.seed, device,
                            session.cfg)
    spec = session.cfg["preprocess"]["serve"]
    with torch.no_grad():
        calib = [nets.preprocess(spec, b)["mri"][:, None]
                 for b in calibration(session.seed, session.mix,
                                      session.grid, device)]
        folded = ref_int8.fold(P, session.layers)
        qmodel = ref_int8.quantize(
            folded, session.layers,
            ref_int8.calibrate(folded, session.layers, calib), bits)
        out = {"logits": [], "probs": []}
        idx = list(indices)
        for i in range(0, len(idx), session.batch):
            block = idx[i:i + session.batch]
            raw = {k: torch.from_numpy(session.pool[k][block]).to(device)
                   for k in ("mri", "mri_mask")}
            x = nets.preprocess(spec, raw)["mri"][:, None]
            res = ref_int8.head(P, ref_int8.backbone(qmodel, x))
            for k in out:
                out[k].append(res[k])
    return {k: torch.cat(v) for k, v in out.items()}


def check(session: Session, records: list, count: int, bits: int = 8):
    """(numbers, checked): the answers of ``count`` requests drawn from
    the seed among ``records`` against the reference's."""
    if not records:  # no answer came: nothing is shown correct
        return {"logit_gap": float("inf"), "prob_gap": float("inf")}, 0
    rng = np.random.default_rng(inputs.stream_seed(session.seed, "check"))
    pick = rng.choice(len(records), size=min(count, len(records)),
                      replace=False)
    chosen = [records[i] for i in sorted(pick)]
    ref = reference(session, [r[0] for r in chosen], bits)
    prog = {"logits": torch.tensor(np.stack([r[4][0] for r in chosen])),
            "probs": torch.tensor(np.stack([r[4][1] for r in chosen]))}
    ref = {k: v.cpu() for k, v in ref.items()}
    return compare.serve_numbers(prog, ref), len(chosen)


def run(cell, env) -> dict:
    device = env.device
    session = Session(cell, env.seed, device, env.overrides)
    mix = cell.traffic
    clients = Clients(session.server, session.requests, session.clients,
                      session.depth)
    prof = Profiled() if env.trace else None
    traced = None
    before = session.counters()
    host = window.HostUsage()
    t0 = time.perf_counter()
    setup_s = time.time() - env.started
    clients.start()
    if prof is not None:
        time.sleep(TRACE_AT * env.seconds)
        at_start = session.counters()
        prof.start()
        time.sleep(mix["trace_seconds"])
        prof.stop()
        traced = (at_start, session.counters())
    time.sleep(max(0.0, t0 + env.seconds - time.perf_counter()))
    t1 = time.perf_counter()
    after = session.counters()
    window_host = host.since(t1 - t0)
    clients.stop()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    done = [r for r in clients.records if t0 <= r[2] <= t1]
    ok = [r for r in done if not isinstance(r[4], Exception)]
    failed = sum(isinstance(r[4], Exception) for r in clients.records)
    attempted = sum(r[1] <= t1 for r in clients.records)
    latencies = window.completed_in(((r[1], r[2]) for r in ok), t0, t1)
    stage_ms = 1e3 * float(np.mean([r[3] for r in clients.records
                                    if r[1] <= t1]))
    trace = prof.collect() if prof is not None else None
    session.close()
    numbers, checked = check(session, ok, mix["check_requests"])
    out = {
        "end_to_end": {
            "serve_scans_per_s": window.rate(len(ok), t1 - t0),
            "serve_p95_ms": (1e3 * window.percentile(latencies, 95)
                             if latencies else None),
        },
        "attempted": attempted, "failed": failed, "numbers": numbers,
        "memory_peak_bytes": peak, "setup_s": setup_s,
        "ctx": {"kind": "serve", "config": cell.config, "mix": mix,
                "batch": session.batch, "ladder": session.ladder,
                "grid": session.grid, "stage_ms": stage_ms,
                "window": (before, after), "checked": checked,
                "window_host": dict(window_host, stage_ms=stage_ms),
                "scans_per_s": window.rate(len(ok), t1 - t0)},
    }
    if traced is not None:
        out["ctx"]["traced_counters"] = traced
        out["trace"] = trace
    return out
