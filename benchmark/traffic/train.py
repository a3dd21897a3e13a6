"""Traffic kind ``train``: the program's train step fed by its loader.

Set-up builds one train step (model, optimizer, loss, preprocess) with the
weights drawn from the seed, and one loader over a host pool of distinct
samples drawn from the seed. The first ``warmup_steps`` steps go through
that loader and step; the first three are the ones the reference follows.
The window then dispatches steps with no per-step synchronise for
``--seconds`` and ends at a synchronise after the last step.

Mix parameters (``traffic/<mix>.json``): ``batch``, ``pool`` (a multiple of
``batch``, at least three batches), ``loader_threads``, ``warmup_steps``,
``trace_steps`` (the traced stretch), ``regime`` (``lr_pretrained``: the
towers' rate, or null for frozen towers). The raw volumes reach the loader
in float32, as the program's dataset hands them over by default.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.lib import compare, inputs, port, window
from benchmark.lib.trace import Profiled
from benchmark.reference import train as ref_train

CHECKED_STEPS = 3
TRACE_AT = 0.4  # the traced stretch starts this far into the window


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def feature_stats(rows: np.ndarray) -> tuple:
    """Per-feature mean and biased std in float64, a constant feature's
    std 1 (the configuration's standardisation)."""
    rows = np.asarray(rows, np.float64)
    std = rows.std(0)
    return rows.mean(0), np.where(std == 0, 1.0, std)


class Session:
    """The program's train step after its first steps, with what the
    comparison needs of them."""

    def __init__(self, cell, seed: int, device, overrides: dict):
        cfg, mix = cell.config, cell.traffic
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.backbone = cell.backbone
        self.grid = tuple(overrides.get("grid", cfg["grid"]))
        self.batch = overrides.get("batch", mix["batch"])
        self.pool_n = overrides.get("pool", mix["pool"])
        if self.pool_n % self.batch or self.pool_n < CHECKED_STEPS * self.batch:
            raise ValueError("the pool must hold three or more whole batches")
        self.dtype = port.DTYPES[overrides.get("dtype", cfg["dtype"])]
        self.regime = mix["regime"]
        # set-up seconds by phase, for standard error; library_s is the
        # kernel library's load, with its build in a checkout's first run
        self.phases = {"library_s": port.load_library(device)}
        t = time.perf_counter()
        self.pool = inputs.host_pool(
            seed, self.pool_n, self.grid, cfg["inputs"], cfg["n_classes"],
            device)
        t = self._phase("pool_s", t)
        built = port.build_train(
            cfg, self.regime, device, self.dtype, self.pool,
            lambda t: inputs.make_weights(t, seed, device, cfg))
        self.model, self.optimizer, self.step, self.state = built
        self.template = {k: torch.empty(v.shape, dtype=v.dtype,
                                        device="meta")
                         for k, v in self.model.state_dict().items()}
        dataset = inputs.PoolDataset(self.pool, self.pool_n * 100000)
        self.loader = iter(port.loader(dataset, self.batch,
                                       mix["loader_threads"], device))
        self.loader_wait_s = 0.0
        t = self._phase("build_s", t)
        self.readings = self._first_steps(overrides.get(
            "warmup_steps", mix["warmup_steps"]))
        self._phase("first_steps_s", t)

    def _phase(self, name: str, since: float) -> float:
        now = time.perf_counter()
        self.phases[name] = self.phases.get(name, 0.0) + now - since
        return now

    def next_batch(self):
        t = time.perf_counter()
        b = next(self.loader)
        self.loader_wait_s += time.perf_counter() - t
        return b

    def _trained(self) -> dict:
        names = {id(p): n for n, p in self.model.named_parameters()}
        return {names[id(p)]: p for g in self.optimizer.param_groups
                for p in g["params"]}

    def _first_grad(self, p) -> torch.Tensor:
        """The first gradient as Adam took it, from its first moment after
        one step (a parameter with no state took none), float32 on the
        host."""
        state = self.optimizer.state.get(p, {})
        if "exp_avg" not in state:
            return torch.zeros(p.shape)
        beta1 = next(g["betas"][0] for g in self.optimizer.param_groups
                     if any(q is p for q in g["params"]))
        return state["exp_avg"].detach().float().cpu() / (1.0 - beta1)

    def _first_steps(self, steps: int) -> dict:
        trained = self._trained()
        start = {k: p.detach().clone() for k, p in trained.items()}
        out = {"loss": []}
        for i in range(max(steps, CHECKED_STEPS)):
            self.state, aux = self.step(self.state, self.next_batch())
            if i < CHECKED_STEPS:
                out["loss"].append(aux["loss"])
            if i == 0:
                out["logits1"] = aux["logits"].detach().float().cpu()
                out["grad1"] = {k: self._first_grad(p)
                                for k, p in trained.items()}
                out["grad"] = {k: float(g.norm())
                               for k, g in out["grad1"].items()}
            if i == CHECKED_STEPS - 1:
                out["update"] = {k: float((p.detach() - start[k]).norm())
                                 for k, p in trained.items()}
                del start
        out["loss"] = [float(v) for v in out["loss"]]
        _sync(self.device)
        return out

    def checked_batches(self) -> list:
        """The raw batches of the first three steps, as the loader walked
        the pool, on the device."""
        return [{k: torch.from_numpy(np.ascontiguousarray(
            v[i * self.batch:(i + 1) * self.batch])).to(self.device)
                 for k, v in self.pool.items()}
                for i in range(CHECKED_STEPS)]

    def close(self) -> None:
        self.loader.close()
        del self.model, self.optimizer, self.step, self.state
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference(session: Session, numerics: str = "float32",
              loss_rows: int | None = None) -> dict:
    """The reference's readings of the session's first three steps, from
    the same seed's weights and batches, in float32 with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = inputs.make_weights(session.template, session.seed,
                                  session.device, session.cfg)
    stats = None
    if "tabular" in session.pool:
        mean, std = feature_stats(session.pool["tabular"])
        stats = tuple(torch.tensor(v, dtype=torch.float32,
                                   device=session.device)
                      for v in (mean, std))
    return ref_train.readings(session.cfg, session.backbone, session.regime,
                              weights, session.checked_batches(), stats,
                              numerics, loss_rows)


def run(cell, env) -> dict:
    device = env.device
    session = Session(cell, env.seed, device, env.overrides)
    mix = cell.traffic
    prof = Profiled() if env.trace else None
    traced = None  # (steps, seconds) of the traced stretch
    wait0 = session.loader_wait_s
    _sync(device)
    host = window.HostUsage()
    t0 = time.perf_counter()
    setup_s = time.time() - env.started
    steps = 0
    # with a trace asked for, the window closes only after the traced
    # stretch, however short the window or slow the steps
    while time.perf_counter() - t0 < env.seconds or (
            prof is not None and traced is None):
        if prof is not None and traced is None and \
                time.perf_counter() - t0 >= TRACE_AT * env.seconds:
            _sync(device)
            ta = time.perf_counter()
            prof.start()
            for _ in range(mix["trace_steps"]):
                with torch.autograd.profiler.record_function(
                        "portbench.step"):
                    session.state, _ = session.step(session.state,
                                                    session.next_batch())
            _sync(device)
            prof.stop()
            traced = (mix["trace_steps"], time.perf_counter() - ta)
            steps += mix["trace_steps"]
            continue
        session.state, _ = session.step(session.state, session.next_batch())
        steps += 1
    _sync(device)
    seconds = time.perf_counter() - t0
    samples = steps * session.batch
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    loader_wait_ms = (session.loader_wait_s - wait0) * 1e3 / steps
    window_host = dict(host.since(seconds), loader_wait_ms=loader_wait_ms,
                       setup=session.phases)
    prog = session.readings
    session.close()
    ref = reference(session)
    numbers = compare.train_numbers(prog, ref)
    out = {
        "end_to_end": {"train_samples_per_s": window.rate(samples, seconds)},
        "attempted": steps, "failed": 0, "numbers": numbers,
        "memory_peak_bytes": peak, "setup_s": setup_s,
        "ctx": {"kind": "train", "config": cell.config, "mix": mix,
                "batch": session.batch, "dtype": session.dtype,
                "grid": session.grid, "loader_wait_ms": loader_wait_ms,
                "regime": session.regime, "window_host": window_host},
    }
    if traced is not None:
        # the rate away from the traced stretch, whose synchronises and
        # profiler the untraced run does not pay
        out["ctx"]["samples_per_s"] = window.rate(
            (steps - traced[0]) * session.batch, seconds - traced[1])
        out["ctx"]["traced_steps"] = traced[0]
        out["trace"] = prof.collect()
    return out
