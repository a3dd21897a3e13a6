"""Hyperparameter optimization: optuna when available, built-in TPE shim.

Port of ``multimodal_alzheimer_tpu/train/hpo.py``, kept line for line: the
same ``random.Random`` draws in the same order, so a seed gives the same
proposals as the JAX package's shim for the same told values. The
reference runs ``optuna.create_study(direction='minimize')`` with 300
trials / 1-day timeout and catches CUDA OOM as ``math.inf`` (reference:
train_pet_cnn.py:110-118, 208-216). optuna is not installed on the card's
machine, so the shim provides the same ``trial`` sampling API
(``suggest_float``/``suggest_int``/``suggest_categorical``) backed by a
Tree-structured Parzen Estimator (Bergstra et al. 2011, the algorithm
behind optuna's default): after ``n_startup_trials`` random trials, each
parameter is sampled by splitting history into the best-gamma "good" and
remaining "bad" trials, fitting Parzen densities l(x) and g(x), and picking
the candidate maximizing l(x)/g(x). Random search remains available
(``create_study(sampler='random')``). ``oom_guard`` scores a trial that
runs out of device memory as ``inf`` (``torch.cuda.OutOfMemoryError``, whose
message reads "CUDA out of memory", and the JAX package's
RESOURCE_EXHAUSTED / "Out of memory") and frees the card's cached blocks
before the next trial; inf trials rank as worst, i.e. always "bad".
"""

from __future__ import annotations

import gc
import math
import random
import time
from typing import Callable, Optional

import torch


class RandomTrial:
    """optuna.Trial-compatible sampling shim (random search)."""

    def __init__(self, rng: random.Random, number: int):
        self._rng = rng
        self.number = number
        self.params: dict = {}

    def suggest_float(self, name: str, low: float, high: float,
                      log: bool = False) -> float:
        if log:
            value = math.exp(self._rng.uniform(math.log(low),
                                               math.log(high)))
        else:
            value = self._rng.uniform(low, high)
        self.params[name] = value
        return value

    def suggest_int(self, name: str, low: int, high: int) -> int:
        value = self._rng.randint(low, high)
        self.params[name] = value
        return value

    def suggest_categorical(self, name: str, choices):
        value = self._rng.choice(list(choices))
        self.params[name] = value
        return value


class RandomStudy:
    def __init__(self, direction: str = "minimize", seed: int = 0):
        self.direction = direction
        self._rng = random.Random(seed)
        self.trials: list[tuple[float, dict]] = []
        self._asked = 0

    def _make_trial(self, number: int):
        return RandomTrial(self._rng, number)

    def ask(self):
        """Propose a new trial (optuna ask/tell API). Multiple asks before
        any tell sample independently from the same history — the same
        semantics optuna gives concurrent workers, which is what the
        batched/vmapped HPO driver (train/vmap_hpo.py) relies on."""
        trial = self._make_trial(self._asked)
        self._asked += 1
        return trial

    def tell(self, trial, value: float) -> None:
        """Record a finished trial's objective value."""
        self.trials.append((float(value), dict(trial.params)))

    def optimize(self, objective: Callable, n_trials: int = 300,
                 timeout: Optional[float] = None) -> None:
        start = time.time()
        for _ in range(n_trials):
            if timeout is not None and time.time() - start > timeout:
                break
            trial = self.ask()
            value = objective(trial)
            self.tell(trial, value)

    @property
    def best_trial(self):
        key = min if self.direction == "minimize" else max
        value, params = key(self.trials, key=lambda t: t[0])

        class _Best:
            pass

        best = _Best()
        best.value = value
        best.params = params
        return best

    @property
    def best_value(self) -> float:
        return self.best_trial.value


class TPETrial(RandomTrial):
    """Trial whose suggests are TPE-guided by the study's history."""

    def __init__(self, study: "TPEStudy", number: int):
        super().__init__(study._rng, number)
        self._study = study

    def suggest_float(self, name: str, low: float, high: float,
                      log: bool = False) -> float:
        value = self._study._sample_numeric(name, low, high, log=log)
        if value is None:
            return super().suggest_float(name, low, high, log=log)
        self.params[name] = value
        return value

    def suggest_int(self, name: str, low: int, high: int) -> int:
        value = self._study._sample_numeric(name, low, high + 1)
        if value is None:
            return super().suggest_int(name, low, high)
        value = min(int(value), high)
        self.params[name] = value
        return value

    def suggest_categorical(self, name: str, choices):
        value = self._study._sample_categorical(name, list(choices))
        if value is None:
            return super().suggest_categorical(name, choices)
        self.params[name] = value
        return value


class TPEStudy(RandomStudy):
    """Tree-structured Parzen Estimator study (optuna-default semantics).

    Univariate/independent TPE with optuna's default knobs: 10 random
    startup trials, γ = min(ceil(0.1·n), 25) good trials, 24 EI
    candidates, per-point bandwidths from neighbor spacing plus a flat
    prior component over the range (Bergstra et al. 2011 recipe).
    """

    N_STARTUP = 10
    N_EI_CANDIDATES = 24
    PRIOR_WEIGHT = 1.0

    def _make_trial(self, number: int):
        return TPETrial(self, number)

    # -- history ------------------------------------------------------
    def _split(self, name: str):
        """(good_values, bad_values) of parameter `name` across history."""
        sign = 1.0 if self.direction == "minimize" else -1.0
        hist = [(sign * v, p[name]) for v, p in self.trials if name in p]
        if len(hist) < self.N_STARTUP:
            return None, None
        finite = sorted((h for h in hist if math.isfinite(h[0])),
                        key=lambda h: h[0])
        inf_tail = [h for h in hist if not math.isfinite(h[0])]
        n_good = max(1, min(int(math.ceil(0.1 * len(hist))), 25))
        ordered = finite + inf_tail
        good = [x for _, x in ordered[:n_good]]
        bad = [x for _, x in ordered[n_good:]] or good
        return good, bad

    # -- numeric ------------------------------------------------------
    def _sample_numeric(self, name, low, high, log=False):
        good, bad = self._split(name)
        if good is None:
            return None
        if log:
            tr, inv = math.log, math.exp
        else:
            tr, inv = (lambda x: x), (lambda x: x)
        lo, hi = tr(low), tr(high)
        good_t = [tr(max(min(x, high), low)) for x in good]
        bad_t = [tr(max(min(x, high), low)) for x in bad]

        candidates = [self._kde_draw(good_t, lo, hi)
                      for _ in range(self.N_EI_CANDIDATES)]
        best = max(candidates,
                   key=lambda c: (self._kde_logpdf(c, good_t, lo, hi)
                                  - self._kde_logpdf(c, bad_t, lo, hi)))
        return inv(best)

    def _bandwidths(self, mus, lo, hi):
        """Per-point sigma = max neighbor spacing, clipped to the range
        (classic Parzen-estimator bandwidth rule)."""
        span = hi - lo
        if span <= 0:
            return [1e-12] * len(mus)
        order = sorted(range(len(mus)), key=lambda i: mus[i])
        sig = [0.0] * len(mus)
        for rank, i in enumerate(order):
            left = mus[i] - mus[order[rank - 1]] if rank > 0 else span
            right = (mus[order[rank + 1]] - mus[i]
                     if rank + 1 < len(order) else span)
            sig[i] = max(left, right)
        min_sig = span / min(100.0, max(len(mus), 1) + 1.0)
        return [min(max(s, min_sig), span) for s in sig]

    def _kde_draw(self, mus, lo, hi):
        # prior component: uniform-ish wide Gaussian over the range
        k = self._rng.randrange(len(mus) + 1)
        if k == len(mus):
            mu, sigma = 0.5 * (lo + hi), hi - lo if hi > lo else 1e-12
        else:
            mu = mus[k]
            sigma = self._bandwidths(mus, lo, hi)[k]
        for _ in range(100):  # truncate by resampling
            x = self._rng.gauss(mu, sigma)
            if lo <= x <= hi:
                return x
        return min(max(x, lo), hi)

    def _kde_logpdf(self, x, mus, lo, hi):
        sigmas = self._bandwidths(mus, lo, hi)
        comps = list(zip(mus, sigmas))
        comps.append((0.5 * (lo + hi), hi - lo if hi > lo else 1e-12))
        total = 0.0
        for mu, sigma in comps:
            z = (x - mu) / sigma
            total += math.exp(-0.5 * z * z) / (sigma * math.sqrt(2 * math.pi))
        return math.log(total / len(comps) + 1e-300)

    # -- categorical --------------------------------------------------
    def _sample_categorical(self, name, choices):
        good, bad = self._split(name)
        if good is None:
            return None

        def probs(values):
            w = [self.PRIOR_WEIGHT + sum(1 for v in values if v == c)
                 for c in choices]
            s = float(sum(w))
            return [x / s for x in w]

        p_good, p_bad = probs(good), probs(bad)
        # draw candidates from l(x), score by l/g (Bergstra's EI argmax)
        idxs = self._rng.choices(range(len(choices)), weights=p_good,
                                 k=self.N_EI_CANDIDATES)
        best = max(idxs, key=lambda i: math.log(p_good[i])
                   - math.log(p_bad[i]))
        return choices[best]


def create_study(direction: str = "minimize", seed: int = 0,
                 sampler: str = "tpe"):
    """optuna study when installed; built-in TPE (default) or random."""
    try:
        import optuna

        return optuna.create_study(direction=direction)
    except ImportError:
        cls = TPEStudy if sampler == "tpe" else RandomStudy
        return cls(direction=direction, seed=seed)


def is_oom(error: BaseException) -> bool:
    """Whether ``error`` is a device out-of-memory failure: torch's
    ``OutOfMemoryError`` ("CUDA out of memory"), or the JAX package's
    RESOURCE_EXHAUSTED / "Out of memory" messages."""
    return (isinstance(error, torch.cuda.OutOfMemoryError)
            or "RESOURCE_EXHAUSTED" in str(error)
            or "Out of memory" in str(error))


def free_device_memory() -> None:
    """Release what a failed trial left on the card: its tensors (once
    unreferenced) and the caching allocator's free blocks."""
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def oom_guard(train_fn: Callable) -> Callable:
    """Score OOM'd trials as inf so the study continues
    (train_pet_cnn.py:110-118 parity)."""

    def wrapped(*args, **kwargs):
        try:
            return train_fn(*args, **kwargs)
        except Exception as e:
            if not is_oom(e):
                raise
        print("Aborting run, not enough memory!")
        free_device_memory()
        return math.inf

    return wrapped
