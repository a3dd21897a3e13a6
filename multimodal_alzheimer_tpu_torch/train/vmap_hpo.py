"""K hyperparameter trials of one model in one run: the K-trial trainer.

Port of ``multimodal_alzheimer_tpu/train/vmap_hpo.py``. The reference's HPO
is strictly sequential: optuna's TPE proposes one config, one Lightning fit
runs to completion, repeat 300 times (reference: train_pet_cnn.py:208-216).
The JAX package runs K trials of one bucket as one XLA program through
``jax.vmap``, for the TPU's matrix unit. This module keeps that function
on the card with one mechanism for every model: K ``(module, Adam)`` pairs
live on the device, and each train step runs the trials one after another
over the same batch.

What it keeps of JAX's trainer:

* **Per-trial hyperparameters** (lr, torch-style L2, dropout rate, focal
  gamma / loss selector, init seed) come stacked as (K,) tensors
  (``stack_trial_hparams``); each trial's Adam is ``optim.adam_group``
  (L2 added to the gradient before the moments, torch ``Adam(lr,
  weight_decay)``). ``lr_select(hp_row, path)`` gives each parameter its
  learning rate, as per-trial Adam parameter groups; a 0.0 group keeps its
  parameters bit for bit, with L2 still in its moments, JAX's semantics.
* **Per-trial init and dropout**: trial i's weights are drawn from a
  ``torch.Generator`` seeded from ``(seed, trial_seed, 0)`` and its dropout
  masks from one seeded from ``(seed, trial_seed, 1)``
  (``trial_generator_seed``), where JAX folds ``trial_seed`` into one key.
  A trial's numbers therefore do not depend on its place in the stack or
  on the other trials: K stacked trials equal K solo runs.
* **One shared shuffle per epoch** from ``np.random.default_rng(seed)``,
  the ragged tail dropped; validation batches padded with wrapped indices
  and masked; the epoch's val loss is the unweighted mean over batches.
* **Per-trial early stopping**: a stopped trial is skipped whole (params,
  BatchNorm statistics, Adam moments, dropout stream), which is what JAX's
  ``jnp.where`` freeze computes; its val loss stays the one of its last
  epoch. The stop rule replays ``optim.EarlyStopping`` (patience, min_delta
  0), and the returned value is each trial's val loss at its stop epoch.
* **``track_best``**: a copy of each trial's parameters and BatchNorm
  statistics at its best-val epoch.
* **``shared_fn``**: a trial-invariant computation (the frozen towers of a
  fusion search, ``train/fusion_hpo.py``) runs once per step under
  ``torch.no_grad()`` and its output goes to every trial's ``apply_fn``.

The state of the trial axis comes back stacked as (K, ...) tensors
(``info['carry']``, ``info['best_carry']``), keyed by the modules'
``state_dict`` names, so a winner is picked by index as in JAX.

``apply_fn(model, batch, hp_row, train[, shared]) -> out`` replaces JAX's
``apply_fn(model, variables, batch, hp, rng, train[, shared])``: a torch
module holds its variables and its dropout generator. ``init_fn(model,
generator, example, shared_example) -> module`` builds one trial's module
(JAX returns its variables).

``mesh=`` (a ``parallel.Mesh``) shards the trial axis, JAX's zero-collective
trial sharding: rank r trains trials ``[r K/W, (r+1) K/W)`` on the whole
(replicated) data, each with the generators it has without a mesh, so a
trial computes the same wherever it runs. The epoch's val losses are
gathered (one all-reduce an epoch), every rank replays the stop rule for
all K and the loop ends when no trial on any rank is active; the stacked
snapshots and final state are gathered at the end, so every rank returns
the unsharded info dict.
"""

from __future__ import annotations

import copy
import math
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from multimodal_alzheimer_tpu_torch.models.layers import (
    reset_parameters,
    set_dropout_generator,
)
from multimodal_alzheimer_tpu_torch.parallel.mesh import (
    coalesced_,
    tensors_of,
)
from multimodal_alzheimer_tpu_torch.train.hpo import (
    free_device_memory,
    is_oom,
)
from multimodal_alzheimer_tpu_torch.train.optim import adam_group
from multimodal_alzheimer_tpu_torch.train.state import _zero_unreached_grads
from multimodal_alzheimer_tpu_torch.utils.device import resolve_device
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

TRACED_KEYS = ("lr", "l2_reg", "dropout_p", "fl_gamma")


def stack_trial_hparams(rows: Sequence[dict], pad_to: Optional[int] = None,
                        seed_offset: int = 0,
                        extra_keys: Sequence[str] = ()) -> dict:
    """Stack per-trial hparam dicts into (K,) tensors (CPU).

    ``fl_gamma`` None/0 selects weighted CE (``use_focal`` 0); truthy
    selects the reference's FocalLoss with that gamma, as
    ``losses.make_criterion``. ``pad_to`` repeats the last row up to that
    width (JAX pads every bucket so XLA compiles one program per signature;
    the port's entry points, which compile nothing, do not pad, and a
    padded trial would only cost time); the caller drops the padded
    results (slice ``[:len(rows)]``). ``extra_keys`` stacks further float
    knobs (e.g. the PET CNN's two dropout rates); absent/None values become
    0.0.
    """
    rows = list(rows)
    n_real = len(rows)
    if pad_to is not None:
        if n_real > pad_to:
            raise ValueError(f"{n_real} rows > pad_to={pad_to}")
        rows = rows + [rows[-1]] * (pad_to - n_real)

    def farr(key):
        return torch.tensor([float(r.get(key) or 0.0) for r in rows],
                            dtype=torch.float32)

    hp = {
        "lr": farr("lr"),
        "l2_reg": farr("l2_reg"),
        "dropout_p": farr("dropout_p"),
        "fl_gamma": farr("fl_gamma"),
        "use_focal": torch.tensor(
            [1.0 if r.get("fl_gamma") else 0.0 for r in rows],
            dtype=torch.float32),
        "trial_seed": torch.tensor(
            [int(r.get("trial_seed", seed_offset + i))
             for i, r in enumerate(rows)], dtype=torch.int32),
    }
    for key in extra_keys:
        hp[key] = farr(key)
    return hp


def trial_row(hp: dict, i: int) -> dict:
    """Trial ``i``'s hyperparameters as Python numbers (floats of the
    stacked float32 values, an int seed)."""
    return {k: (int(v[i]) if k == "trial_seed" else float(v[i]))
            for k, v in hp.items()}


def trial_generator_seed(seed: int, trial_seed: int, stream: int) -> int:
    """The seed of trial ``trial_seed``'s generator ``stream`` (0: initial
    weights, 1: dropout masks) in a run seeded with ``seed``."""
    return int(np.random.SeedSequence(
        [int(seed), int(trial_seed), int(stream)]).generate_state(1)[0])


def trial_criterion(logits, labels, mask, hp: dict, class_weights):
    """Per-trial loss with the selector and gamma of ``hp``.

    ``use_focal`` 0: torch weighted CE, ``sum(w[y]*nll)/sum(w[y])``
    (losses/classification.py:37-59). 1: the reference FocalLoss,
    ``mean((1-pt)^gamma * nll)`` with pt detached (:62-83; no alpha).
    ``mask`` zeroes padded samples.
    """
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    labels = labels.long()
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    if float(hp["use_focal"]) > 0:
        pt = torch.exp(-nll).detach()
        return (torch.sum((1.0 - pt) ** float(hp["fl_gamma"]) * nll * mask)
                / torch.clamp(torch.sum(mask), min=1.0))
    weights = torch.as_tensor(class_weights, dtype=torch.float32,
                              device=logits.device)
    w = weights[labels] * mask
    return torch.sum(w * nll) / torch.clamp(torch.sum(w), min=1e-12)


def _default_apply(model, batch, hp, train):
    """Forwards the trial's dropout rate to models that take it
    (``TabularMLP``'s ``dropout_rate``); override ``apply_fn`` for model
    families with other knobs."""
    if train:
        return model(batch, dropout_rate=hp["dropout_p"])
    return model(batch)


def plain_apply(model, batch, hp, train):
    """The apply hook of a search space with no per-trial model knobs."""
    del hp, train
    return model(batch)


def _default_init(model, generator, example, shared_example):
    """A copy of ``model`` on the CPU with flax's initialisation drawn from
    ``generator`` (a CPU generator, so the weights do not depend on the
    device the trials run on)."""
    del example, shared_example
    trial = copy.deepcopy(model).cpu()
    reset_parameters(trial, generator)
    return trial


def _param_groups(module, row: dict, lr_select: Optional[Callable]):
    """Adam parameter groups of one trial: one group, or one per distinct
    learning rate ``lr_select(row, path)`` gives."""
    if lr_select is None:
        return list(module.parameters())
    groups: dict = {}
    for name, param in module.named_parameters():
        lr = float(lr_select(row, tuple(name.split("."))))
        groups.setdefault(lr, []).append(param)
    return [{"params": params, "lr": lr} for lr, params in groups.items()]


def _state_names(module):
    """(parameter names, BatchNorm-statistics names) of a ``state_dict``."""
    params = [name for name, _ in module.named_parameters()]
    stats = [name for name in module.state_dict() if name not in params]
    return params, stats


def _stack(dicts: list, names) -> dict:
    return {name: torch.stack([d[name] for d in dicts]) for name in names}


def _clone(tree):
    """A copy of a nest of dicts/tuples/lists of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _to_device(data: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in data.items()}


class _Trial:
    """One trial's module, Adam and hyperparameters."""

    def __init__(self, module, optimizer, row):
        self.module = module
        self.optimizer = optimizer
        self.row = row

    def state(self) -> dict:
        return self.module.state_dict(keep_vars=False)


def run_parallel_trials(model, hp: dict, train_data: dict, val_data: dict, *,
                        batch_size: int, max_epochs: int, patience: int,
                        class_weights, seed: int = 5,
                        apply_fn: Callable = _default_apply,
                        return_state: bool = False, mesh=None,
                        shared_fn: Optional[Callable] = None,
                        shared_carry0=None,
                        init_fn: Optional[Callable] = None,
                        lr_select: Optional[Callable] = None,
                        track_best: bool = False, device="cuda"):
    """Train K = len(hp['lr']) trials of ``model`` over one split.

    ``train_data``/``val_data``: dicts of stacked arrays or tensors with a
    leading sample axis, including ``'label'``; they are moved to
    ``device`` once. All trials see the same data but have their own init,
    dropout stream and hyperparameters.

    ``shared_fn(shared_carry, batch, train) -> (out, carry)`` runs once per
    step (and once per validation batch, where it reads the carry without
    advancing it) and its output is ``apply_fn``'s fifth argument.
    ``shared_carry0`` is copied, so one carry serves many buckets.
    ``init_fn(model, generator, example, shared_example) -> module`` builds
    a trial's module (default: a copy of ``model`` re-initialised from
    ``generator``).

    Returns ``(last_val_losses (K,) numpy, info)`` with ``info`` holding
    ``val_history`` (epochs, K), ``stopped_epoch`` (K,), with
    ``track_best`` ``best_carry`` = (params, stats) stacked (K, ...) at
    each trial's best-val epoch and ``best_val`` (K,), and with
    ``return_state`` the final ``carry`` = (params, stats, adam) and
    ``shared_carry``. ``adam`` holds the stacked ``exp_avg``,
    ``exp_avg_sq`` and ``step``.

    ``mesh`` shards the trials over the ranks (every rank calls this
    alike; the trials run on the mesh's device, which replaces
    ``device``): K must be a multiple of the ranks.
    """
    k_trials = int(hp["lr"].shape[0])
    mine = range(k_trials)
    if mesh is not None:
        if k_trials % mesh.size:
            raise ValueError(
                f"K={k_trials} trials is not a multiple of the mesh's "
                f"{mesh.size} ranks (pad with stack_trial_hparams(pad_to="
                f"...))")
        mine = range(k_trials)[mesh.rows(k_trials)]
        device = mesh.device
    device = resolve_device(device)
    train_data = _to_device(train_data, device)
    val_data = _to_device(val_data, device)
    n_train = int(train_data["label"].shape[0])
    n_val = int(val_data["label"].shape[0])
    b = int(min(batch_size, n_train))
    n_batches = n_train // b
    class_weights = torch.as_tensor(class_weights, dtype=torch.float32,
                                    device=device)

    # Val batches: wrapped indices, pads masked, unweighted mean over
    # batches (Lightning parity, loop.py:262-265).
    n_vb = max(1, math.ceil(n_val / b))
    val_idx = torch.as_tensor(np.arange(n_vb * b) % n_val,
                              device=device).reshape(n_vb, b)
    val_mask = torch.as_tensor(
        (np.arange(n_vb * b) < n_val).astype(np.float32),
        device=device).reshape(n_vb, b)
    train_mask = torch.ones(b, dtype=torch.float32, device=device)

    example = {k: v[:b] for k, v in train_data.items()}
    shared_carry = _clone(shared_carry0) if shared_carry0 is not None else ()
    shared_example = None
    if shared_fn is not None:
        with torch.no_grad():
            shared_example, _ = shared_fn(shared_carry, example, False)

    def apply(module, batch, row, train, shared):
        if shared_fn is None:
            return apply_fn(module, batch, row, train)
        return apply_fn(module, batch, row, train, shared)

    trials = {}
    for i in mine:
        row = trial_row(hp, i)
        init_gen = make_generator(
            trial_generator_seed(seed, row["trial_seed"], 0))
        module = (init_fn or _default_init)(model, init_gen, example,
                                            shared_example).to(device)
        set_dropout_generator(module, make_generator(
            trial_generator_seed(seed, row["trial_seed"], 1), device))
        optimizer = adam_group(_param_groups(module, row, lr_select),
                               row["lr"], row["l2_reg"])
        trials[i] = _Trial(module, optimizer, row)
    param_names, stat_names = _state_names(trials[mine[0]].module)

    def train_step(trial, batch, shared):
        trial.module.train()
        trial.optimizer.zero_grad(set_to_none=True)
        out = apply(trial.module, batch, trial.row, True, shared)
        loss = trial_criterion(out["logits"], batch["label"], train_mask,
                               trial.row, class_weights)
        loss.backward()
        _zero_unreached_grads(trial.optimizer)
        trial.optimizer.step()

    def evaluate(live: list) -> np.ndarray:
        """Each live trial's val loss (NaN elsewhere), one host wait."""
        totals = [torch.zeros((), device=device) for _ in live]
        for t in live:
            trials[t].module.eval()
        with torch.no_grad():
            for j in range(n_vb):
                batch = {k: v[val_idx[j]] for k, v in val_data.items()}
                shared = None
                if shared_fn is not None:  # reads the carry, no advance
                    shared, _ = shared_fn(shared_carry, batch, False)
                for n, t in enumerate(live):
                    out = apply(trials[t].module, batch, trials[t].row,
                                False, shared)
                    totals[n] += trial_criterion(
                        out["logits"], batch["label"], val_mask[j],
                        trials[t].row, class_weights)
        val = np.full(k_trials, np.nan)
        if live:
            val[live] = (torch.stack(totals) / n_vb).cpu().numpy()
        if mesh is not None:  # every rank's trials, NaN where not live
            mine_live = torch.zeros(k_trials, dtype=torch.float64)
            mine_live[live] = torch.from_numpy(val[live])
            got = mesh.all_reduce_(mine_live.to(device)).cpu().numpy()
            val = np.where(active, got, np.nan)
        return val

    shuffle_rng = np.random.default_rng(seed)
    best = np.full(k_trials, np.inf)
    wait = np.zeros(k_trials, np.int64)
    active = np.ones(k_trials, bool)
    last_val = np.full(k_trials, np.inf)
    stopped_epoch = np.full(k_trials, max_epochs - 1, np.int64)
    history = []
    best_snapshot = None
    if track_best:
        best_snapshot = {i: _clone(t.state()) for i, t in trials.items()}
    for epoch in range(max_epochs):
        perm = torch.as_tensor(
            shuffle_rng.permutation(n_train)[:n_batches * b]
            .reshape(n_batches, b), device=device)
        live = [i for i in mine if active[i]]
        for s in range(n_batches):
            batch = {k: v[perm[s]] for k, v in train_data.items()}
            shared = None
            if shared_fn is not None:
                with torch.no_grad():
                    shared, shared_carry = shared_fn(shared_carry, batch,
                                                     True)
            for i in live:
                train_step(trials[i], batch, shared)
        val = np.where(active, evaluate(live), last_val)
        history.append(val)
        last_val = np.where(active, val, last_val)
        stopped_epoch = np.where(active, epoch, stopped_epoch)
        # EarlyStopping replay (optim.py:130-148): reset on strict
        # improvement, stop after `patience` consecutive non-improvements.
        improved = val < best
        if track_best:
            for i in np.flatnonzero(active & improved):
                if i not in trials:
                    continue
                for name, value in trials[i].state().items():
                    best_snapshot[i][name].copy_(value)
        best = np.where(active & improved, val, best)
        wait = np.where(active, np.where(improved, 0, wait + 1), wait)
        active = active & (wait < patience)
        if not active.any():
            break

    info = {"val_history": np.stack(history),
            "stopped_epoch": stopped_epoch}
    if track_best:
        snapshots = list(best_snapshot.values())
        info["best_carry"] = _gather_trials(
            (_stack(snapshots, param_names), _stack(snapshots, stat_names)),
            mesh, k_trials, mine)
        info["best_val"] = best
    if return_state:
        states = [t.state() for t in trials.values()]
        adam = {"exp_avg": {}, "exp_avg_sq": {}, "step": None}
        named = [dict(t.module.named_parameters()) for t in trials.values()]
        for name in param_names:
            moments = [t.optimizer.state[p[name]] for t, p in
                       zip(trials.values(), named)]
            for key in ("exp_avg", "exp_avg_sq"):
                adam[key][name] = torch.stack([m[key] for m in moments])
            adam["step"] = torch.stack([torch.as_tensor(m["step"])
                                        for m in moments])
        info["carry"] = _gather_trials(
            (_stack(states, param_names), _stack(states, stat_names), adam),
            mesh, k_trials, mine)
        info["shared_carry"] = shared_carry
    return last_val, info


def _gather_trials(tree, mesh, k_trials: int, mine: range):
    """A nest of the rank's (len(mine), ...) trial stacks -> the (K, ...)
    stacks of every rank (one all-reduce per dtype); ``tree`` itself
    without a mesh."""
    if mesh is None:
        return tree

    def widen(t):
        out = torch.zeros((k_trials,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=mesh.device)
        out[mine.start:mine.stop] = t
        return out

    def walk(t):
        if isinstance(t, torch.Tensor):
            return widen(t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return type(t)(walk(v) for v in t)

    out = walk(tree)
    coalesced_(tensors_of(out), mesh, "all_reduce")
    return out


def optimize_batched(study, sample_hparams: Callable,
                     batch_objective: Callable, *, n_trials: int,
                     parallel: int, signature_fn: Callable,
                     timeout: Optional[float] = None):
    """Drive a study with K-at-a-time proposals and batched evaluation.

    Each round asks ``parallel`` trials (optuna concurrent-worker
    semantics: all sampled from the current history), buckets them by
    ``signature_fn(hparams)`` in the order they were asked, and hands each
    bucket to ``batch_objective(signature, [hparams,...]) -> values``. A
    bucket that runs out of device memory scores all its trials ``inf``
    (``hpo.oom_guard`` semantics) and frees the card's cached blocks; any
    other exception propagates.
    """
    start = time.time()
    done = 0
    while done < n_trials:
        if timeout is not None and time.time() - start > timeout:
            break
        k = min(parallel, n_trials - done)
        asked = []
        for _ in range(k):
            trial = study.ask()
            asked.append((trial, sample_hparams(trial)))
        buckets: dict = {}
        for trial, hparams in asked:
            buckets.setdefault(signature_fn(hparams), []).append(
                (trial, hparams))
        for signature, items in buckets.items():
            values = None
            try:
                values = batch_objective(signature,
                                         [hp for _, hp in items])
            except Exception as e:
                if not is_oom(e):
                    raise
            if values is None:
                print("Aborting run, not enough memory!")
                free_device_memory()
                values = [math.inf] * len(items)
            for (trial, _), value in zip(items, values):
                study.tell(trial, float(value))
        done += k
    return study
