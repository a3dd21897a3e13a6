"""The port's HPO plumbing against the JAX package's: the TPE and random
studies, ``oom_guard``, patient k-fold, ``stack_trial_hparams``,
``trial_criterion``, ``traced_dropout``, ``optimize_batched``'s bucketing and
tell order, and the train-state resume.

The studies and the folds are pure Python and numpy in both packages, so
they are held equal exactly: the same seed and the same told values give
the same proposals. Criterion values are held at float32's rtol 1e-6.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.train import hpo as jax_hpo
from multimodal_alzheimer_tpu.train import kfold as jax_kfold
from multimodal_alzheimer_tpu.train import vmap_hpo as jax_vmap_hpo
from multimodal_alzheimer_tpu_torch.models.layers import (
    TracedDropout,
    set_dropout_generator,
    traced_dropout,
)
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
    SmallPETCNN,
)
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp import (
    TabularMLP,
)
from multimodal_alzheimer_tpu_torch.train import hpo, kfold, vmap_hpo
from multimodal_alzheimer_tpu_torch.train.checkpoint import (
    load_train_state,
    save_train_state,
)
from multimodal_alzheimer_tpu_torch.train.optim import adam_group
from multimodal_alzheimer_tpu_torch.train.state import (
    TrainState,
    make_train_step,
)
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator
from torch_threads import torch_threads  # noqa: F401 (autouse)

CW3 = np.array([0.55, 0.75, 0.7], np.float32)


def _space(trial):
    return (trial.suggest_float("lr", 1e-5, 1e-1, log=True),
            trial.suggest_float("x", -1.0, 2.0),
            trial.suggest_int("n", 1, 64),
            trial.suggest_categorical("c", ("a", "b", "cc")))


def _value(params, i):
    lr, x, n, c = params
    if i % 7 == 3:
        return math.inf  # an OOM'd trial
    return (abs(math.log10(lr) + 3.5) + (x - 0.3) ** 2 + abs(n - 40) / 64
            + (0.0 if c == "b" else 0.5))


@pytest.mark.parametrize("sampler", ["tpe", "random"])
@pytest.mark.parametrize("direction", ["minimize", "maximize"])
def test_study_proposals_equal_the_jax_shim(sampler, direction):
    """Ask/tell 30 trials (10 random startup + 20 TPE) on both shims with
    the same seed, the same told values (inf every seventh), both
    directions: every proposal and the best trial are equal."""
    classes = {"tpe": (jax_hpo.TPEStudy, hpo.TPEStudy),
               "random": (jax_hpo.RandomStudy, hpo.RandomStudy)}[sampler]
    ref, port = (cls(direction=direction, seed=4) for cls in classes)
    for i in range(30):
        t_ref, t_port = ref.ask(), port.ask()
        got, want = _space(t_port), _space(t_ref)
        assert got == want, (i, got, want)
        assert t_port.number == t_ref.number == i
        value = _value(want, i)
        ref.tell(t_ref, value)
        port.tell(t_port, value)
    assert port.best_trial.params == ref.best_trial.params
    assert port.best_value == ref.best_value
    assert port.trials == ref.trials


def test_optimize_and_create_study_follow_the_shim():
    ref = jax_hpo.create_study(seed=2)
    port = hpo.create_study(seed=2)
    assert type(port).__name__ == type(ref).__name__ == "TPEStudy"
    objective = (lambda trial: _value(_space(trial), trial.number))
    ref.optimize(objective, n_trials=14)
    port.optimize(objective, n_trials=14)
    assert port.trials == ref.trials
    assert isinstance(hpo.create_study(sampler="random"), hpo.RandomStudy)


@pytest.mark.parametrize("error", [
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB"),
    RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to allocate"),
])
def test_oom_guard_scores_inf(error):
    calls = []

    @hpo.oom_guard
    def fit(x):
        calls.append(x)
        raise error

    assert fit(3) == math.inf and calls == [3]

    @hpo.oom_guard
    def broken(x):
        raise ValueError("not an OOM")

    with pytest.raises(ValueError):
        broken(1)
    assert hpo.oom_guard(lambda x: x + 1)(1) == 2


def test_patient_kfold_equals_jax():
    rng = np.random.default_rng(0)
    ids = [f"sub-{i:03d}" for i in rng.integers(0, 40, 90)]
    for k, seed in ((5, 0), (3, 7)):
        got = list(kfold.patient_kfold_indices(ids, k, seed))
        want = list(jax_kfold.patient_kfold_indices(ids, k, seed))
        assert got == want

    def fold_fn(train_ids, val_ids, fold):
        return {"val_loss": len(val_ids) / (fold + 1.0), "name": "x"}

    assert (kfold.run_kfold(fold_fn, ids, 4, 1)
            == jax_kfold.run_kfold(fold_fn, ids, 4, 1))


ROWS = [
    {"lr": 3e-3, "l2_reg": 0.0, "dropout_p": 0.0, "fl_gamma": None,
     "trial_seed": 11, "lr_pretrained": None},
    {"lr": 1e-3, "l2_reg": 1e-2, "dropout_p": 0.3, "fl_gamma": 2,
     "trial_seed": 22, "lr_pretrained": 1e-5},
    {"lr": 1e-4, "l2_reg": 1e-3, "dropout_p": 0.1, "fl_gamma": None},
]


@pytest.mark.parametrize("kwargs", [
    {}, {"pad_to": 5}, {"seed_offset": 3, "extra_keys": ("lr_pretrained",)},
])
def test_stack_trial_hparams_equals_jax(kwargs):
    got = vmap_hpo.stack_trial_hparams(ROWS, **kwargs)
    want = jax_vmap_hpo.stack_trial_hparams(ROWS, **kwargs)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    with pytest.raises(ValueError):
        vmap_hpo.stack_trial_hparams(ROWS, pad_to=2)


@pytest.mark.parametrize("focal", [False, True])
def test_trial_criterion_equals_jax(focal):
    """Weighted CE and focal, with a mask over the padded tail: float32,
    rtol 1e-6."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(12, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 12).astype(np.int32)
    mask = (np.arange(12) < 9).astype(np.float32)
    hp = {"fl_gamma": np.float32(2.0 if focal else 0.0),
          "use_focal": np.float32(1.0 if focal else 0.0)}
    want = jax_vmap_hpo.trial_criterion(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask),
        {k: jnp.asarray(v) for k, v in hp.items()}, CW3)
    got = vmap_hpo.trial_criterion(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(mask), {k: float(v) for k, v in hp.items()}, CW3)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_traced_dropout_semantics(dtype):
    """Rate 0 is x itself; rate r drops about r, survivors are x divided by
    1 - r rounded to the compute dtype; eval mode and the static path are
    untouched; the mask follows the generator."""
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(64, 256)).astype(np.float32)).to(dtype)
    assert traced_dropout(x, 0.0, make_generator(0), dtype) is x
    r = 0.4
    y = traced_dropout(x, r, make_generator(2), dtype)
    assert y.dtype == dtype
    kept = y != 0
    assert abs(1.0 - kept.float().mean().item() - r) < 0.02
    keep = torch.tensor(1.0 - np.float32(r)).to(dtype)
    torch.testing.assert_close(y[kept], (x / keep)[kept], rtol=0, atol=0)
    torch.testing.assert_close(traced_dropout(x, r, make_generator(2), dtype),
                               y, rtol=0, atol=0)
    layer = TracedDropout(dtype).eval()
    assert layer(x, r) is x


def test_call_time_rates_override_static_dropout():
    """TabularMLP's ``dropout_rate`` and SmallPETCNN's conv and dense rates:
    0.0 is bit-exact to no dropout in train mode; a nonzero rate changes the
    forward and draws from the model's generator."""
    rng = np.random.default_rng(5)
    batch = {"tabular": torch.from_numpy(
        rng.normal(size=(16, 9)).astype(np.float32))}
    mlp = TabularMLP(3, hidden=(32, 64), dropout_p=0.5,
                     generator=make_generator(0)).train()
    set_dropout_generator(mlp, make_generator(1))
    ref = TabularMLP(3, hidden=(32, 64), generator=make_generator(0)).train()
    torch.testing.assert_close(mlp(batch, dropout_rate=0.0)["logits"],
                               ref(batch)["logits"], rtol=0, atol=0)
    assert not torch.equal(mlp(batch, dropout_rate=0.3)["logits"],
                           ref(batch)["logits"])

    pet = {"pet1451": torch.from_numpy(
        rng.normal(size=(4, 12, 12, 12)).astype(np.float32))}
    a = SmallPETCNN(3, conv_out=(4, 8), filter_size=(3, 3), batchnorm=True,
                    linear_out=8, dropout_conv_p=0.2, dropout_dense_p=0.5,
                    generator=make_generator(0)).train()
    b = SmallPETCNN(3, conv_out=(4, 8), filter_size=(3, 3), batchnorm=True,
                    linear_out=8, generator=make_generator(0)).train()
    set_dropout_generator(a, make_generator(1))
    torch.testing.assert_close(
        a(pet, dropout_conv_rate=0.0, dropout_dense_rate=0.0)["logits"],
        b(pet)["logits"], rtol=0, atol=0)
    assert not torch.equal(
        a(pet, dropout_conv_rate=0.0, dropout_dense_rate=0.5)["logits"],
        b(pet)["logits"])


def _toy_sample(trial):
    return {"lr": trial.suggest_float("lr", 1e-5, 1e-1, log=True),
            "dropout_p": trial.suggest_float("dropout_p", 0.0, 0.5),
            "batch_size": trial.suggest_categorical("batch_size", (16, 32))}


def _toy_objective(log, oom):
    def objective(signature, rows):
        log.append((signature, [round(r["lr"], 12) for r in rows]))
        if signature == 32 and len(log) % 5 == 0:
            raise oom
        best_lr = {16: 3e-3, 32: 1e-3}[signature]
        return [abs(math.log10(r["lr"]) - math.log10(best_lr))
                + r["dropout_p"] for r in rows]
    return objective


def test_optimize_batched_buckets_and_tells_like_jax():
    """The same asks, the same buckets handed over in the same order, the
    same tells; an OOM'd bucket scores inf in both (the port sees torch's
    OutOfMemoryError, JAX its message)."""
    logs = ([], [])
    studies = (jax_hpo.TPEStudy(seed=1), hpo.TPEStudy(seed=1))
    jax_vmap_hpo.optimize_batched(
        studies[0], _toy_sample,
        _toy_objective(logs[0], RuntimeError("RESOURCE_EXHAUSTED")),
        n_trials=40,
        parallel=6, signature_fn=lambda hp: hp["batch_size"])
    vmap_hpo.optimize_batched(
        studies[1], _toy_sample,
        _toy_objective(logs[1], torch.cuda.OutOfMemoryError(
            "CUDA out of memory.")), n_trials=40,
        parallel=6, signature_fn=lambda hp: hp["batch_size"])
    assert logs[1] == logs[0]
    assert studies[1].trials == studies[0].trials
    assert len(studies[1].trials) == 40
    assert any(v == math.inf for v, _ in studies[1].trials)


def test_train_state_resume_equals_an_uninterrupted_run(tmp_path):
    """Three steps, save, then two more steps from the live state and from
    a fresh model and optimizer loaded back: equal bit for bit, with two
    Adam groups and a plateau multiplier."""
    rng = np.random.default_rng(2)
    batch = {"pet1451": torch.from_numpy(
        rng.normal(size=(4, 12, 12, 12)).astype(np.float32)),
        "label": torch.from_numpy(rng.integers(0, 3, 4).astype(np.int64))}
    hp = {"lr": 1e-3, "n_classes": 3}

    def build():
        model = SmallPETCNN(3, conv_out=(4, 8), filter_size=(3, 3),
                            batchnorm=True, linear_out=8,
                            generator=make_generator(0))
        groups = [{"params": [p for n, p in model.named_parameters()
                              if n.startswith("cls")], "lr": 1e-2},
                  {"params": [p for n, p in model.named_parameters()
                              if not n.startswith("cls")], "lr": 1e-4}]
        optimizer = adam_group(groups, 1e-3, l2_reg=1e-3)
        return model, optimizer, make_train_step(
            model, torch.nn.functional.cross_entropy, optimizer)

    model, optimizer, step = build()
    state = TrainState(model, optimizer)
    for _ in range(3):
        state, _ = step(state, batch)
    state.lr_scale = 0.5
    save_train_state(tmp_path / "resume", state, hp, extra={"epoch": 1})
    model_b, optimizer_b, step_b = build()
    restored, hp_back = load_train_state(tmp_path / "resume", model_b,
                                         optimizer_b)
    assert hp_back == hp and restored.step == 3
    assert restored.lr_scale == 0.5
    assert (tmp_path / "resume" / "extra.json").exists()
    for _ in range(2):
        state, aux_a = step(state, batch)
        restored, aux_b = step_b(restored, batch)
        assert aux_a["loss"].item() == aux_b["loss"].item()
    for (name, a), b in zip(model.state_dict().items(),
                            model_b.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_the_hpo_entry_points_default_to_the_card():
    """No HPO entry point runs on the CPU unless asked: without a card
    each raises rather than running elsewhere."""
    from multimodal_alzheimer_tpu_torch.models.mri_models import (
        train_anat_cnn,
    )
    from multimodal_alzheimer_tpu_torch.train import fusion_hpo

    class Split:
        quantile = 0.99

        def get_device_preprocess(self):
            return lambda batch: batch

    data = {"tabular": np.zeros((4, 9), np.float32),
            "label": np.zeros(4, np.int32)}
    calls = [
        lambda: vmap_hpo.run_parallel_trials(
            TabularMLP(3, hidden=(4,)), vmap_hpo.stack_trial_hparams(
                [{"lr": 1e-3}]), data, data, batch_size=2, max_epochs=1,
            patience=1, class_weights=CW3),
        lambda: train_anat_cnn.percentile_normalizer(Split(), data, data),
        lambda: fusion_hpo.make_shared_towers_fn(
            {"tab": TabularMLP(3, hidden=(4,))},
            {"tab": TabularMLP(3, hidden=(4,)).state_dict()}),
    ]
    for call in calls:
        if torch.cuda.is_available():
            continue
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
