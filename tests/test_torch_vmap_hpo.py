"""The K-trial trainer (``train/vmap_hpo.py``) and the seed screen
(``train/seed_screen.py``) of the port.

Against JAX's ``run_parallel_trials``: a tiny ``TabularMLP`` and a tiny
``SmallPETCNN`` with K = 3 trials of different lr / l2 / focal gamma, the
JAX trials' initial variables carried across through ``init_fn`` with the
port's converter. The val history, the stop epochs and the returned losses
agree (val losses within rtol 1e-4: float32 Adam written two ways, over
up to 9 steps). Dropout is off there: the port's per-trial generators draw
other masks than JAX's ``fold_in`` keys (``ROADMAP.md`` section C).

Port against port: stacked trials equal solo runs bit for bit (every
trial has its own module, Adam and generators), the early-stopping replay,
the ``track_best`` snapshot, and ``lr_select`` with a traced 0.0 on a tiny
``AnatCNN`` (ResNet-10, (12, 14, 12)) leaving the backbone bit for bit.
The seed screen's winner follows JAX's ``test_seed_screen`` properties
(its continuation: ``test_torch_hpo_entry.py``).

``mesh=``: K = 4 trials of the MLP sharded over two gloo ranks
(``tests/torch_dp_ranks.py``) return the unsharded info dict bit for bit
(val history, stop epochs, ``track_best`` snapshot, final state), on every
rank, and so does a two-seed screen; a K that is not a multiple of the
ranks is refused, as in JAX.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.models.pet_models.pet_cnn import (
    SmallPETCNN as JaxSmallPETCNN,
)
from multimodal_alzheimer_tpu.models.tabular_models.tabular_mlp import (
    TabularMLP as JaxTabularMLP,
)
from multimodal_alzheimer_tpu.train import vmap_hpo as jax_vmap_hpo
from multimodal_alzheimer_tpu_torch.models.convert import (
    state_dict_from_flax,
)
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
    SmallPETCNN,
)
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp import (
    TabularMLP,
)
from multimodal_alzheimer_tpu_torch.parallel import Mesh
from multimodal_alzheimer_tpu_torch.parallel.launch import run_ranks
from multimodal_alzheimer_tpu_torch.train import vmap_hpo
from multimodal_alzheimer_tpu_torch.train.optim import EarlyStopping
from multimodal_alzheimer_tpu_torch.train.seed_screen import screen_seeds
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator
from torch_dp_ranks import trials_on_ranks
from torch_threads import torch_threads  # noqa: F401 (autouse)

CW3 = np.array([0.55, 0.75, 0.7], np.float32)
SEED = 7
VAL_TOL = dict(rtol=1e-4, atol=1e-6)


def tabular(n, seed=0, n_classes=3, rule_seed=42):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 9)).astype(np.float32)
    w = np.random.default_rng(rule_seed).normal(size=(9, n_classes))
    logits = x @ w + 0.5 * rng.normal(size=(n, n_classes))
    return {"tabular": x, "label": logits.argmax(axis=1).astype(np.int32)}


def pet(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"pet1451": (rng.normal(size=(n, 12, 12, 12)) * 0.5 + 0.5)
            .astype(np.float32),
            "label": rng.integers(0, 3, n).astype(np.int32)}


ROWS = [
    {"lr": 3e-3, "l2_reg": 0.0, "fl_gamma": None, "trial_seed": 11},
    {"lr": 3e-2, "l2_reg": 1e-2, "fl_gamma": 2, "trial_seed": 22},
    {"lr": 1e-3, "l2_reg": 1e-3, "fl_gamma": None, "trial_seed": 33},
]

CASES = {
    # name: (jax model, port model, train, val, batch, epochs, patience,
    #        jax apply hook)
    "mlp": (JaxTabularMLP(n_classes=3, hidden=(16, 32)),
            TabularMLP(3, hidden=(16, 32)),
            tabular(48, 0), tabular(40, 1), 16, 3, 1, None),
    # No BatchNorm: a conv bias before a train-mode BatchNorm has a zero
    # gradient up to rounding, which Adam's first steps scale to +-lr with
    # the rounding's sign, so the two packages' trajectories part there.
    # (JAX's plain pool path: the s2d_pool lowering is a TPU trick.)
    "pet": (JaxSmallPETCNN(n_classes=3, conv_out=(4, 8), filter_size=(3, 3),
                           linear_out=8, s2d_pool=False),
            SmallPETCNN(3, conv_out=(4, 8), filter_size=(3, 3),
                        linear_out=8),
            pet(16, 0), pet(12, 1), 8, 2, 1, "pet"),
}


def _jax_pet_apply(model, variables, batch, hp, rng, train):
    del hp, rng
    if train:
        return model.apply(variables, batch, train=True,
                           mutable=["batch_stats"])
    return model.apply(variables, batch, train=False), {}


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_run(request):
    """JAX's run of the case (compiled once per module) and its trials'
    initial variables."""
    jax_model, port_model, train, val, b, epochs, patience, hook = \
        CASES[request.param]
    hp = jax_vmap_hpo.stack_trial_hparams(ROWS)
    kwargs = dict(batch_size=b, max_epochs=epochs, patience=patience,
                  class_weights=CW3, seed=SEED)
    if hook == "pet":
        kwargs["apply_fn"] = _jax_pet_apply
    last, info = jax_vmap_hpo.run_parallel_trials(
        jax_model, hp, train, val, **kwargs)
    example = {k: jnp.asarray(v[:b]) for k, v in train.items()}
    init = [jax.device_get(jax_model.init(
        jax.random.fold_in(jax.random.PRNGKey(SEED), row["trial_seed"]),
        example, train=False)) for row in ROWS]
    return request.param, last, info, init


def test_run_parallel_trials_matches_jax(jax_run):
    name, last_ref, info_ref, init = jax_run
    _, port_model, train, val, b, epochs, patience, hook = CASES[name]
    by_seed = {vmap_hpo.trial_generator_seed(SEED, row["trial_seed"], 0): i
               for i, row in enumerate(ROWS)}

    def init_fn(model, generator, example, shared_example):
        trial = copy.deepcopy(model)
        variables = init[by_seed[generator.initial_seed()]]
        trial.load_state_dict(state_dict_from_flax(variables, trial))
        return trial

    kwargs = dict(batch_size=b, max_epochs=epochs, patience=patience,
                  class_weights=CW3, seed=SEED, init_fn=init_fn,
                  device="cpu")
    if hook == "pet":
        kwargs["apply_fn"] = vmap_hpo.plain_apply
    last, info = vmap_hpo.run_parallel_trials(
        port_model, vmap_hpo.stack_trial_hparams(ROWS), train, val,
        **kwargs)
    assert info["val_history"].shape == info_ref["val_history"].shape
    np.testing.assert_allclose(info["val_history"],
                               np.asarray(info_ref["val_history"]),
                               **VAL_TOL)
    np.testing.assert_array_equal(info["stopped_epoch"],
                                  np.asarray(info_ref["stopped_epoch"]))
    np.testing.assert_allclose(last, np.asarray(last_ref), **VAL_TOL)


DROPOUT_ROWS = [
    {"lr": 3e-3, "l2_reg": 0.0, "dropout_p": 0.0, "fl_gamma": None,
     "trial_seed": 11},
    {"lr": 1e-3, "l2_reg": 1e-2, "dropout_p": 0.3, "fl_gamma": 2,
     "trial_seed": 22},
    {"lr": 1e-4, "l2_reg": 1e-3, "dropout_p": 0.1, "fl_gamma": None,
     "trial_seed": 33},
]


def _mlp_run(rows, **kwargs):
    defaults = dict(batch_size=16, max_epochs=3, patience=10,
                    class_weights=CW3, seed=SEED, device="cpu")
    defaults.update(kwargs)
    return vmap_hpo.run_parallel_trials(
        TabularMLP(3, hidden=(16, 32)), vmap_hpo.stack_trial_hparams(rows),
        tabular(48, 0), tabular(48, 1), **defaults)


def test_stacked_trials_equal_solo_runs_and_the_stop_replay():
    """Width K and width 1 give the same trajectories bit for bit, dropout
    on; the stack order does not matter; early stopping replays
    ``EarlyStopping`` per trial and a stopped trial stays flat."""
    last, info = _mlp_run(DROPOUT_ROWS, max_epochs=6, patience=1)
    for i, row in enumerate(DROPOUT_ROWS):
        _, solo = _mlp_run([row], max_epochs=6, patience=1)
        np.testing.assert_array_equal(
            solo["val_history"][:, 0], info["val_history"][:, i])
    _, rev = _mlp_run(DROPOUT_ROWS[::-1], max_epochs=6, patience=1)
    np.testing.assert_array_equal(rev["val_history"][:, ::-1],
                                  info["val_history"])
    hist = info["val_history"]
    for i in range(len(DROPOUT_ROWS)):
        es = EarlyStopping(patience=1)
        stop = next((e for e in range(hist.shape[0])
                     if es.step(float(hist[e, i]))), hist.shape[0] - 1)
        assert info["stopped_epoch"][i] == stop
        assert last[i] == hist[stop, i]
        assert (hist[stop:, i] == hist[stop, i]).all()


def test_track_best_snapshot_rescores_to_the_best_epoch():
    rows = DROPOUT_ROWS
    _, info = _mlp_run(rows, max_epochs=5, track_best=True,
                       return_state=True)
    hist = info["val_history"]
    np.testing.assert_array_equal(info["best_val"], hist.min(axis=0))
    params, stats = info["best_carry"]
    assert all(v.shape[0] == len(rows) for v in params.values())
    val = tabular(48, 1)
    batch = {k: torch.from_numpy(v) for k, v in val.items()}
    for i, row in enumerate(rows):
        model = TabularMLP(3, hidden=(16, 32)).eval()
        model.load_state_dict({k: v[i] for k, v in {**params,
                                                    **stats}.items()})
        hp = vmap_hpo.trial_row(vmap_hpo.stack_trial_hparams(rows), i)
        with torch.no_grad():
            losses = [vmap_hpo.trial_criterion(
                model({k: v[s:s + 16] for k, v in batch.items()})["logits"],
                batch["label"][s:s + 16], torch.ones(16), hp, CW3).item()
                for s in range(0, 48, 16)]
        np.testing.assert_allclose(np.mean(losses), hist[:, i].min(),
                                   rtol=1e-6)
    adam = info["carry"][2]
    assert adam["step"].tolist() == [15.0] * 3
    assert set(adam["exp_avg"]) == set(params)


def _mri(n, seed):
    rng = np.random.default_rng(seed)
    return {"mri": rng.normal(0.5, 0.2, size=(n, 12, 14, 12))
            .astype(np.float32),
            "label": rng.integers(0, 3, n).astype(np.int32)}


def test_lr_select_zero_keeps_the_backbone_and_stacks_like_solo():
    """The MRI search's two-group ``lr_select``: the frozen trial (lr 0.0 on
    the backbone) keeps its backbone parameters bit for bit while its head
    moves and its BatchNorm statistics still move in train mode; the
    unfrozen trial moves both; each trial equals its solo run."""
    model = AnatCNN(3, resnet_depth=10, linear_out=(16,))
    rows = [{"lr": 1e-3, "lr_pretrained": None, "trial_seed": 1},
            {"lr": 1e-3, "lr_pretrained": 1e-3, "trial_seed": 2}]

    def lr_select(row, keys):
        return row["lr"] if keys[0] == "head" else row["lr_pretrained"]

    def run(rows):
        return vmap_hpo.run_parallel_trials(
            model, vmap_hpo.stack_trial_hparams(
                rows, extra_keys=("lr_pretrained",)),
            _mri(4, 0), _mri(4, 1), batch_size=4, max_epochs=2,
            patience=10, class_weights=CW3, seed=SEED,
            apply_fn=vmap_hpo.plain_apply, lr_select=lr_select,
            return_state=True, track_best=True, device="cpu")

    _, info = run(rows)
    params, stats, _ = info["carry"]
    init = [vmap_hpo._default_init(model, make_generator(
        vmap_hpo.trial_generator_seed(SEED, r["trial_seed"], 0)), None,
        None).state_dict() for r in rows]
    backbone = [k for k in params if k.startswith("backbone.")]
    head = [k for k in params if k.startswith("head.")]
    for k in backbone:
        torch.testing.assert_close(params[k][0], init[0][k], rtol=0, atol=0)
    assert any(not torch.equal(params[k][0], init[0][k]) for k in head)
    assert any(not torch.equal(params[k][1], init[1][k]) for k in backbone)
    assert any(not torch.equal(stats[k][0], init[0][k]) for k in stats
               if k.startswith("backbone.") and k.endswith("running_mean"))
    _, solo = run(rows[1:])
    np.testing.assert_array_equal(solo["val_history"][:, 0],
                                  info["val_history"][:, 1])


def test_mesh_is_refused():
    two_ranks = Mesh(None, 0, 2, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="not a multiple"):
        _mlp_run(DROPOUT_ROWS[:1], mesh=two_ranks)


def test_trials_sharded_over_ranks_match_one_process():
    model = TabularMLP(3, hidden=(16, 32))
    rows = ROWS + [dict(ROWS[0], lr=1e-1, trial_seed=44)]
    hp = vmap_hpo.stack_trial_hparams(rows)
    train, val = tabular(48, 0), tabular(40, 1)
    kwargs = dict(batch_size=16, max_epochs=6, patience=1,
                  class_weights=CW3, seed=SEED, track_best=True,
                  return_state=True)
    ranks = run_ranks(trials_on_ranks, 2, "gloo", model, hp, train, val,
                      kwargs, device="cpu", timeout=180)
    last, info = vmap_hpo.run_parallel_trials(model, hp, train, val,
                                              device="cpu", **kwargs)
    screen = screen_seeds(model, train, val, lr=3e-3, batch_size=16,
                          epochs=2, class_weights=CW3, seeds=(11, 22),
                          device="cpu")

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (tuple, list)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(a, torch.Tensor):
            torch.testing.assert_close(a.cpu(), b.cpu(), rtol=0, atol=0)
        else:
            np.testing.assert_array_equal(a, b)

    assert info["stopped_epoch"].min() < 5  # a trial stopped early
    for got_last, got_info, got_screen in ranks:
        np.testing.assert_array_equal(got_last, last)
        same(got_info, info)
        same(got_screen, screen)


def test_screen_selects_the_argmin_seed_and_its_snapshot():
    model = TabularMLP(3, hidden=(16, 32))
    val = tabular(48, 1)
    cw = [1 / 3] * 3
    screen = screen_seeds(model, tabular(64, 0), val, lr=3e-3,
                          batch_size=16, epochs=3, class_weights=cw,
                          seeds=(11, 22, 33), device="cpu")
    assert screen["winner_seed"] == screen["seeds"][screen["winner_index"]]
    assert screen["winner_index"] == int(screen["best_val"].argmin())
    assert screen["val_history"].shape == (3, 3)
    winner = TabularMLP(3, hidden=(16, 32)).eval()
    winner.load_state_dict(screen["winner_variables"])
    batch = {k: torch.from_numpy(v) for k, v in val.items()}
    hp = {"fl_gamma": 0.0, "use_focal": 0.0}
    with torch.no_grad():
        losses = [vmap_hpo.trial_criterion(
            winner({k: v[s:s + 16] for k, v in batch.items()})["logits"],
            batch["label"][s:s + 16], torch.ones(16), hp, cw).item()
            for s in range(0, 48, 16)]
    np.testing.assert_allclose(np.mean(losses), screen["best_val"].min(),
                               rtol=1e-6)


def test_screen_raises_when_every_seed_diverges():
    model = TabularMLP(3, hidden=(16,))
    with pytest.raises(RuntimeError, match="finite val loss"):
        screen_seeds(model, tabular(64, 0), tabular(48, 1), lr=1e20,
                     batch_size=16, epochs=2, class_weights=[1 / 3] * 3,
                     seeds=(1, 2), device="cpu")


def test_screen_lr_select_zero_keeps_the_init():
    model = TabularMLP(3, hidden=(16,))
    screen = screen_seeds(
        model, tabular(64, 0), tabular(48, 1), lr=3e-3, batch_size=16,
        epochs=2, class_weights=[1 / 3] * 3, seeds=(7,),
        extra_hparams={"lr_pretrained": None},
        lr_select=lambda row, keys: row["lr_pretrained"], device="cpu")
    init = vmap_hpo._default_init(model, make_generator(
        vmap_hpo.trial_generator_seed(5, 7, 0)), None, None)
    for name, value in init.state_dict().items():
        torch.testing.assert_close(screen["winner_variables"][name], value,
                                   rtol=0, atol=0)
