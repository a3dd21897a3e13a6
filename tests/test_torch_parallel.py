"""Data parallelism of the port over two gloo ranks (after
tests/test_parallel.py): the DP step equals the single-device step.

Two spawned CPU ranks (``parallel.launch.run_ranks``, rank functions in
``tests/torch_dp_ranks.py``) run every case of this file in one spawn; the
one-process port and JAX's single-device step run here. Cases:

* ``SmallPETCNN`` with BatchNorm, 3 SGD steps on a batch of 16 at 16^3,
  class weights [0.5, 0.3, 0.2] (JAX's ``test_dp_matches_single_device``);
* ``AnatCNN`` depth 10 at (12, 14, 12), batch 4, 2 SGD steps, with
  ``fused_bn`` False, "full", "hybrid" and "torch_stats" (JAX's Pallas
  BatchNorm in interpret mode);
* an unbalanced batch, rank 0 holding class 0 only: loss and gradients
  equal the single-device ones within rtol 1e-5 (the gradients with an
  atol of 1e-5 of their module's largest, the float32 noise of summing in
  another order), where an average of the ranks' weighted means (what DDP
  computes) is off by more than 1e-2;
* dropout on: the ranks draw the single-device mask between them;
* Adam: the loss falls over 6 steps;
* the shard layout.

Tolerances. DP against the one-process port: JAX's DP tolerances (loss
rtol 1e-5; parameters and running statistics rtol 2e-4, atol 1e-5): the
ranks sum in another order. DP against JAX: the cross-framework
tolerances of tests/test_torch_train.py (loss rtol 1e-4; running
statistics rtol 2e-4, atol 2e-5) and for the parameters after SGD rtol
2e-4 with atol 1e-5; ``SmallPETCNN``'s JAX step is compiled without XLA's
fusion pass (``torch_port_helpers.run_unfused``'s reason).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.losses import make_criterion as jax_criterion
from multimodal_alzheimer_tpu.models import SmallPETCNN as JaxSmallPETCNN
from multimodal_alzheimer_tpu.models.mri_models.anat_cnn import (
    AnatCNN as JaxAnatCNN,
)
from multimodal_alzheimer_tpu_torch.models.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from multimodal_alzheimer_tpu_torch.parallel.launch import run_ranks
from torch_dp_ranks import (
    AnatCNN,
    SmallPETCNN,
    cases_on_ranks,
    run_case,
)
from torch_port_helpers import flat, random_flax_variables
from torch_threads import torch_threads  # noqa: F401 (autouse)

WORLD = 2
PET_HP = {"n_classes": 3, "conv_out": (4, 8), "filter_size": (3, 3),
          "linear_out": 16, "batchnorm": True}
ANAT_HP = {"n_classes": 3, "resnet_depth": 10}
ANAT_SHAPE = (12, 14, 12)
WEIGHTS = {"loss_class_weights": [0.5, 0.3, 0.2]}
FUSED = [False, "full", "hybrid", "torch_stats"]
DP_LOSS = dict(rtol=1e-5)
DP_TOL = dict(rtol=2e-4, atol=1e-5)
JAX_LOSS = dict(rtol=1e-4)
JAX_STATS = dict(rtol=2e-4, atol=2e-5)
JAX_PARAMS = dict(rtol=2e-4, atol=1e-5)


def _pet_batch(n=16, seed=0, labels=None):
    rng = np.random.default_rng(seed)
    return {"pet1451": rng.normal(size=(n, 16, 16, 16)).astype(np.float32),
            "label": (rng.integers(0, 3, n) if labels is None
                      else np.asarray(labels)).astype(np.int32)}


def _pair(jax_model, port_cls, hp, shape, seed, input_key, **overrides):
    variables = random_flax_variables(jax_model, shape, seed, input_key)
    port = port_cls.from_hparams(hp, **overrides)
    return variables, state_dict_from_flax(variables, port)


def _pet_case(hp=PET_HP, **extra):
    jax_model = JaxSmallPETCNN.from_hparams(hp)
    variables, state = _pair(jax_model, SmallPETCNN, hp, (16, 16, 16), 0,
                             "pet1451")
    case = {"kind": "small_pet", "hp": hp, "state": state,
            "batch": _pet_batch(), "steps": 3, "lr": 1e-2,
            "criterion": WEIGHTS}
    case.update(extra)
    return case, jax_model, variables


def _anat_case(fused):
    jax_model = JaxAnatCNN.from_hparams(ANAT_HP, fused_bn=fused)
    variables, state = _pair(jax_model, AnatCNN, ANAT_HP, ANAT_SHAPE, 1,
                             "mri", fused_bn=fused)
    rng = np.random.default_rng(5)
    batch = {"mri": rng.normal(size=(4,) + ANAT_SHAPE).astype(np.float32),
             "label": np.array([0, 1, 2, 0], np.int32)}
    case = {"kind": "anat", "hp": ANAT_HP, "overrides": {"fused_bn": fused},
            "state": state, "batch": batch, "steps": 2, "lr": 1e-2,
            "criterion": WEIGHTS}
    return case, jax_model, variables


def _cases():
    cases = {"pet": _pet_case()[0]}
    for fused in FUSED:
        cases[f"anat-{fused}"] = _anat_case(fused)[0]
    cases["unbalanced"] = _pet_case(
        batch=_pet_batch(8, 3, [0, 0, 0, 0, 1, 2, 1, 2]), steps=1)[0]
    cases["dropout"] = _pet_case(
        dict(PET_HP, dropout_conv_p=0.1, dropout_dense_p=0.3),
        steps=2, dropout_seed=7)[0]
    cases["adam"] = _pet_case(dict(PET_HP, lr=1e-3), criterion={},
                              adam=True, lr=1e-3, steps=6)[0]
    return cases


def _layout_batch():
    return {k: torch.from_numpy(v) for k, v in _pet_batch().items()}


@pytest.fixture(scope="module")
def dp():
    """(cases, one-process results, every rank's results) of one spawn."""
    cases = _cases()
    with ThreadPoolExecutor(1) as pool:  # the one-process runs meanwhile
        one = pool.submit(lambda: {name: run_case(case)
                                   for name, case in cases.items()})
        ranks = run_ranks(cases_on_ranks, WORLD, "gloo", cases,
                          _layout_batch(), device="cpu", timeout=240)
        return cases, one.result(), ranks


def _close_state(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   err_msg=key, **tol)


def _jax_sgd(model, variables, batch, steps, lr, unfused):
    """JAX's single-device SGD steps (``train.state.make_train_step`` with
    ``optax.sgd``): losses and the final flax tree."""
    criterion = jax_criterion(WEIGHTS)

    def step(params, stats, b):
        def loss_fn(p):
            out, mutated = model.apply({"params": p, "batch_stats": stats},
                                       b, train=True, mutable=["batch_stats"])
            return criterion(out["logits"], b["label"]), \
                mutated["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        return jax.tree.map(lambda p, g: p - lr * g, params, grads), \
            new_stats, loss

    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    lowered = jax.jit(step).lower(params, stats, b)
    fn = lowered.compile({"xla_disable_hlo_passes": "fusion"} if unfused
                         else None)
    losses = []
    for _ in range(steps):
        params, stats, loss = fn(params, stats, b)
        losses.append(float(loss))
    return losses, {"params": flat(params), "batch_stats": flat(stats)}


def _against_jax(got: dict, losses, want: dict):
    np.testing.assert_allclose(got["losses"], losses, **JAX_LOSS)
    tree = flax_from_state_dict(got["state"])
    for collection, tol in (("params", JAX_PARAMS),
                            ("batch_stats", JAX_STATS)):
        mine = flat(tree[collection])
        assert set(mine) == set(want[collection])
        for key, value in want[collection].items():
            np.testing.assert_allclose(mine[key], value, err_msg=str(key),
                                       **tol)


def _against_one_process(dp, name):
    _, one, ranks = dp
    for rank in ranks:
        got = rank[name]
        np.testing.assert_allclose(got["losses"], one[name]["losses"],
                                   **DP_LOSS)
        _close_state(got["state"], one[name]["state"], **DP_TOL)
        np.testing.assert_array_equal(got["labels"].numpy(),
                                      one[name]["labels"].numpy())
    return ranks[0][name]


def test_dp_small_pet_cnn_matches_jax_single_device(dp):
    got = _against_one_process(dp, "pet")
    case, jax_model, variables = _pet_case()
    losses, want = _jax_sgd(jax_model, variables, case["batch"], 3, 1e-2,
                            unfused=True)
    _against_jax(got, losses, want)


@pytest.mark.parametrize("fused", FUSED)
def test_dp_anat_cnn_matches_jax_single_device(dp, fused, monkeypatch):
    """Every BatchNorm kind: the kernels' all-reduced sums (full, hybrid)
    and the all-reduced moments (flax, torch_stats); running statistics
    included."""
    from multimodal_alzheimer_tpu.ops import pallas_bn

    monkeypatch.setattr(pallas_bn, "INTERPRET", True)
    got = _against_one_process(dp, f"anat-{fused}")
    case, jax_model, variables = _anat_case(fused)
    losses, want = _jax_sgd(jax_model, variables, case["batch"], 2, 1e-2,
                            unfused=False)
    _against_jax(got, losses, want)


def test_dp_collectives_per_step(dp):
    """A ResNet-10 step: one all-reduce per BatchNorm forward and one per
    backward (12 BatchNorms), the class-weight sum, the gradients, the
    loss and the gathered logits and labels."""
    _, _, ranks = dp
    for rank in ranks:
        for fused in FUSED:
            assert rank[f"anat-{fused}"]["counts"] == {
                "all_reduce": 2 * (2 * 12 + 5), "broadcast": 1}


def test_dp_unbalanced_labels_match_single_device(dp):
    """Rank 0 holds class 0 only: sum_local(w nll) / sum_global(w) gives the
    single-device loss and gradients; the average of the ranks' weighted
    means does not."""
    cases, one, ranks = dp
    want = one["unbalanced"]
    for rank in ranks:
        got = rank["unbalanced"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        assert set(got["grads"]) == set(want["grads"])
        for name, g in want["grads"].items():
            # at the scale of the module's largest gradient: a conv bias
            # under BatchNorm has gradient 0 but for rounding
            module = name.rpartition(".")[0]
            scale = max(float(v.abs().max()) for k, v in want["grads"].items()
                        if k.rpartition(".")[0] == module)
            np.testing.assert_allclose(
                got["grads"][name].numpy(), g.numpy(), rtol=1e-5,
                atol=1e-5 * scale, err_msg=name)
    # what averaging per-rank weighted means would report instead
    model = SmallPETCNN.from_hparams(PET_HP)
    model.load_state_dict(cases["unbalanced"]["state"])
    batch = {k: torch.from_numpy(v)
             for k, v in cases["unbalanced"]["batch"].items()}
    w = torch.tensor(WEIGHTS["loss_class_weights"])
    with torch.no_grad():
        logits = model.train()(batch)["logits"]
    nll = torch.nn.functional.cross_entropy(logits, batch["label"].long(),
                                            reduction="none")
    wy = w[batch["label"].long()]
    halves = [(wy[s] * nll[s]).sum() / wy[s].sum()
              for s in (slice(0, 4), slice(4, 8))]
    averaged = float(sum(halves) / 2)
    assert abs(averaged - want["losses"][0]) > 1e-2


def test_dp_dropout_matches_single_device(dp):
    """Dropout on: each rank keeps its rows of the global mask."""
    got = _against_one_process(dp, "dropout")
    # the masks are drawn: the run differs from the dropout-free one
    assert got["losses"][0] != dp[1]["pet"]["losses"][0]


def test_dp_adam_trains(dp):
    _, one, ranks = dp
    for rank in ranks:
        losses = rank["adam"]["losses"]
        assert losses[-1] < losses[0]
        np.testing.assert_allclose(losses[0], one["adam"]["losses"][0],
                                   **DP_LOSS)


def test_batch_sharding_layout(dp):
    batch = _layout_batch()
    for r, rank in enumerate(dp[2]):
        got = rank["layout"]
        assert got["offset"] == 8 * r and got["global_rows"] == 16
        assert got["shard"]["pet1451"].shape == (8, 16, 16, 16)
        for k, v in batch.items():
            torch.testing.assert_close(got["shard"][k], v[8 * r:8 * r + 8],
                                       rtol=0, atol=0)
        assert not got["replicated"]
        assert got["odd_refused"]
    first, second = (rank["layout"] for rank in dp[2])
    for name, value in first["weights"].items():  # rank 0's everywhere
        torch.testing.assert_close(second["weights"][name], value, rtol=0,
                                   atol=0)
    for mine, theirs in zip(first["adam"], second["adam"]):
        torch.testing.assert_close(theirs, mine, rtol=0, atol=0)
    assert (first["sub"], second["sub"]) == ((0, 1), None)
