"""Tensor and spatial parallelism of the port (after tests/test_tp.py): the
(data, model, spatial) step equals the single-device step.

One spawn of eight gloo CPU ranks (``parallel.launch.run_ranks``, rank
functions in ``tests/torch_tp_ranks.py``) runs every mesh case of this file;
each case builds its mesh over the first ranks and the others return None.
Meanwhile the one-process port and JAX run here. Cases:

* JAX's three, on the torch layouts: ``param_spec``'s rules (every tensor
  of an AnatCNN mapped to its flax layout gets JAX's spec), the parameters
  actually sharded (a rank holds half of ``layer1_block0.conv1``'s O, and
  the same slice of the BatchNorm statistics and Adam moments), and a
  second step keeping the shards;
* one SGD step of AnatCNN depth 10 at (12, 14, 12), batch 4, on weights
  converted from JAX, z-score in the step, on a (2, 2, 2) mesh with
  ``fused_bn`` False, "full" and "hybrid": against the one-process port
  (JAX's tp tolerances: loss rtol 1e-5; parameters and running statistics
  after ``gather_state`` rtol 2e-4, atol 1e-5) and against JAX's
  single-device step (the cross-framework tolerances of
  tests/test_torch_parallel.py: loss rtol 1e-4; running statistics rtol
  2e-4, atol 2e-5; parameters rtol 2e-4, atol 1e-5); with False also
  against JAX's own ``shard_state`` / ``shard_batch_3d`` step on its eight
  CPU devices;
* ``make_eval_step`` on the mesh: loss, logits and the gathered
  ``backbone_gap`` of the global batch on every rank;
* the gradients summed over data x spatial only: the classifier's bias,
  whole on every model rank, has the same gradient on all eight ranks and
  the one-process gradient;
* ``maxpool_impl="wf"`` (K8 on depth windows) on a (1, 1, 2) mesh;
* ``halo_planes`` forward and backward with halos wider than a
  neighbour's slab (a depth of 4 over 8 ranks) and with 91 planes split
  46 + 45, the planes each exchange moves read from ``Mesh3D.counts``;
* the stem pool through K8's window on a (1, 1, 4) mesh, the K3 split and
  K8 window plain versions against the whole-volume ones, and the min-max
  preprocess on a spatial axis equal to the unsharded one.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_alzheimer_tpu.losses import make_criterion as jax_criterion
from multimodal_alzheimer_tpu.models.mri_models.anat_cnn import (
    AnatCNN as JaxAnatCNN,
)
from multimodal_alzheimer_tpu.ops.normalization import mri_per_scan_zscore
from multimodal_alzheimer_tpu.parallel import tp as jax_tp
from multimodal_alzheimer_tpu.train import TrainState as JaxTrainState
from multimodal_alzheimer_tpu.train import make_train_step as jax_train_step
from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.models.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from multimodal_alzheimer_tpu_torch.ops import hopper_norm
from multimodal_alzheimer_tpu_torch.ops.hopper_maxpool import (
    max_pool3d_backward,
)
from multimodal_alzheimer_tpu_torch.ops.maxpool import (
    max_pool3d_backward_plain,
    pool_forward,
    pool_forward_window,
    window_outputs,
)
from multimodal_alzheimer_tpu_torch.parallel import tp
from multimodal_alzheimer_tpu_torch.parallel.launch import run_ranks
from torch_port_helpers import flat, random_flax_variables
from torch_threads import torch_threads  # noqa: F401 (autouse)
from torch_tp_ranks import AnatCNN, MINMAX, step_case, tp_on_ranks

WORLD = 8
HP = {"n_classes": 3, "resnet_depth": 10}
SHAPE = (12, 14, 12)
FUSED = [False, "full", "hybrid"]
WEIGHTS = {"loss_class_weights": [0.5, 0.3, 0.2]}
LR = 1e-2
TP_LOSS = dict(rtol=1e-5)
TP_TOL = dict(rtol=2e-4, atol=1e-5)
JAX_LOSS = dict(rtol=1e-4)
JAX_STATS = dict(rtol=2e-4, atol=2e-5)
JAX_PARAMS = dict(rtol=2e-4, atol=1e-5)
HALO = {
    # 4 planes over 8 ranks (1, 1, 1, 1, 0, 0, 0, 0): a halo of 3 reads
    # three neighbours' slabs, and empty slabs still serve and receive
    "wide": {"mesh": (1, 1, 8), "depth": 4, "widths": [(3, 3), (2, 1)],
             "seed": 1},
    # 91 planes split 46 + 45; the second halo reaches across the
    # neighbour's whole slab into the padding
    "uneven": {"mesh": (1, 1, 2), "depth": 91, "widths": [(5, 7), (50, 50)],
               "seed": 2},
}


def _name(fused) -> str:
    return f"fused-{fused}"


def _batch(n=4, seed=5, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return {"mri": rng.normal(900, 400, (n,) + shape).astype(np.float32),
            "mri_mask": (rng.random((n,) + shape) > 0.35).astype(np.float32),
            "label": np.array([0, 1, 2, 0], np.int32)[:n]}


def _cases(weights: str) -> dict:
    base = {"hp": HP, "weights": weights, "batch": _batch(), "steps": 1,
            "lr": LR, "criterion": WEIGHTS, "mesh": (2, 2, 2)}
    cases = {_name(f): dict(base, overrides={"fused_bn": f}) for f in FUSED}
    cases[_name(False)]["steps"] = 2  # the second step keeps the shards
    cases["wf"] = dict(base, mesh=(1, 1, 2),
                       overrides={"fused_bn": "full", "maxpool_impl": "wf"})
    cases["bf16"] = dict(base, mesh=(1, 2, 2), overrides={
        "fused_bn": "full", "maxpool_impl": "wf", "dtype": torch.bfloat16})
    # the same step with a planted fault, which the bf16 rule must fail
    cases["bf16 dropped halo"] = dict(cases["bf16"], fault=True)
    return cases


def _bumped(case: dict) -> dict:
    """The case with its scans moved one bfloat16 ulp up (the control of
    the bf16 tolerance)."""
    mri = torch.from_numpy(case["batch"]["mri"]).to(torch.bfloat16)
    up = torch.nextafter(mri, torch.full_like(mri, float("inf")))
    return dict(case, batch=dict(case["batch"],
                                 mri=up.to(torch.float32).numpy()))


def _jax_preprocess(batch):
    out = dict(batch)
    out["mri"] = jax.vmap(mri_per_scan_zscore)(out["mri"],
                                               out.pop("mri_mask"))
    return out


def _jax_step(variables, batch, fused, mesh3=None):
    """JAX's train step (``make_train_step`` with the z-score preprocess and
    ``optax.sgd``), single-device or on ``mesh3``: the loss and the flax
    trees after it."""
    from multimodal_alzheimer_tpu.ops import pallas_bn

    model = JaxAnatCNN.from_hparams(HP, fused_bn=fused)
    sgd = optax.sgd(LR)
    state = JaxTrainState.create(jax.tree.map(jnp.asarray, variables), sgd)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    if mesh3 is not None:
        state = jax_tp.shard_state(state, mesh3)
        b = jax_tp.shard_batch_3d(b, mesh3)
    step = jax_train_step(model, jax_criterion(WEIGHTS), sgd,
                          _jax_preprocess)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_bn, "INTERPRET", True)
        state, aux = step(state, b, jax.random.PRNGKey(1))
    return float(aux["loss"]), {"params": flat(state.params),
                                "batch_stats": flat(state.batch_stats)}


def _reference(cases: dict, variables) -> dict:
    """The one-process port and JAX's steps, run while the ranks run."""
    one = {name: step_case(case) for name, case in cases.items()
           if not case.get("fault")}
    one["bf16 +1 ulp"] = step_case(_bumped(cases["bf16"]))
    batch = cases[_name("full")]["batch"]
    jax_one = {f: _jax_step(variables, batch, f) for f in FUSED}
    sharded = None
    if len(jax.devices()) >= 8:
        sharded = _jax_step(variables, batch, False,
                            jax_tp.make_mesh_3d(2, 2, 2))
    return {"one": one, "jax": jax_one, "jax_sharded": sharded}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(cases, references, every rank's results) of one spawn."""
    variables = random_flax_variables(JaxAnatCNN.from_hparams(HP), SHAPE, 1,
                                      "mri")
    port = AnatCNN.from_hparams(HP)
    weights = os.path.join(tmp_path_factory.mktemp("tp"), "weights.pt")
    torch.save(state_dict_from_flax(variables, port), weights)
    cases = _cases(weights)
    minmax = {k: v for k, v in _batch(2, 9).items() if k != "label"}
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(_reference, cases, variables)
        ranks = run_ranks(tp_on_ranks, WORLD, "gloo", cases, HALO, minmax,
                          device="cpu", timeout=300)
        return cases, ref.result(), ranks


def _close_state(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   err_msg=key, **tol)


def _on_mesh(ranks, name):
    return [(r, rank[name]) for r, rank in enumerate(ranks)
            if rank[name] is not None]


# --------------------------------------------------------------- layouts --


def _jax_layout(shape: tuple) -> tuple:
    """The flax shape of a torch tensor of ``shape``: conv (O, I, k, k, k)
    -> (k, k, k, I, O), dense (out, in) -> (in, out)."""
    if len(shape) == 5:
        return shape[2:] + (shape[1], shape[0])
    if len(shape) == 2:
        return (shape[1], shape[0])
    return shape


def _jax_spec(spec: tuple, ndim: int) -> tuple:
    spec = tuple(spec) + (None,) * (ndim - len(spec)) if spec else ()
    if ndim == 5 and spec:
        return spec[2:] + (spec[1], spec[0])
    if ndim == 2 and spec:
        return (spec[1], spec[0])
    return spec


def test_param_spec_rules():
    """JAX's cases on the torch layouts, then every tensor of an AnatCNN:
    the port's spec, mapped to the flax layout, is JAX's for the flax
    tensor."""
    n = 2
    assert tp.param_spec((), torch.zeros(128, 64, 3, 3, 3), n) == \
        tp.P(tp.MODEL_AXIS, None, None, None, None)
    assert tp.param_spec((), torch.zeros(3, 512), n) == tp.P(None,
                                                             tp.MODEL_AXIS)
    assert tp.param_spec((), torch.zeros(64), n) == tp.P(tp.MODEL_AXIS)
    assert tp.param_spec((), torch.zeros(3), n) == tp.P()  # indivisible
    assert tp.param_spec((), torch.zeros(()), n) == tp.P()  # scalar
    assert tp.param_spec((), torch.zeros(3, 64, 3, 3, 3), n) == tp.P()
    assert tp.batch_spec("mri", torch.zeros(4, 8, 8, 8)) == \
        tp.P("data", "spatial")
    assert tp.batch_spec("label", torch.zeros(4)) == tp.P("data")
    model = AnatCNN.from_hparams(dict(HP, linear_out=(16,),
                                      batchnorm_dense=True))
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        want = jax_tp.param_spec((), jnp.zeros(_jax_layout(shape)), n)
        got = tp.param_spec(name, t, n)
        assert tuple(want) == _jax_spec(got, len(shape)), name


def test_params_are_actually_sharded(run):
    """A rank holds half of ``layer1_block0.conv1``'s O (and the same half
    of its Adam moment), half of the stem BatchNorm's statistics and half
    of the classifier's input features; the bias stays whole. The batch:
    the data rank's rows, the spatial rank's depth slab."""
    cases, _, ranks = run
    batch = cases[_name("full")]["batch"]
    for r, got in _on_mesh(ranks, "layout"):
        d, m, s = got["coords"]
        assert (d, m, s) == (r // 4, (r // 2) % 2, r % 2)
        half = slice(32 * m, 32 * (m + 1))
        assert got["conv1"].shape == (32, 64, 3, 3, 3)
        torch.testing.assert_close(got["conv1"], got["conv1_full"][half],
                                   rtol=0, atol=0)
        torch.testing.assert_close(got["adam"], got["adam_full"][half],
                                   rtol=0, atol=0)
        torch.testing.assert_close(got["bn_mean"], got["bn_full"][half],
                                   rtol=0, atol=0)
        assert got["cls"].shape == (3, 256) and got["cls_bias"].shape == (3,)
        assert got["specs"]["backbone.layer1_block0.conv1.weight"] == \
            tp.P("model", None, None, None, None)
        assert got["specs"]["head.cls.bias"] == tp.P()
        assert got["offset"] == 2 * d and got["depths"] == {(14, 12): 12}
        rows, slab = slice(2 * d, 2 * d + 2), slice(6 * s, 6 * s + 6)
        np.testing.assert_array_equal(got["shard"]["mri"].numpy(),
                                      batch["mri"][rows, slab])
        np.testing.assert_array_equal(got["shard"]["label"].numpy(),
                                      batch["label"][rows])


def test_second_step_keeps_shards(run):
    _, _, ranks = run
    for _, got in _on_mesh(ranks, _name(False)):
        assert len(got["losses"]) == 2 and np.isfinite(got["losses"]).all()
        assert got["conv1_shape"] == (32, 64, 3, 3, 3)


def test_make_mesh_3d_refuses_too_few_ranks(run):
    assert run[2][0]["too_many"] == "need 16 devices, have 8"


# ------------------------------------------------------------------ step --


def _against_one_process(run, name, want_name=None):
    _, ref, ranks = run
    want = ref["one"][want_name or name]
    on = _on_mesh(ranks, name)
    for _, got in on:
        np.testing.assert_allclose(got["losses"], want["losses"], **TP_LOSS)
        np.testing.assert_array_equal(got["labels"].numpy(),
                                      want["labels"].numpy())
        np.testing.assert_allclose(got["state_sum"], on[0][1]["state_sum"],
                                   rtol=1e-12)
    lead = on[0][1]
    _close_state(lead["state"], want["state"], **TP_TOL)
    np.testing.assert_allclose(lead["logits"].numpy(),
                               want["logits"].numpy(), rtol=1e-4, atol=1e-5)
    return lead


def _against_jax(got: dict, loss: float, want: dict):
    np.testing.assert_allclose(got["losses"][0], loss, **JAX_LOSS)
    tree = flax_from_state_dict(got["state"])
    for collection, tol in (("params", JAX_PARAMS),
                            ("batch_stats", JAX_STATS)):
        mine = flat(tree[collection])
        assert set(mine) == set(want[collection])
        for key, value in want[collection].items():
            np.testing.assert_allclose(mine[key], value, err_msg=str(key),
                                       **tol)


@pytest.mark.parametrize("fused", FUSED)
def test_tp_step_matches_one_process_and_jax(run, fused):
    """The (2, 2, 2) step against the one-process port and JAX's
    single-device step; every BatchNorm kind, running statistics
    included."""
    got = _against_one_process(run, _name(fused))
    loss, want = run[1]["jax"][fused]
    _against_jax(got, loss, want)


def test_tp_step_matches_jax_sharded_step(run):
    """Against JAX's own (2, 2, 2) step (``shard_state``,
    ``shard_batch_3d``) where JAX has eight devices."""
    sharded = run[1]["jax_sharded"]
    if sharded is None:
        pytest.skip("needs 8 JAX devices")
    got = _on_mesh(run[2], _name(False))[0][1]
    _against_jax(got, *sharded)


def test_gradients_sum_over_data_and_spatial_only(run):
    """The classifier's bias is whole on every model rank: after the sum
    over data x spatial every rank holds the same gradient, the
    one-process one (a sum over the model ranks too would double it). A
    sharded kernel's gathered gradient is the one-process gradient."""
    _, ref, ranks = run
    for fused in FUSED:
        want = ref["one"][_name(fused)]["grads"]
        on = _on_mesh(ranks, _name(fused))
        first = on[0][1]["cls_bias_grad"]
        for _, got in on:
            torch.testing.assert_close(got["cls_bias_grad"], first, rtol=0,
                                       atol=0)
        np.testing.assert_allclose(first.numpy(),
                                   want["head.cls.bias"].numpy(), rtol=1e-5,
                                   atol=1e-7)
        lead = on[0][1]["grads"]
        assert set(lead) == set(want)
        for name, g in want.items():
            scale = float(g.abs().max())
            np.testing.assert_allclose(lead[name].numpy(), g.numpy(),
                                       rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=name)


def test_tp_collectives_per_step(run):
    """A (2, 2, 2) ResNet-10 step: every windowed op (13: stem conv and
    pool, 11 block convs) fetches its halo forward, and all but the stem
    conv (whose input needs no gradient) send it back; halos move a few
    planes, never a slab."""
    for fused in FUSED:
        for _, got in _on_mesh(run[2], _name(fused)):
            counts = got["counts"]
            assert counts["halo"] == 25
            assert counts["halo_planes"] <= 2 * counts["halo"]
            assert counts["reduce_scatter"] == 11  # one per block conv


@pytest.mark.parametrize("name", [_name(f) for f in FUSED] + ["wf"])
def test_eval_step_on_the_mesh(run, name):
    """``make_eval_step`` on the mesh after the steps: the loss over the
    data axis, the logits and the ``backbone_gap`` tap (gathered over the
    model ranks) of the global batch on every rank, against one process."""
    _, ref, ranks = run
    want = ref["one"][name]["eval"]
    for _, got in _on_mesh(ranks, name):
        got = got["eval"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        for key in ("logits", "gap"):
            assert got[key].shape == want[key].shape
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=key)


def test_wf_on_a_spatial_pair(run):
    """``maxpool_impl="wf"`` on a (1, 1, 2) mesh: the stem pool's backward
    is K8's window on each slab (its plain version on the CPU)."""
    _against_one_process(run, "wf")


# chip_smoke.py's bf16 rule (BF16_FLOOR_FACTOR, BF16_FLOOR_SLACK): twice
# the gap that moving the scans one bf16 ulp opens between two steps of
# one process, plus 1e-3 relative for a control that happens to move
# little.
BF16_FACTOR, BF16_SLACK = 2.0, 1e-3


def _bf16_gaps(got: dict, want: dict) -> tuple:
    """(relative loss gap, largest relative gap of a parameter's gradient
    norm) of a step against another."""
    loss = abs(got["losses"][0] - want["losses"][0]) / abs(want["losses"][0])
    worst = max(abs(float(got["grads"][k].norm()) - float(g.norm()))
                / max(float(g.norm()), 1e-30)
                for k, g in want["grads"].items())
    return loss, worst


def test_bf16_step_on_a_1_2_2_mesh(run):
    """A bf16 AnatCNN step (``fused_bn="full"``, ``maxpool_impl="wf"``) on
    a (1, 2, 2) mesh against the same step in one process: the loss and
    every parameter's gradient norm within twice the gap that the scans
    moved one bf16 ulp open in one process, plus 1e-3; every rank's
    gradient of the classifier bias the same."""
    _, ref, ranks = run
    want, control = ref["one"]["bf16"], ref["one"]["bf16 +1 ulp"]
    on = _on_mesh(ranks, "bf16")
    assert len(on) == 4
    first = on[0][1]
    ctl_loss, ctl_worst = _bf16_gaps(control, want)
    loss, worst = _bf16_gaps(first, want)
    assert ctl_loss > 0 or ctl_worst > 0  # the control moved the step
    assert loss <= BF16_FACTOR * ctl_loss + BF16_SLACK, (loss, ctl_loss)
    assert worst <= BF16_FACTOR * ctl_worst + BF16_SLACK, (worst, ctl_worst)
    for _, got in on:
        assert np.isfinite(got["losses"]).all()
        torch.testing.assert_close(got["cls_bias_grad"],
                                   first["cls_bias_grad"], rtol=0, atol=0)


def test_bf16_rule_fails_a_dropped_halo(run):
    """The bf16 case's step with a planted fault (spatial rank 1 zeroes
    the planes its depth windows receive from rank 0) fails the rule of
    ``test_bf16_step_on_a_1_2_2_mesh`` on the loss and on the gradient
    norms: the rule separates a wrong sharded step from bf16 rounding."""
    _, ref, ranks = run
    want, control = ref["one"]["bf16"], ref["one"]["bf16 +1 ulp"]
    on = _on_mesh(ranks, "bf16 dropped halo")
    assert len(on) == 4
    ctl_loss, ctl_worst = _bf16_gaps(control, want)
    loss, worst = _bf16_gaps(on[0][1], want)
    assert loss > BF16_FACTOR * ctl_loss + BF16_SLACK, (loss, ctl_loss)
    assert worst > BF16_FACTOR * ctl_worst + BF16_SLACK, (worst, ctl_worst)


# ---------------------------------------------------------------- halos --


def _padded(volume: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    depth = volume.shape[2]
    parts = []
    if lo < 0:
        parts.append(torch.zeros(volume.shape[:2] + (min(hi, 0) - lo,)
                                 + volume.shape[3:]))
    parts.append(volume[:, :, max(lo, 0):min(hi, depth)])
    if hi > depth:
        parts.append(torch.zeros(volume.shape[:2] + (hi - max(lo, depth),)
                                 + volume.shape[3:]))
    return torch.cat(parts, dim=2)


@pytest.mark.parametrize("name", sorted(HALO))
def test_halo_planes(run, name):
    """Each rank's window is the global planes [lo, hi) (zeros outside the
    volume); each slab's gradient adds every rank's cotangent of its
    planes; an exchange receives only the planes of the window that other
    ranks hold, forward and backward."""
    args = HALO[name]
    on = _on_mesh(run[2], "halo")
    on = [(r, got[name]) for r, got in on if got[name] is not None]
    depth = args["depth"]
    n = args["mesh"][2]
    for i, (wl, wh) in enumerate(args["widths"]):
        volume = on[0][1]["volume"]
        grad = torch.zeros_like(volume, dtype=torch.float64)
        padded = torch.zeros(volume.shape[:2] + (depth + 200,)
                             + volume.shape[3:], dtype=torch.float64)
        for r, got in on:
            lo, hi = got["slab"]
            run_i = got["runs"][i]
            torch.testing.assert_close(run_i["window"],
                                       _padded(volume, lo - wl, hi + wh),
                                       rtol=0, atol=0)
            padded[:, :, 100 + lo - wl:100 + hi + wh] += \
                run_i["cotangent"].double()
            mine = max(0, min(hi, depth) - max(lo, 0))
            others = min(hi + wh, depth) - max(lo - wl, 0) - mine
            assert run_i["forward"]["halo_planes"] == others
            assert run_i["forward"]["halo"] == 1
            assert run_i["backward"]["halo"] == 1
            assert run_i["forward"]["halo_bytes"] == \
                others * 2 * 3 * 4 * 5 * 4
            assert run_i["forward"]["all_gather"] == (1 if i == 0 else 0)
        grad = padded[:, :, 100:100 + depth]
        sent = 0
        for r, got in on:
            lo, hi = got["slab"]
            np.testing.assert_allclose(got["runs"][i]["grad"].numpy(),
                                       grad[:, :, lo:hi].numpy(), rtol=1e-6,
                                       atol=1e-6)
            sent += got["runs"][i]["backward"]["halo_planes"]
        assert sent == sum(got["runs"][i]["forward"]["halo_planes"]
                           for _, got in on)
    assert len(on) == n


def test_halo_planes_split_91_unevenly(run):
    slabs = [got["uneven"]["slab"] for _, got in _on_mesh(run[2], "halo")
             if got["uneven"] is not None]
    assert slabs == [(0, 46), (46, 91)]
    assert [tp.depth_slab(d, 1, 2) for d in (46, 23, 12)] == \
        [(23, 46), (12, 23), (6, 12)]


# -------------------------------------------------------------- kernels --


def test_pool_window_on_four_ranks(run):
    """The stem pool of a depth of 11 over four ranks (slabs 3, 3, 3, 2):
    each rank's outputs are the whole pool's, and its slab gradient the
    whole backward's (first-max winners on tied values)."""
    on = _on_mesh(run[2], "pool")
    volume, cot = on[0][1]["volume"], on[0][1]["cotangent"]
    y = pool_forward(volume)
    dx = max_pool3d_backward_plain(volume, y, cot)
    for _, got in on:
        o_lo, o_hi = got["out"]
        lo, hi = got["slab"]
        torch.testing.assert_close(got["y"], y[:, :, o_lo:o_hi], rtol=0,
                                   atol=0)
        np.testing.assert_allclose(got["grad"].numpy(),
                                   dx[:, :, lo:hi].numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("depth", [11, 12, 91])
def test_maxpool_window_plain_versions(depth):
    """K8's window plain version: the windows of any split of the outputs
    add up to the whole backward, each window's forward is its part of the
    whole pool, and the whole volume as a window is today's call bit for
    bit."""
    rng = np.random.default_rng(depth)
    x = torch.from_numpy(np.round(rng.normal(size=(2, 2, depth, 5, 6)) * 2)
                         .astype(np.float32))
    y = pool_forward(x)
    g = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(np.float32))
    whole = max_pool3d_backward_plain(x, y, g)
    torch.testing.assert_close(max_pool3d_backward(x, y, g, 0, depth), whole,
                               rtol=0, atol=0)
    do = y.shape[2]
    for n in (2, 3, 4):
        dx = torch.zeros_like(x)
        for q in range(n):
            o_lo, o_hi = tp.depth_slab(do, q, n)
            if o_hi == o_lo:
                continue
            first = max(2 * o_lo - 1, 0)
            end = min(2 * o_hi, depth)
            assert window_outputs(first, end - first, depth)[1:] == \
                (o_lo, o_hi - o_lo)
            xw = x[:, :, first:end]
            torch.testing.assert_close(
                pool_forward_window(xw, first, depth), y[:, :, o_lo:o_hi],
                rtol=0, atol=0)
            dx[:, :, first:end] += max_pool3d_backward(
                xw, y[:, :, o_lo:o_hi], g[:, :, o_lo:o_hi], first, depth)
        np.testing.assert_allclose(dx.numpy(), whole.numpy(), rtol=1e-6,
                                   atol=1e-6)
    for first, planes in ((2, 5), (1, 4)):  # even start; odd end
        with pytest.raises(ValueError):
            window_outputs(first, planes, depth)


def test_zscore_split_plain_versions():
    """K3 split: the slabs' partials added in rank order give the
    whole-scan statistics within 2e-6, the apply is the whole-scan
    expression bit for bit, and the split z-score is the whole one."""
    batch = _batch(3, 11, (13, 6, 5))
    vol = torch.from_numpy(batch["mri"])
    mask = torch.from_numpy(batch["mri_mask"])
    whole = hopper_norm.per_scan_zscore(vol, mask)
    rows = vol.reshape(3, -1)
    valid = (rows * mask.reshape(3, -1)) != 0
    mean_ref = torch.stack([r[v].double().mean() for r, v in
                            zip(rows, valid)])
    std_ref = torch.stack([r[v].double().std() for r, v in zip(rows, valid)])
    for n in (1, 2, 4):
        parts = [hopper_norm.zscore_partials(vol[:, lo:hi], mask[:, lo:hi])
                 for lo, hi in (tp.depth_slab(13, q, n) for q in range(n))]
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        mean, std = hopper_norm.zscore_stats(total)
        assert mean.dtype == std.dtype == torch.float32
        np.testing.assert_allclose(mean.numpy(), mean_ref.numpy(), rtol=2e-6)
        np.testing.assert_allclose(std.numpy(), std_ref.numpy(), rtol=2e-6)
        out = hopper_norm.zscore_apply(vol, mask, mean, std)
        want = (vol - mean[:, None, None, None]) / std[:, None, None, None] \
            * mask
        torch.testing.assert_close(out, want, rtol=0, atol=0)
        np.testing.assert_allclose(out.numpy(), whole.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_minmax_on_a_spatial_axis(run):
    """The min-max preprocess of a depth-sharded batch, K1 on the gathered
    whole scans and K2 on each slab: the slabs put together are the
    unsharded result bit for bit."""
    on = _on_mesh(run[2], "minmax")
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(2, 9).items() if k != "label"}
    want = make_device_preprocess(normalize_mri=MINMAX)(batch)["mri"]
    got = torch.cat([r["mri"] for _, r in on], dim=1)
    assert [r["slab"] for _, r in on] == [(0, 6), (6, 12)]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ------------------------------------------------- nccl's collectives --
#
# On an nccl group the gathers are all_gather_into_tensor and the channel
# gather's backward reduce_scatter_tensor (gloo, above, all-reduces
# zero-filled buffers). One card holds one nccl rank, so here those two
# collectives are stood in for: the ranks of a mesh run one after another
# in this process, a first pass records each rank's input to each call, a
# second hands each rank what nccl would (the inputs stacked in rank order;
# the sum of the inputs' rank slices). The layouts around them (the
# movedim and reshape of a channel gather, the padded slabs of a depth
# gather, the rows of gather_rows) must give what the gloo path gives.


class _FakeNccl:
    def __init__(self, n: int):
        self.n, self.seen, self.rank, self.call, self.done = n, {}, 0, 0, False

    def _record(self, t):
        key = self.call
        self.call += 1
        self.seen.setdefault(key, {})[self.rank] = t.detach().clone()
        return [self.seen[key].get(q) for q in range(self.n)]

    def all_gather_into_tensor(self, out, t, group=None):
        parts = self._record(t)
        if self.done:
            out.copy_(torch.stack(parts))

    def reduce_scatter_tensor(self, out, parts, group=None):
        inputs = self._record(parts)
        if self.done:
            out.copy_(sum(p[self.rank] for p in inputs))

    def run(self, fn):
        """fn(rank) for each rank, twice; the second pass's results."""
        for done in (False, True):
            self.done, out = done, []
            for r in range(self.n):
                self.rank, self.call = r, 0
                out.append(fn(r))
        return out


def _nccl_mesh(shape, index):
    """A Mesh3D of ``shape`` at rank ``index`` on the CPU whose groups say
    nccl (no process group: the collectives are the fakes')."""
    coords = tuple(int(c) for c in np.unravel_index(index, shape))
    counts = dict.fromkeys(tp.COUNTS, 0)
    cpu = torch.device("cpu")

    def sub(axes):
        size = int(np.prod([shape[a] for a in axes]))
        rank = int(np.ravel_multi_index([coords[a] for a in axes],
                                        [shape[a] for a in axes]))
        return tp.Mesh(None, rank, size, cpu, "nccl", counts)

    return tp.Mesh3D(shape, coords, cpu, "nccl", sub((0,)), sub((1,)),
                     sub((2,)), sub((0, 2)), sub((0, 1, 2)), counts)


@pytest.fixture
def fake_nccl(monkeypatch):
    def make(n):
        fake = _FakeNccl(n)
        monkeypatch.setattr(torch.distributed, "all_gather_into_tensor",
                            fake.all_gather_into_tensor)
        monkeypatch.setattr(torch.distributed, "reduce_scatter_tensor",
                            fake.reduce_scatter_tensor)
        monkeypatch.setattr(torch.distributed, "all_reduce", None)
        return fake
    return make


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_nccl_channel_gather_and_its_reduce_scatter(fake_nccl, dim):
    """Three model ranks: the gather puts the slices side by side along
    ``dim``; its backward gives each rank the sum of every rank's
    cotangent over its slice; one all-gather and one reduce-scatter a
    rank."""
    rng = np.random.default_rng(dim)
    parts = [torch.from_numpy(rng.normal(size=(2, 3, 4)).astype(np.float32))
             for _ in range(3)]
    whole_shape = tuple(3 * s if a == dim else s
                        for a, s in enumerate((2, 3, 4)))
    cots = [torch.from_numpy(rng.normal(size=whole_shape).astype(np.float32))
            for _ in range(3)]

    def rank(r):
        mesh = _nccl_mesh((1, 3, 1), r)
        x = parts[r].clone().requires_grad_(True)
        y = tp._Gather.apply(x, mesh, dim, True)
        y.backward(cots[r])
        return y.detach(), x.grad, dict(mesh.counts)

    out = fake_nccl(3).run(rank)
    whole = torch.cat(parts, dim=dim)
    total = sum(cots)
    per = parts[0].shape[dim]
    for r, (y, grad, counts) in enumerate(out):
        torch.testing.assert_close(y, whole, rtol=0, atol=0)
        torch.testing.assert_close(grad, total.narrow(dim, r * per, per),
                                   rtol=1e-6, atol=1e-6)
        assert counts["all_gather"] == 1 and counts["reduce_scatter"] == 1


@pytest.mark.parametrize("depth,n", [(91, 2), (91, 4), (4, 3), (11, 4)])
def test_nccl_depth_and_spatial_gathers(fake_nccl, depth, n):
    """Spatial ranks holding JAX's uneven slabs (an empty one for 4 over
    3): the depth gather is the whole volume on every rank, the spatial
    gather every rank's tensor in rank order."""
    rng = np.random.default_rng(depth + n)
    volume = torch.from_numpy(rng.normal(size=(2, depth, 3, 5))
                              .astype(np.float32))

    def rank(r):
        mesh = _nccl_mesh((1, 1, n), r)
        lo, hi = tp.depth_slab(depth, r, n)
        ctx = tp.TensorParallel(mesh.data, 2, 0, mesh, {(3, 5): depth})
        full = ctx.gather_depth(volume[:, lo:hi].contiguous())
        spread = ctx.gather_spatial(torch.full((2, 3), float(r)))
        return full, spread, dict(mesh.counts)

    for full, spread, counts in fake_nccl(n).run(rank):
        torch.testing.assert_close(full, volume, rtol=0, atol=0)
        assert [float(t[0, 0]) for t in spread] == [float(q)
                                                    for q in range(n)]
        assert counts["all_gather"] == 2


def test_nccl_gather_rows(fake_nccl):
    """gather_rows on an nccl mesh of 4: each rank's block of rows in rank
    order, counted as one all-gather; a block not at its rank's offset is
    refused."""
    from multimodal_alzheimer_tpu_torch.parallel.mesh import (
        DataParallel,
        Mesh,
        gather_rows,
    )

    rows = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)

    def rank(r):
        mesh = Mesh(None, r, 4, torch.device("cpu"), "nccl")
        out = gather_rows({"a": rows[2 * r:2 * r + 2]},
                          DataParallel(mesh, 8, 2 * r))
        return out["a"], dict(mesh.counts)

    for got, counts in fake_nccl(4).run(rank):
        torch.testing.assert_close(got, rows, rtol=0, atol=0)
        assert counts == {"all_reduce": 0, "broadcast": 0, "all_gather": 1}
    mesh = Mesh(None, 1, 4, torch.device("cpu"), "nccl")
    with pytest.raises(ValueError, match="block"):
        gather_rows(rows[:2], DataParallel(mesh, 8, 0))
