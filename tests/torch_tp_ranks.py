"""Rank functions of the port's tensor- and spatial-parallel tests.

``parallel.launch.run_ranks`` spawns one process per rank and a spawned
child imports the module that defines its target: this one, which imports
neither JAX nor the JAX package. ``tp_on_ranks`` runs every case of
``tests/test_torch_tp.py`` in one spawn of eight ranks: each case builds
its (data, model, spatial) mesh over the first ranks (every rank takes part
in making the groups; the ranks outside the mesh return None for it).
``step_case`` with ``mesh=None`` is the one-process run the parent compares
with.
"""

import contextlib

import numpy as np
import torch

from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.losses.classification import (
    make_criterion,
)
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.parallel import tp
from multimodal_alzheimer_tpu_torch.train.state import (
    TrainState,
    make_eval_step,
    make_train_step,
)
from torch_threads import TORCH_THREADS

ZSCORE = {"per_scan_norm": "normalize"}
MINMAX = {"per_scan_norm": "min_max"}


def _batch(case: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in case["batch"].items()}


@contextlib.contextmanager
def dropped_halo(rank: int = 1):
    """A planted fault of the sharded step: spatial rank ``rank`` zeroes
    the planes that its depth windows receive from the rank below (a halo
    exchange that lost them), in the forward pass."""
    real = tp._halo

    def halo(x, mesh, depth, need, fill=0.0):
        out = real(x, mesh, depth, need, fill)
        sp = mesh.spatial
        lost = tp.depth_slab(depth, sp.rank, sp.size)[0] - need[sp.rank][0]
        if sp.rank != rank or lost <= 0:
            return out
        axis = out.ndim - 3
        keep = torch.ones(out.shape[axis], dtype=out.dtype)
        keep[:lost] = 0
        return out * keep.view([-1] + [1] * (out.ndim - axis - 1))

    tp._halo = halo
    try:
        yield
    finally:
        tp._halo = real


def step_case(case: dict, mesh=None) -> dict:
    """``case['steps']`` SGD steps of the case's AnatCNN (weights from the
    file ``case['weights']``) with the z-score in the step, one process
    (``mesh=None``) or this rank's shards. Returns the losses, the whole
    state dict after the first step (``gather_state`` under a mesh) and the
    gradients of the first step (gathered the same way), the gathered
    labels and logits, the collectives of the first step, the shape of
    ``layer1_block0.conv1``'s weight after the last step, and an eval
    step's loss, logits and ``backbone_gap`` after it. Under a mesh only
    rank 0 returns the whole state and gradients (a ResNet-10 is 58 MB);
    every rank returns the classifier bias' gradient it summed and the sum
    of its whole state, which must agree everywhere. A case with
    ``fault`` runs its mesh steps under ``dropped_halo()``."""
    model = AnatCNN.from_hparams(case["hp"], **case.get("overrides", {}))
    model.load_state_dict(torch.load(case["weights"]))
    optimizer = torch.optim.SGD(model.parameters(), lr=case["lr"])
    preprocess = make_device_preprocess(normalize_mri=case.get("norm",
                                                               ZSCORE))
    step = make_train_step(model, make_criterion(case["criterion"]),
                           optimizer, preprocess, mesh=mesh)
    state = TrainState(model, optimizer)
    batch = _batch(case)
    if mesh is not None:
        tp.shard_state(state, mesh)
        batch = tp.shard_batch_3d(batch, mesh)
    losses, out = [], {}
    planted = dropped_halo() if case.get("fault") and mesh is not None \
        else contextlib.nullcontext()
    for i in range(case["steps"]):
        with planted:
            state, aux = step(state, batch)
        losses.append(float(aux["loss"]))
        if i == 0:
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()}
            out["cls_bias_grad"] = grads["head.cls.bias"]
            if mesh is None:
                out["state"] = {k: v.detach().clone()
                                for k, v in model.state_dict().items()}
                out["grads"] = grads
            else:
                out["counts"] = dict(mesh.counts)
                whole = tp.gather_state(model, mesh)
                grads = _gathered_grads(model, grads, mesh)
                out["state_sum"] = sum(float(v.double().sum())
                                       for v in whole.values())
                if mesh.rank == 0:
                    out["state"], out["grads"] = whole, grads
            out["labels"] = aux["labels"].clone()
            out["logits"] = aux["logits"].clone()
    out["losses"] = losses
    out["conv1_shape"] = tuple(model.backbone.layer1_block0.conv1
                               .weight.shape)
    evaluate = make_eval_step(model, make_criterion(case["criterion"]),
                              preprocess, mesh=mesh)
    ev = evaluate(batch)
    out["eval"] = {"loss": float(ev["loss"]), "logits": ev["logits"].clone(),
                   "gap": ev["embeddings"]["backbone_gap"].clone()}
    return out


def _gathered_grads(model, grads: dict, mesh) -> dict:
    layout = model.tp_layout
    out = {}
    for name, g in grads.items():
        if name in layout:
            g = tp._gather(g, layout[name][0], mesh)
        out[name] = g
    return out


def halo_case(mesh, depth: int, widths, seed: int) -> dict:
    """``halo_planes`` of a depth-sharded (2, 3, depth, 4, 5) volume: for each
    (lo_pad, hi_pad) of ``widths``, every rank asks for its slab widened by
    them (zeros outside the volume) and back-propagates a seeded
    cotangent. Returns the windows, the slab gradients and the planes each
    exchange received. The first width goes through the int bounds (which
    exchanges them), the rest through every rank's bounds."""
    rng = np.random.default_rng(seed)
    volume = torch.from_numpy(rng.normal(size=(2, 3, depth, 4, 5))
                              .astype(np.float32))
    n, s = mesh.shape[2], mesh.coords[2]
    slabs = [tp.depth_slab(depth, q, n) for q in range(n)]
    lo, hi = slabs[s]
    out = []
    for i, (wl, wh) in enumerate(widths):
        x = volume[:, :, lo:hi].clone().requires_grad_(True)
        mesh.reset_counts()
        if i == 0:
            win = tp.halo_planes(x, lo - wl, hi + wh, 0.0, depth=depth,
                                 mesh=mesh)
        else:
            win = tp.halo_planes(x, [a - wl for a, _ in slabs],
                                 [b + wh for _, b in slabs], 0.0,
                                 depth=depth, mesh=mesh)
        forward = dict(mesh.counts)
        cot = torch.from_numpy(rng.normal(size=tuple(win.shape))
                               .astype(np.float32))
        (win * cot).sum().backward()
        out.append({"window": win.detach().clone(), "grad": x.grad.clone(),
                    "cotangent": cot, "forward": forward,
                    "backward": {k: mesh.counts[k] - forward[k]
                                 for k in forward}})
    return {"volume": volume, "slab": (lo, hi), "runs": out}


def minmax_case(mesh, batch: dict) -> dict:
    """The min-max preprocess of ``batch`` on this rank's depth slab inside
    a ``tensor_parallel`` block."""
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    shard = tp.shard_batch_3d(batch, mesh)
    with tp.tensor_parallel(mesh, shard):
        out = make_device_preprocess(normalize_mri=MINMAX)(dict(shard))
    return {"mri": out["mri"].clone(),
            "slab": tp.depth_slab(batch["mri"].shape[1], mesh.coords[2],
                                  mesh.shape[2])}


def pool_window_case(mesh, depth: int, seed: int) -> dict:
    """The stem pool of a depth-sharded (2, 3, depth, 6, 5) map through
    ``max_pool3d_pl`` on the rank's window (K8's window on the CPU path),
    against nothing: the parent compares with the whole-volume pool."""
    from multimodal_alzheimer_tpu_torch.ops.hopper_maxpool import (
        max_pool3d_pl,
    )

    rng = np.random.default_rng(seed)
    # ties on purpose: values on a coarse grid
    volume = torch.from_numpy(np.round(rng.normal(size=(2, 3, depth, 6, 5))
                                       * 2).astype(np.float32))
    n, s = mesh.shape[2], mesh.coords[2]
    lo, hi = tp.depth_slab(depth, s, n)
    x = volume[:, :, lo:hi].clone().requires_grad_(True)
    shard = tp.BatchShard3D({}, 2, 0, {(6, 5): depth})
    with tp.tensor_parallel(mesh, shard):
        y = tp.pool_window(x, 3, 2, 1, 0.0, max_pool3d_pl, clip=True)
    cot = torch.from_numpy(rng.normal(size=(2, 3, (depth - 1) // 2 + 1, 3, 3))
                           .astype(np.float32))
    o_lo, o_hi = tp.depth_slab((depth - 1) // 2 + 1, s, n)
    (y * cot[:, :, o_lo:o_hi]).sum().backward()
    return {"volume": volume, "cotangent": cot, "y": y.detach().clone(),
            "grad": x.grad.clone(), "slab": (lo, hi), "out": (o_lo, o_hi)}


def layout_case(mesh, case: dict) -> dict:
    """The shard of one parameter, a BatchNorm statistic and an Adam moment
    after ``shard_state``; the rank's batch shard."""
    model = AnatCNN.from_hparams(case["hp"])
    model.load_state_dict(torch.load(case["weights"]))
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    state = TrainState(model, optimizer)
    with torch.random.fork_rng():
        torch.manual_seed(0)
        model.train()(_batch(case))["logits"].sum().backward()
    optimizer.step()
    conv_full = model.backbone.layer1_block0.conv1.weight.detach().clone()
    bn_full = model.backbone.bn1.running_mean.clone()
    specs = tp.variable_shardings(model, mesh)
    adam = optimizer.state[model.backbone.layer1_block0.conv1.weight][
        "exp_avg"].clone()
    tp.shard_state(state, mesh)
    conv = model.backbone.layer1_block0.conv1.weight
    shard = tp.shard_batch_3d(_batch(case), mesh)
    return {"conv1": conv.detach().clone(), "conv1_full": conv_full,
            "adam_full": adam, "coords": mesh.coords, "bn_full": bn_full,
            "adam": optimizer.state[conv]["exp_avg"].clone(),
            "bn_mean": model.backbone.bn1.running_mean.clone(),
            "cls": model.head.cls.weight.detach().clone(),
            "cls_bias": model.head.cls.bias.detach().clone(),
            "shard": {k: v.clone() for k, v in shard.items()},
            "offset": shard.offset, "depths": shard.depths,
            "specs": specs}


def _on(meshes: dict, shape, fn, *args):
    """``fn(mesh, *args)`` on the ranks of a ``shape`` mesh, None off it.
    Every rank makes each shape's groups once (``meshes`` keeps them)."""
    if shape not in meshes:
        meshes[shape] = tp.make_mesh_3d(*shape, device="cpu")
    mesh = meshes[shape]
    if mesh is None:
        return None
    mesh.reset_counts()
    return fn(mesh, *args)


def tp_on_ranks(world, cases: dict, halo: dict, minmax_batch: dict) -> dict:
    """Every case of the tp test file on this rank of eight."""
    import time

    torch.set_num_threads(TORCH_THREADS)
    meshes, out, times = {}, {}, {"start": time.time()}
    for name, case in cases.items():
        t = time.perf_counter()
        out[name] = _on(meshes, case["mesh"],
                        lambda mesh, c: step_case(c, mesh), case)
        times[name] = time.perf_counter() - t
    t = time.perf_counter()
    if "fused-full" in cases:
        out["layout"] = _on(meshes, (2, 2, 2), layout_case,
                            cases["fused-full"])
    out["halo"] = {name: _on(meshes, args["mesh"], halo_case, args["depth"],
                             args["widths"], args["seed"])
                   for name, args in halo.items()}
    if minmax_batch is not None:
        out["minmax"] = _on(meshes, (1, 1, 2), minmax_case, minmax_batch)
    out["pool"] = _on(meshes, (1, 1, 4), pool_window_case, 11, 3)
    try:
        tp.make_mesh_3d(2, 2, 4, device="cpu")
        out["too_many"] = None
    except ValueError as exc:
        out["too_many"] = str(exc)
    times["rest"] = time.perf_counter() - t
    times["end"] = time.time()
    out["times"] = times
    return out
