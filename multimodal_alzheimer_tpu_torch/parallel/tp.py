"""Tensor and spatial parallelism over a (data, model, spatial) mesh of ranks.

Port of ``multimodal_alzheimer_tpu/parallel/tp.py``. There the parallelism
is PartitionSpecs alone: conv kernels sharded on their output channels,
dense kernels on their input features, per-channel vectors on their only
axis, volumes on depth, and GSPMD inserts every collective and halo
exchange. Here one process runs per rank (``parallel/mesh.py``), so each of
those collectives is written out, and the layers call them while a
``tensor_parallel`` block is open (as they read ``data_parallel``):

* ``make_mesh_3d``: the first n_d * n_m * n_s ranks of the process group in
  JAX's row-major (data, model, spatial) layout, with this rank's
  coordinates and the groups the layers reduce over (``Mesh3D``: ``data``,
  ``model``, ``spatial``, ``data_spatial``, each a 1-D ``parallel.Mesh``).
* ``param_spec`` / ``variable_shardings`` / ``shard_variables`` /
  ``shard_state``: JAX's shape rule on the torch layouts, and each rank's
  slice kept in place (parameters, BatchNorm running statistics, Adam
  moments); ``gather_state`` puts the whole state dict back together on
  every rank (JAX's global arrays need no such function).
* ``batch_spec`` / ``shard_batch_3d``: the rank's rows (data axis) and its
  depth slab (spatial axis) of every tensor of four or more axes, in JAX's
  uneven layout (``depth_slab``: ceil(D/n) planes a slab, a shorter last).
* The collectives, each differentiable and counted in ``Mesh3D.counts``:
  the channel all-gather before a conv (its backward a reduce-scatter),
  the model-axis sum of a row-split dense layer, and ``halo_planes``, which
  fetches the depth planes a windowed op needs from whichever ranks hold
  them (planes outside the volume filled), halo-sized point-to-point
  traffic whose backward adds each halo plane's gradient into its owner.
  Gloo sends no CUDA tensors point to point, so a gloo mesh on the card
  stages the halo planes through host memory.
* ``conv3d``, ``linear``, ``pool_window``, ``global_avg_pool``,
  ``channels``: what the layers of ``models/`` call under a 3-D mesh.

Conventions. Activations leave a conv channel-sharded when its kernel is
(O/n_m channels) and depth-sharded (the rank's slab of each layer's output
depth, laid out as the input is). After the global average pool the head
runs on every spatial rank alike, and a row-split dense layer's output is
the same on every model rank. The model axis follows Megatron: a sum whose
consumers are replicated passes the cotangent through unchanged, and a
gather feeding a sharded consumer sums the cotangents back. Along data and
spatial the ranks hold disjoint parts of the batch: every rank back-propagates
its data row's loss divided by n_s, so that the ranks of one model slice
add up to the global loss, and the train step sums every gradient over
data x spatial only (``train/state.py``). BatchNorm takes its statistics
over data x spatial of the rank's channel slice; a layer's global depth is
looked up by its (H, W) in the block's depth table, which the convs and
pools fill as they run (the models' strides are isotropic).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from multimodal_alzheimer_tpu_torch.parallel.mesh import (
    _STATE,
    BatchShard,
    DataParallel,
    Mesh,
    all_reduce_sum,
    batch_rows,
    current,
)

DATA_AXIS = "data"
MODEL_AXIS = "model"
SPATIAL_AXIS = "spatial"
COUNTS = ("all_reduce", "broadcast", "all_gather", "reduce_scatter", "halo",
          "halo_planes", "halo_bytes")


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one mesh axis name (or None) per tensor
    axis; ``P()`` is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def __reduce__(self):
        return (PartitionSpec, tuple(self))


P = PartitionSpec


# ------------------------------------------------------------------ mesh --


@dataclass(eq=False)
class Mesh3D:
    """A (data, model, spatial) mesh: ``shape`` (n_d, n_m, n_s), this rank's
    ``coords`` (d, m, s), and the 1-D meshes of the ranks that share all
    coordinates but the named ones (``data``: the ranks of this (m, s);
    ``data_spatial``: of this m; ``world``: every rank of the mesh). They
    share ``counts``."""

    shape: tuple
    coords: tuple
    device: torch.device
    backend: str
    data: Mesh
    model: Mesh
    spatial: Mesh
    data_spatial: Mesh
    world: Mesh
    counts: dict

    @property
    def rank(self) -> int:
        return self.world.rank

    def reset_counts(self) -> None:
        for name in self.counts:
            self.counts[name] = 0


def _coords(i: int, shape) -> tuple:
    _, n_m, n_s = shape
    return (i // (n_m * n_s), (i // n_s) % n_m, i % n_s)


def make_mesh_3d(n_data: int, n_model: int, n_spatial: int = 1, *,
                 group=None, device="cuda") -> Optional[Mesh3D]:
    """The (data, model, spatial) mesh of the first n_d * n_m * n_s ranks of
    ``group`` (the default group by default), which must be initialised,
    placed row-major as JAX places devices. Every rank of ``group`` calls
    it (each group is made by all of them); a rank outside the mesh gets
    None. ``device="cpu"`` keeps the mesh on the CPU."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh_3d needs an initialised process group: call "
            "torch.distributed.init_process_group(backend, ...) first")
    group = dist.group.WORLD if group is None else group
    shape = (int(n_data), int(n_model), int(n_spatial))
    n = shape[0] * shape[1] * shape[2]
    size = dist.get_world_size(group)
    if min(shape) < 1:
        raise ValueError(f"mesh axes must be at least 1, got {shape}")
    if size < n:
        raise ValueError(f"need {n} devices, have {size}")
    members = [dist.get_global_rank(group, i) for i in range(n)]
    me = dist.get_rank()
    index = members.index(me) if me in members else None
    coords = [_coords(i, shape) for i in range(n)]

    def grouped(key):
        """Make the groups of ranks with equal ``key(coords)``, all of
        them on every rank in one order; return this rank's."""
        buckets: dict = {}
        for i, c in enumerate(coords):
            buckets.setdefault(key(c), []).append(members[i])
        mine = None
        for k in sorted(buckets):
            made = dist.new_group(buckets[k])
            if index is not None and key(coords[index]) == k:
                mine = (made, buckets[k])
        return mine

    world = grouped(lambda c: 0)
    data = grouped(lambda c: (c[1], c[2]))
    model = grouped(lambda c: (c[0], c[2]))
    spatial = grouped(lambda c: (c[0], c[1]))
    data_spatial = grouped(lambda c: c[1])
    if index is None:
        return None
    backend = str(dist.get_backend(group))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} asked for, but CUDA is not "
                               f"available")
        device = torch.device("cuda", me % torch.cuda.device_count())
    elif backend == "nccl":
        raise ValueError("the nccl backend takes CUDA tensors only: a CPU "
                         "mesh needs gloo")
    counts = dict.fromkeys(COUNTS, 0)

    def sub(pair) -> Mesh:
        made, ranks = pair
        return Mesh(made, ranks.index(me), len(ranks), device, backend,
                    counts)

    return Mesh3D(shape, coords[index], device, backend, sub(data),
                  sub(model), sub(spatial), sub(data_spatial), sub(world),
                  counts)


# ----------------------------------------------------------- parameters --


def param_spec(path, leaf, n_model: int) -> PartitionSpec:
    """JAX's shape rule (``tp.py:60-78``) on a torch tensor: a conv weight
    (O, I, kD, kH, kW) shards O, a ``Linear`` weight (out, in) shards ``in``
    (JAX's (in, out) kernel shards its first axis, the input features), a
    1-D tensor its only axis, each where it divides by ``n_model``;
    anything else is replicated. ``path`` names the tensor for the reader
    only."""
    del path
    shape = tuple(getattr(leaf, "shape", ()))
    if len(shape) == 5 and shape[0] % n_model == 0:
        return P(MODEL_AXIS, None, None, None, None)
    if len(shape) == 2 and shape[1] % n_model == 0:
        return P(None, MODEL_AXIS)
    if len(shape) == 1 and shape[0] % n_model == 0:
        return P(MODEL_AXIS)
    return P()


def _model_of(tree) -> torch.nn.Module:
    return tree.model if hasattr(tree, "model") else tree


def variable_shardings(model, mesh: Mesh3D) -> dict:
    """{state-dict name: ``param_spec``} of a module (or ``TrainState``)."""
    n_model = mesh.shape[1]
    return {name: param_spec(name, t, n_model)
            for name, t in _model_of(model).state_dict().items()}


def _sharded_dim(spec: PartitionSpec) -> Optional[int]:
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def _slice(t: torch.Tensor, dim: int, mesh: Mesh3D) -> torch.Tensor:
    n, m = mesh.shape[1], mesh.coords[1]
    per = t.shape[dim] // n
    return t.narrow(dim, m * per, per).clone()


@torch.no_grad()
def shard_variables(model, mesh: Mesh3D):
    """Keep this rank's model slice of every parameter and buffer of
    ``model`` per ``param_spec``, in place (the ``nn.Parameter`` objects
    stay, so an optimizer built on them keeps them); returns ``model``. The
    layout is recorded on the module for ``gather_state``."""
    module = _model_of(model)
    if getattr(module, "tp_layout", None):
        raise ValueError("the module is sharded already")
    layout = {}
    specs = variable_shardings(module, mesh)
    for prefix, sub in module.named_modules():
        for kind in ("_parameters", "_buffers"):
            for name, t in getattr(sub, kind).items():
                if t is None:
                    continue
                full = f"{prefix}.{name}" if prefix else name
                dim = _sharded_dim(specs.get(full, P()))
                if dim is None or mesh.shape[1] == 1:
                    continue
                layout[full] = (dim, t.shape[dim])
                if kind == "_parameters":
                    t.data = _slice(t.data, dim, mesh)
                else:
                    sub._buffers[name] = _slice(t, dim, mesh)
    module.tp_layout = layout
    return model


@torch.no_grad()
def shard_state(state, mesh: Mesh3D):
    """``shard_variables`` of a ``TrainState``'s model (or of a module) and
    the same slice of each parameter's optimizer moments (Adam's
    ``exp_avg``, ``exp_avg_sq``); scalars such as step counts stay whole.
    Returns ``state``."""
    module = _model_of(state)
    optimizer = getattr(state, "optimizer", None)
    n_model = mesh.shape[1]
    dims = {id(p): _sharded_dim(param_spec(name, p, n_model))
            for name, p in module.named_parameters()}
    if optimizer is not None and n_model > 1:
        for group in optimizer.param_groups:
            for p in group["params"]:
                dim = dims.get(id(p))
                if dim is None:
                    continue
                moments = optimizer.state.get(p, {})
                for key, value in list(moments.items()):
                    if (isinstance(value, torch.Tensor)
                            and value.shape == p.shape):
                        moments[key] = _slice(value, dim, mesh)
    shard_variables(module, mesh)
    return state


@torch.no_grad()
def gather_state(model, mesh: Mesh3D) -> dict:
    """The whole state dict of a module (or ``TrainState``) that
    ``shard_variables`` sharded, on every rank (one gather over the model
    group per sharded tensor, in state-dict order)."""
    module = _model_of(model)
    layout = getattr(module, "tp_layout", {})
    out = {}
    for name, t in module.state_dict().items():
        if name not in layout:
            out[name] = t.detach().clone()
            continue
        dim, _ = layout[name]
        out[name] = _gather(t.detach(), dim, mesh)
    return out


def _gather(t: torch.Tensor, dim: int, mesh: Mesh3D) -> torch.Tensor:
    """Every model rank's ``t`` side by side along ``dim`` (``Mesh.
    all_gather``: an all-gather on nccl, an all-reduce of a zero-filled
    buffer on gloo)."""
    shape = list(t.shape)
    shape[dim] *= mesh.shape[1]
    full = mesh.model.all_gather(t).movedim(0, dim).reshape(shape)
    mesh.counts["all_gather"] += 1
    return full


# ---------------------------------------------------------------- batch --


def batch_spec(key: str, leaf) -> PartitionSpec:
    """Inputs: rows on 'data'; volumes (four or more axes) also depth on
    'spatial'."""
    del key
    ndim = getattr(leaf, "ndim", 0)
    if ndim >= 4:
        return P(DATA_AXIS, SPATIAL_AXIS)
    if ndim >= 1:
        return P(DATA_AXIS)
    return P()


def depth_slab(depth: int, index: int, n: int) -> tuple:
    """The planes [lo, hi) that spatial rank ``index`` of ``n`` holds of a
    depth of ``depth``: JAX's uneven sharding, ceil(depth / n) planes a
    rank and what is left on the last (so 91 splits 46 + 45; a rank can hold
    none)."""
    per = -(-depth // n)
    lo = min(index * per, depth)
    return lo, min(lo + per, depth)


class BatchShard3D(BatchShard):
    """This rank's rows and depth slabs of a global batch: a ``BatchShard``
    that also carries ``depths``, the global depth of its volumes keyed by
    their (H, W)."""

    def __init__(self, arrays: dict, global_rows: int, offset: int,
                 depths: dict):
        super().__init__(arrays, global_rows, offset)
        self.depths = dict(depths)


def shard_batch_3d(batch: dict, mesh: Mesh3D) -> BatchShard3D:
    """The rank's block of rows of every tensor of a global batch, and of
    each volume (``batch_spec``: four or more axes, depth third from last)
    its depth slab, on the mesh's device."""
    n = batch_rows(batch)
    rows = mesh.data.rows(n)
    n_s, s = mesh.shape[2], mesh.coords[2]
    out, depths = {}, {}
    for key, value in batch.items():
        t = torch.as_tensor(value)[rows]
        if batch_spec(key, t) == P(DATA_AXIS, SPATIAL_AXIS):
            depth = t.shape[-3]
            _record(depths, tuple(t.shape[-2:]), depth)
            lo, hi = depth_slab(depth, s, n_s)
            t = t.narrow(t.ndim - 3, lo, hi - lo)
        out[key] = t.contiguous().to(mesh.device)
    return BatchShard3D(out, n, rows.start, depths)


def _record(depths: dict, hw: tuple, depth: int) -> None:
    if depths.setdefault(hw, depth) != depth:
        raise ValueError(
            f"two global depths ({depths[hw]} and {depth}) for maps of H x W "
            f"= {hw}: the depth table needs every (H, W) to have one depth")


# -------------------------------------------------------------- context --


@dataclass(frozen=True)
class TensorParallel(DataParallel):
    """An open ``tensor_parallel`` block: the data parallelism of the
    rank's rows (``mesh`` is the data axis' 1-D mesh, which the losses and
    dropout read) and the 3-D mesh ``tp`` with the block's depth table."""

    tp: Mesh3D = None
    depths: dict = field(default_factory=dict)

    @property
    def is_split(self) -> bool:
        return self.tp.shape[0] * self.tp.shape[2] > 1

    def stats_mesh(self, x: torch.Tensor) -> Mesh:
        """A volume's BatchNorm sums reduce over data x spatial; a (B, C)
        one's (after the pool, the same on every spatial rank) over data."""
        return self.tp.data_spatial if x.ndim == 5 else self.tp.data

    def stats_count(self, x: torch.Tensor) -> int:
        if x.ndim == 5:
            return (self.global_rows * self.global_depth(x) * x.shape[3]
                    * x.shape[4])
        return self.global_count(x)

    def global_depth(self, x: torch.Tensor) -> int:
        """The global depth of the volume whose slab ``x`` is (depth third
        from last)."""
        if self.tp.shape[2] == 1:
            return x.shape[-3]
        hw = tuple(x.shape[-2:])
        if hw not in self.depths:
            raise ValueError(
                f"no global depth known for a map of H x W = {hw}: under a "
                f"spatial axis a volume enters through shard_batch_3d and "
                f"changes depth only in the layers of parallel.tp")
        return self.depths[hw]

    def record(self, hw: tuple, depth: int) -> None:
        _record(self.depths, tuple(hw), depth)

    def gather_spatial(self, t: torch.Tensor) -> list:
        """Every spatial rank's ``t`` (of one shape), in rank order."""
        buf = self.tp.spatial.all_gather(t)
        self.tp.counts["all_gather"] += 1
        return list(buf.unbind(0))

    def gather_depth(self, t: torch.Tensor) -> torch.Tensor:
        """The whole volumes of which ``t`` holds the rank's slabs (depth
        third from last), on every spatial rank: each slab padded to
        ceil(depth / n) planes, gathered, the padding cut."""
        depth = self.global_depth(t)
        sp = self.tp.spatial
        lo, hi = depth_slab(depth, sp.rank, sp.size)
        per = -(-depth // sp.size)
        axis = t.ndim - 3
        shape = list(t.shape)
        shape[axis] = per
        slab = t.new_zeros(shape)
        slab.narrow(axis, 0, hi - lo).copy_(t)
        shape[axis] = per * sp.size
        full = sp.all_gather(slab).movedim(0, axis).reshape(shape)
        self.tp.counts["all_gather"] += 1
        return full.narrow(axis, 0, depth)


@contextlib.contextmanager
def tensor_parallel(mesh: Mesh3D, batch: BatchShard3D):
    """Layers in this thread see the rank's rows and slabs of ``batch`` as
    part of the global batch, sharded over ``mesh``, while the block runs."""
    before = getattr(_STATE, "dp", None)
    _STATE.dp = TensorParallel(mesh.data, batch.global_rows, batch.offset,
                               mesh, dict(batch.depths))
    try:
        yield _STATE.dp
    finally:
        _STATE.dp = before


def active() -> Optional[TensorParallel]:
    """The open ``tensor_parallel`` block of this thread, or None."""
    dp = current()
    return dp if isinstance(dp, TensorParallel) else None


def spatial() -> Optional[TensorParallel]:
    """``active()`` where the depth is sharded over more than one rank."""
    tp = active()
    return tp if tp is not None and tp.tp.shape[2] > 1 else None


# ---------------------------------------------------------- collectives --


class _Gather(torch.autograd.Function):
    """Every model rank's slice side by side along ``dim``. Backward: the
    summed cotangent's slice (a reduce-scatter) for a consumer whose ranks
    each see part of the work, the rank's own slice for a replicated
    one."""

    @staticmethod
    def forward(ctx, x, mesh, dim, reduce):
        ctx.mesh, ctx.dim, ctx.reduce, ctx.per = mesh, dim, reduce, x.shape[dim]
        return _gather(x, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        per, m, dim = ctx.per, mesh.coords[1], ctx.dim
        if ctx.reduce and mesh.backend == "nccl":
            shape = list(g.shape)
            parts = g.reshape(shape[:dim] + [mesh.shape[1], per]
                              + shape[dim + 1:]).movedim(dim, 0).contiguous()
            out = g.new_empty(parts.shape[1:])
            dist.reduce_scatter_tensor(out, parts, group=mesh.model.group)
            mesh.counts["reduce_scatter"] += 1
            return out, None, None, None
        if ctx.reduce:  # gloo: the whole sum, then the rank's slice
            g = g.contiguous().clone()
            dist.all_reduce(g, group=mesh.model.group)
            mesh.counts["reduce_scatter"] += 1
        return g.narrow(dim, m * per, per).contiguous(), None, None, None


class _Scatter(torch.autograd.Function):
    """This model rank's slice along ``dim`` of a tensor that every model
    rank holds whole; backward, every rank's slice of the cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        n, m = mesh.shape[1], mesh.coords[1]
        per = x.shape[dim] // n
        return x.narrow(dim, m * per, per).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.dim, ctx.mesh), None, None


class _SumModel(torch.autograd.Function):
    """The sum over the model group of partial results whose consumers are
    replicated; the cotangent passes through."""

    @staticmethod
    def forward(ctx, x, mesh):
        out = x.clone()
        dist.all_reduce(out, group=mesh.model.group)
        mesh.counts["all_reduce"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyModel(torch.autograd.Function):
    """A tensor every model rank holds whole, fed to a consumer whose ranks
    each see part of the work: backward, the cotangents summed."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.model.group)
        ctx.mesh.counts["all_reduce"] += 1
        return g, None


def gather_channels(x: torch.Tensor, mesh: Mesh3D,
                    reduce: bool = True) -> torch.Tensor:
    """Axis 1 gathered over the model group; backward a reduce-scatter
    (``reduce``) or the rank's slice."""
    return _Gather.apply(x, mesh, 1, reduce)


def scatter_channels(x: torch.Tensor, mesh: Mesh3D) -> torch.Tensor:
    """The rank's channel slice of an x every model rank holds whole (the
    reverse of ``gather_channels``)."""
    return _Scatter.apply(x, mesh, 1)


def sum_model(x: torch.Tensor, mesh: Mesh3D) -> torch.Tensor:
    return _SumModel.apply(x, mesh)


def _exchange(mesh: Mesh, sends: list, recvs: list, like: torch.Tensor):
    """Point to point over ``mesh``: ``sends`` [(rank, tensor)], ``recvs``
    [(rank, shape)] -> the received tensors on ``like``'s device. Gloo
    sends no CUDA tensors, so a gloo mesh stages them through host memory."""
    staged = mesh.backend == "gloo" and like.device.type == "cuda"
    host = torch.device("cpu") if staged else like.device
    reqs, keep, bufs = [], [], []
    for rank, t in sends:
        t = t.contiguous().to(host)
        keep.append(t)
        reqs.append(dist.isend(t, dist.get_global_rank(mesh.group, rank),
                               group=mesh.group))
    for rank, shape in recvs:
        buf = torch.empty(shape, dtype=like.dtype, device=host)
        bufs.append(buf)
        reqs.append(dist.irecv(buf, dist.get_global_rank(mesh.group, rank),
                               group=mesh.group))
    for req in reqs:
        req.wait()
    return [b.to(like.device) for b in bufs]


def _overlap(a: tuple, b: tuple) -> tuple:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else None


class _Halo(torch.autograd.Function):
    """Global planes ``need[s]`` of a depth-sharded x on spatial rank s,
    each fetched from the rank that owns it (``owned``), outside [0, depth)
    ``fill``. Backward: each fetched plane's cotangent sent back to its
    owner and added there, after the rank's own, in rank order."""

    @staticmethod
    def forward(ctx, x, mesh, owned, need, depth, fill):
        sp = mesh.spatial
        s, axis = sp.rank, x.ndim - 3
        lo, hi = need[s]
        mine = owned[s]
        recv = [(q, cut) for q in range(sp.size) if q != s
                for cut in [_overlap(need[s], owned[q])] if cut]
        send = [(r, cut) for r in range(sp.size) if r != s
                for cut in [_overlap(need[r], mine)] if cut]

        def shape(cut):
            dims = list(x.shape)
            dims[axis] = cut[1] - cut[0]
            return dims

        got = _exchange(sp, [(r, x.narrow(axis, a - mine[0], b - a))
                             for r, (a, b) in send],
                        [(q, shape(cut)) for q, cut in recv], x)
        _count_halo(mesh, recv, x)
        pieces = dict(zip((cut[0] for _, cut in recv), got))
        own = _overlap(need[s], mine)
        if own:
            pieces[own[0]] = x.narrow(axis, own[0] - mine[0], own[1] - own[0])
        parts = []
        if lo < 0:
            parts.append(x.new_full(shape((lo, min(hi, 0))), fill))
        parts += [pieces[k] for k in sorted(pieces)]
        if hi > depth:
            parts.append(x.new_full(shape((max(lo, depth), hi)), fill))
        ctx.mesh, ctx.axis, ctx.lo, ctx.mine = mesh, axis, lo, mine
        ctx.recv, ctx.send, ctx.own, ctx.shape = recv, send, own, x.shape
        if not parts:
            return x.new_zeros(shape((lo, lo)))
        return torch.cat(parts, dim=axis)

    @staticmethod
    def backward(ctx, g):
        axis, lo, mine = ctx.axis, ctx.lo, ctx.mine
        mesh = ctx.mesh

        def shape(cut):
            dims = list(ctx.shape)
            dims[axis] = cut[1] - cut[0]
            return dims

        got = _exchange(mesh.spatial,
                        [(q, g.narrow(axis, a - lo, b - a))
                         for q, (a, b) in ctx.recv],
                        [(r, shape(cut)) for r, cut in ctx.send], g)
        _count_halo(mesh, ctx.send, g)
        dx = g.new_zeros(ctx.shape)
        if ctx.own:
            a, b = ctx.own
            dx.narrow(axis, a - mine[0], b - a).add_(g.narrow(axis, a - lo,
                                                              b - a))
        for (_, (a, b)), part in zip(ctx.send, got):
            dx.narrow(axis, a - mine[0], b - a).add_(part)
        return dx, None, None, None, None, None


def _count_halo(mesh: Mesh3D, received: list, like: torch.Tensor) -> None:
    planes = sum(b - a for _, (a, b) in received)
    mesh.counts["halo"] += 1
    mesh.counts["halo_planes"] += planes
    axis = like.ndim - 3
    per_plane = math.prod(n for i, n in enumerate(like.shape) if i != axis)
    mesh.counts["halo_bytes"] += planes * per_plane * like.element_size()


def _halo(x, mesh: Mesh3D, depth: int, need: list, fill=0.0):
    sp = mesh.spatial
    owned = [depth_slab(depth, q, sp.size) for q in range(sp.size)]
    if x.shape[x.ndim - 3] != owned[sp.rank][1] - owned[sp.rank][0]:
        raise ValueError(f"a slab of {x.shape[x.ndim - 3]} planes; spatial "
                         f"rank {sp.rank} of {sp.size} holds "
                         f"{owned[sp.rank]} of {depth}")
    return _Halo.apply(x, mesh, owned, [tuple(n) for n in need], depth,
                       float(fill))


def halo_planes(x: torch.Tensor, lo, hi, fill: float = 0.0, *,
                depth: Optional[int] = None,
                mesh: Optional[Mesh3D] = None) -> torch.Tensor:
    """The global depth planes [lo, hi) of the depth-sharded ``x`` (this
    rank's slab of a volume of global depth ``depth``, the block's depth
    table's by default), planes outside [0, depth) filled with ``fill``.
    ``lo`` and ``hi`` are this rank's bounds, or every spatial rank's as
    sequences (then no bounds are exchanged). Every spatial rank calls it;
    each plane moves once, from the rank that holds it, and its gradient
    goes back there."""
    ctx = active()
    if mesh is None:
        if ctx is None:
            raise ValueError("halo_planes needs mesh= or an open "
                             "tensor_parallel block")
        mesh = ctx.tp
    if depth is None:
        depth = ctx.global_depth(x)
    sp = mesh.spatial
    if isinstance(lo, int):
        bounds = sp.all_gather(torch.tensor([lo, hi], device=mesh.device))
        mesh.counts["all_gather"] += 1
        need = [tuple(b) for b in bounds.tolist()]
    else:
        need = list(zip(lo, hi))
    return _halo(x, mesh, depth, need, fill)


# ------------------------------------------------------------ the layers --


def channels(x: torch.Tensor, full: int, mode: str,
             tp: TensorParallel) -> torch.Tensor:
    """x (channels on axis 1, ``full`` of them in all) as a consumer takes
    it: ``"sharded"`` the rank's slice (a BatchNorm or row-split dense layer
    with sharded parameters), ``"partial"`` whole for a consumer whose model
    ranks each compute part of the result (a conv with a sharded kernel:
    its input cotangents are summed back), ``"replicated"`` whole for a
    consumer that every model rank runs alike."""
    mesh = tp.tp
    n = mesh.shape[1]
    if n == 1:
        return x
    sharded = x.shape[1] != full
    if sharded and x.shape[1] * n != full:
        raise ValueError(f"{x.shape[1]} channels are neither all {full} nor "
                         f"a 1/{n} slice of them")
    if mode == "sharded":
        return x if sharded else scatter_channels(x, mesh)
    if sharded:
        return gather_channels(x, mesh, reduce=mode == "partial")
    if mode == "partial" and x.requires_grad:
        return _CopyModel.apply(x, mesh)
    return x


def _param(t: torch.Tensor, full: int, tp: TensorParallel) -> torch.Tensor:
    """A 1-D parameter whole on every model rank (gathered where sharded;
    its consumers are replicated, so each rank keeps its own slice of the
    cotangent)."""
    if t.shape[0] == full:
        return t
    return _Gather.apply(t, tp.tp, 0, False)


def _out_size(n: int, k: int, stride: int, pad_lo: int, pad_hi: int,
              dilation: int = 1) -> int:
    return (n + pad_lo + pad_hi - dilation * (k - 1) - 1) // stride + 1


def _window(x, tp: TensorParallel, k: int, stride: int, pad_lo: int,
            pad_hi: int, dilation: int = 1, fill=0.0, clip: bool = False):
    """The depth window this spatial rank's outputs of a windowed op read:
    ``(x_window, first plane, global depth, global output depth, this
    rank's output planes)``; with ``clip`` the window stops at the
    volume's edges, else planes outside it are ``fill``."""
    sp = tp.tp.spatial
    depth = tp.global_depth(x)
    out = _out_size(depth, k, stride, pad_lo, pad_hi, dilation)
    need = []
    for q in range(sp.size):
        o_lo, o_hi = depth_slab(out, q, sp.size)
        lo = o_lo * stride - pad_lo
        hi = (o_hi - 1) * stride - pad_lo + dilation * (k - 1) + 1
        if o_hi == o_lo:
            hi = lo = max(lo, 0)
        if clip:
            lo, hi = max(lo, 0), min(hi, depth)
        need.append((lo, hi))
    xw = _halo(x, tp.tp, depth, need, fill)
    return xw, need[sp.rank][0], depth, out, depth_slab(out, sp.rank, sp.size)


def _empty(xw, shape, *keep) -> torch.Tensor:
    """An output slab of no planes that keeps its inputs in the graph, so
    that the rank's halo backward still runs (its planes serve others)."""
    y = xw.new_zeros(shape)
    for t in (xw,) + keep:
        if t is not None:
            y = y + t.sum() * 0
    return y


def conv3d(conv, x: torch.Tensor, weight: torch.Tensor, bias,
           depth_pad: Optional[tuple] = None) -> torch.Tensor:
    """``conv``'s convolution of x under the open block: the input channels
    gathered where the kernel is sharded on O, the depth window fetched
    from the neighbours, the depth padding (``depth_pad`` (lo, hi) where
    given, else the module's) replaced by the halo's zeros."""
    tp = active()
    sharded = weight.shape[0] != conv.out_channels
    x = channels(x, conv.in_channels,
                 "partial" if sharded else "replicated", tp)
    if tp.tp.shape[2] == 1:
        if depth_pad is not None:
            x = F.pad(x, (0, 0, 0, 0) + tuple(depth_pad))
        return conv._conv_forward(x, weight, bias)
    if isinstance(conv.padding, str):
        raise ValueError("a depth-sharded conv takes integer padding, not "
                         f"{conv.padding!r}")
    (k, kh, kw), (st, sh, sw) = conv.kernel_size, conv.stride
    (dl, dh, dw), (_, ph, pw) = conv.dilation, conv.padding
    lo, hi = depth_pad if depth_pad is not None else (conv.padding[0],) * 2
    xw, _, _, out, (o_lo, o_hi) = _window(x, tp, k, st, lo, hi, dl)
    h_out = _out_size(x.shape[-2], kh, sh, ph, ph, dh)
    w_out = _out_size(x.shape[-1], kw, sw, pw, pw, dw)
    tp.record((h_out, w_out), out)
    if o_hi == o_lo:
        return _empty(xw, (x.shape[0], weight.shape[0], 0, h_out, w_out),
                      weight, bias)
    return F.conv3d(xw, weight, bias, conv.stride, (0, ph, pw),
                    conv.dilation, conv.groups)


def linear(lin, x: torch.Tensor, weight: torch.Tensor, bias) -> torch.Tensor:
    """``lin``'s dense layer under the open block: with its weight sharded
    on the input features, the rank's partial product summed over the
    model group and the bias added once after the sum; else on the whole
    input. The output is the same on every model rank."""
    tp = active()
    if weight.shape[1] != lin.in_features:
        x = channels(x, lin.in_features, "sharded", tp)
        y = sum_model(F.linear(x, weight), tp.tp)
    else:
        x = channels(x, lin.in_features, "replicated", tp)
        y = F.linear(x, weight)
    if bias is not None:
        y = y + _param(bias, lin.out_features, tp)
    return y


def pool_window(x: torch.Tensor, k: int, stride: int, pad: int, fill,
                pool, clip: bool = False) -> torch.Tensor:
    """A max pool (window ``k``, ``stride``, depth padding ``pad``) of a
    depth-sharded x: ``pool(x_window, first, depth)`` on the planes this
    rank's outputs read (``clip``: the window stops at the volume's edges
    and ``pool`` pads them itself; else they are ``fill``)."""
    tp = active()
    xw, first, depth, out, (o_lo, o_hi) = _window(x, tp, k, stride, pad, pad,
                                                  fill=fill, clip=clip)
    hw = tuple(_out_size(n, k, stride, pad, pad) for n in x.shape[-2:])
    tp.record(hw, out)
    if o_hi == o_lo:
        return _empty(xw, tuple(x.shape[:2]) + (0,) + hw)
    return pool(xw, first, depth)


def global_avg_pool(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The mean over (D, H, W) of a depth-sharded (B, C, D, H, W) x: the
    slab's float32 sums added over the spatial group, divided by the global
    count, in x's dtype."""
    sums = all_reduce_sum(x.sum(dim=(2, 3, 4), dtype=torch.float32),
                          tp.tp.spatial)
    n = tp.global_depth(x) * x.shape[3] * x.shape[4]
    return (sums / n).to(x.dtype)
