"""Data parallelism over ``torch.distributed`` (the port's parallelism layer).

Port of ``multimodal_alzheimer_tpu/parallel/mesh.py``. On a JAX mesh one
controller drives every device and GSPMD inserts the collectives. Here one
process runs per rank, every rank makes the same calls on the same global
inputs (SPMD), each keeps its own rows, and the collectives below make the
result the single-device one:

* ``Mesh``: the ranks of an initialised process group, this process's rank
  and its device (``cuda:{rank % device_count}`` unless the caller asks for
  the CPU). The caller names the backend when it initialises the group
  (``"nccl"`` on the card, ``"gloo"`` on the CPU or for several ranks on one
  card); nothing here falls back to another one.
* ``shard_batch``: the rank's contiguous block of rows of a global batch,
  JAX's ``P("data")`` layout, as a ``BatchShard``; ``replicate``: rank 0's
  parameters, buffers and optimizer state broadcast to every rank.
* ``data_parallel(mesh, global_rows, offset)``: while it is open, the
  layers read ``current()`` (or ``split()``, which leaves out a one-rank
  mesh): BatchNorm takes its statistics over the global batch, dropout
  draws its mask at the global shape, the losses divide by global sums.
* ``all_reduce_sum``: a sum over the ranks that autograd differentiates
  (the backward sums the cotangents); ``gather_rows``: every rank's rows
  into the global batch on every rank, by an all-gather on nccl and an
  all-reduce of a zero-filled buffer on gloo (whose ``all_gather`` takes
  CPU tensors only).

Every collective adds one to ``Mesh.counts``.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"

_STATE = threading.local()


@dataclass(eq=False)
class Mesh:
    """A 1-D data-parallel mesh: ``size`` ranks of ``group``, this
    process's ``rank`` in it and its ``device``."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str
    counts: dict = field(default_factory=lambda: {"all_reduce": 0,
                                                  "broadcast": 0})

    def _src(self, src: int) -> int:
        return dist.get_global_rank(self.group, src)

    def _object_device(self):
        return self.device if self.backend == "nccl" else None

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place."""
        dist.all_reduce(t, group=self.group)
        self.counts["all_reduce"] += 1
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place."""
        dist.broadcast(t, self._src(src), group=self.group)
        self.counts["broadcast"] += 1
        return t

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s picklable ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, self._src(src), group=self.group,
                                   device=self._object_device())
        self.counts["broadcast"] += 1
        return box[0]

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (of one shape) stacked in rank order, (size,
        ...) on every rank; not counted (the caller counts its kind). On
        nccl ``all_gather_into_tensor``; on gloo, whose ``all_gather``
        takes CPU tensors only, an all-reduce of a zero-filled buffer, which
        moves twice the bytes."""
        shape = (self.size,) + tuple(t.shape)
        if self.backend == "nccl":
            out = t.new_empty(shape)
            dist.all_gather_into_tensor(out, t.contiguous(),
                                        group=self.group)
            return out
        out = t.new_zeros(shape)
        out[self.rank] = t
        dist.all_reduce(out, group=self.group)
        return out

    def reset_counts(self) -> None:
        for name in self.counts:
            self.counts[name] = 0

    def rows(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` global rows."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split evenly over the mesh's "
                             f"{self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def make_mesh(n_devices: Optional[int] = None, *, group=None,
              device="cuda") -> Optional[Mesh]:
    """The mesh of the first ``n_devices`` ranks (all by default) of
    ``group`` (the default group by default), which must be initialised.
    Every rank of ``group`` calls it; a rank outside the first
    ``n_devices`` gets None. ``device="cpu"`` keeps the mesh on the CPU."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: call "
            "torch.distributed.init_process_group(backend, ...) first")
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        if not 1 <= n_devices <= size:
            raise ValueError(f"n_devices={n_devices} outside 1..{size}")
        members = [dist.get_global_rank(group, i) for i in range(n_devices)]
        sub = dist.new_group(members)
        if dist.get_rank() not in members:
            return None
        group, size = sub, n_devices
    backend = str(dist.get_backend(group))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} asked for, but CUDA is not "
                               f"available")
        device = torch.device("cuda",
                              dist.get_rank() % torch.cuda.device_count())
    elif backend == "nccl":
        raise ValueError("the nccl backend takes CUDA tensors only: a CPU "
                         "mesh needs gloo")
    return Mesh(group, dist.get_rank(group), size, device, backend)


@dataclass(frozen=True)
class Sharding:
    """Where a batch's rows live on ``mesh``: split over the data axis
    (``spec == (DATA_AXIS,)``) or whole on every rank (``spec == ()``)."""

    mesh: Mesh
    spec: tuple

    @property
    def is_fully_replicated(self) -> bool:
        return not self.spec


def batch_sharding(mesh: Mesh) -> Sharding:
    """Shard the leading (batch) axis across the data axis."""
    return Sharding(mesh, (DATA_AXIS,))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


class BatchShard(dict):
    """This rank's rows of a global batch of ``global_rows`` rows: a batch
    dict whose rows start at global row ``offset``."""

    def __init__(self, arrays: dict, global_rows: int, offset: int):
        super().__init__(arrays)
        self.global_rows = int(global_rows)
        self.offset = int(offset)


def batch_rows(batch: dict) -> int:
    return int(next(iter(batch.values())).shape[0])


def shard_batch(batch: dict, mesh: Mesh) -> BatchShard:
    """The rank's block of a host or device batch, on the mesh's device."""
    n = batch_rows(batch)
    rows = mesh.rows(n)
    return BatchShard({k: torch.as_tensor(v)[rows].to(mesh.device)
                       for k, v in batch.items()}, n, rows.start)


def tensors_of(tree) -> list:
    """The tensors of a TrainState, module, optimizer, or a nest of dicts
    and sequences of them, detached (so writing them writes the state)."""
    if isinstance(tree, torch.Tensor):
        return [tree.detach()]
    if isinstance(tree, torch.nn.Module):
        return [t.detach() for t in tree.state_dict(keep_vars=True).values()]
    if isinstance(tree, torch.optim.Optimizer):
        return [t.detach() for state in tree.state.values()
                for t in state.values() if isinstance(t, torch.Tensor)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    if hasattr(tree, "model"):  # train.state.TrainState
        return tensors_of(tree.model) + (
            tensors_of(tree.optimizer) if tree.optimizer is not None
            else [])
    return []


def coalesced_(tensors: list, mesh: Mesh, op: str) -> None:
    """``op`` ("all_reduce" or "broadcast" from rank 0) over ``tensors`` in
    place, one collective per dtype: the tensors are packed into one flat
    buffer on the mesh's device."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1).to(mesh.device) for t in group])
        if op == "all_reduce":
            mesh.all_reduce_(flat)
        else:
            mesh.broadcast_(flat)
        start = 0
        for t in group:
            t.copy_(flat[start:start + t.numel()].view_as(t))
            start += t.numel()


def replicate(tree, mesh: Mesh):
    """Rank 0's tensors of ``tree`` (a ``TrainState``, module, optimizer or
    a nest of dicts and sequences of tensors) on every rank, in place;
    returns ``tree``."""
    with torch.no_grad():
        coalesced_(tensors_of(tree), mesh, "broadcast")
    return tree


@dataclass(frozen=True)
class DataParallel:
    """The global batch a rank's rows belong to."""

    mesh: Mesh
    global_rows: int
    offset: int

    def global_count(self, x: torch.Tensor) -> int:
        """Elements per channel (axis 1) of the global batch of which ``x``
        holds this rank's rows."""
        return x.numel() // x.shape[1] // x.shape[0] * self.global_rows

    @property
    def is_split(self) -> bool:
        """Whether the batch is split over more than one rank."""
        return self.mesh.size > 1

    def stats_mesh(self, x: torch.Tensor) -> Mesh:
        """The ranks over which a BatchNorm of ``x`` sums its statistics."""
        return self.mesh

    def stats_count(self, x: torch.Tensor) -> int:
        """Elements per channel of ``x``'s global BatchNorm statistics."""
        return self.global_count(x)


@contextlib.contextmanager
def data_parallel(mesh: Mesh, global_rows: int, offset: int):
    """Layers in this thread see the rank's rows as part of a global batch
    of ``global_rows`` rows starting at ``offset`` while the block runs."""
    before = getattr(_STATE, "dp", None)
    _STATE.dp = DataParallel(mesh, int(global_rows), int(offset))
    try:
        yield _STATE.dp
    finally:
        _STATE.dp = before


def current() -> Optional[DataParallel]:
    """The open ``data_parallel`` block of this thread, or None."""
    return getattr(_STATE, "dp", None)


def split() -> Optional[DataParallel]:
    """``current()`` where its batch is split over more than one rank, else
    None. The layers whose global formula rounds otherwise than their
    single-device one (``F.batch_norm``, a mean) read this, so that a
    one-rank mesh computes the mesh-free step bit for bit; the BatchNorm
    kernels' sums are all-reduced at any size (over one rank, a copy)."""
    dp = current()
    return dp if dp is not None and dp.is_split else None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.clone()), None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks; its gradient is the sum of the
    ranks' cotangents (each rank's loss reaches every rank's ``x``)."""
    return _AllReduceSum.apply(x, mesh)


def gather_rows(x, dp: DataParallel):
    """Every rank's rows of ``x`` (this rank's at ``dp.offset``; or of each
    tensor of a nest of dicts) as the global batch, on every rank. On nccl
    an all-gather (counted as one, under ``"all_gather"``), which needs
    the rank's block of rows at ``rank * rows``, as ``Mesh.rows`` gives
    it; on gloo an all-reduce of a zero-filled buffer."""
    if isinstance(x, dict):
        return {k: gather_rows(v, dp) for k, v in x.items()}
    mesh, rows = dp.mesh, x.shape[0]
    if mesh.backend == "nccl":
        if rows * mesh.size != dp.global_rows or \
                dp.offset != mesh.rank * rows:
            raise ValueError(f"rows [{dp.offset}, {dp.offset + rows}) of "
                             f"{dp.global_rows} are not rank {mesh.rank}'s "
                             f"block of {mesh.size}")
        out = mesh.all_gather(x).reshape((dp.global_rows,)
                                         + tuple(x.shape[1:]))
        mesh.counts["all_gather"] = mesh.counts.get("all_gather", 0) + 1
        return out
    out = torch.zeros((dp.global_rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[dp.offset:dp.offset + rows] = x
    return mesh.all_reduce_(out)
