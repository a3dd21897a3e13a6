"""Train state and the train/eval steps (the Lightning-loop replacement).

Port of ``multimodal_alzheimer_tpu/train/state.py``. The contract is JAX's:
the preprocess runs inside the step, on the device, and a step returns
``{'loss', 'logits', 'labels'}`` (the reference's general_step dict,
pet_cnn.py:60-70). PyTorch updates the model and the optimizer in place, so
``TrainState`` holds them with the step count and the plateau multiplier
``lr_scale``; the step returns the same state object.

With a ``parallel.Mesh`` a step given a ``BatchShard`` (the rank's rows,
``parallel.shard_batch``) runs them inside ``parallel.data_parallel``, sums
every gradient over the ranks in one flat buffer before the update, and
returns the global loss and the gathered logits and labels: the
single-device step, as GSPMD runs it under JAX's mesh. A batch that is
not a shard (a ragged tail whose rows do not split evenly over the ranks)
runs whole on every rank, with no collective, as JAX replicates it.

With a ``parallel.Mesh3D`` (``parallel/tp.py``, JAX's ``make_mesh_3d``) a
step given a ``BatchShard3D`` (``shard_batch_3d``: the rank's rows and depth
slabs) of a state sharded by ``shard_state`` runs inside
``parallel.tensor_parallel``: the rank back-propagates its data row's loss
divided by the spatial axis' size, the gradients are summed over data x
spatial only (a parameter whole on every model rank, the classifier's
bias, has the same gradient there and is not summed over the model
ranks), the loss over the data axis, and the logits and labels come back
gathered over the data axis, as under the 1-D mesh.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from multimodal_alzheimer_tpu_torch.models.layers import set_dropout_generator
from multimodal_alzheimer_tpu_torch.parallel.mesh import (
    BatchShard,
    Mesh,
    coalesced_,
    data_parallel,
    gather_rows,
)
from multimodal_alzheimer_tpu_torch.parallel.tp import (
    BatchShard3D,
    Mesh3D,
    tensor_parallel,
)
from multimodal_alzheimer_tpu_torch.utils.profiling import span


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optional[torch.optim.Optimizer]
    step: int = 0
    lr_scale: float = 1.0  # ReduceLROnPlateau multiplier (host-updated)

    def state_dict(self) -> dict:
        """The model's parameters and BatchNorm statistics."""
        return self.model.state_dict()


def _set_learning_rates(optimizer: torch.optim.Optimizer,
                        lr_scale: float) -> None:
    """Each group's lr = its base lr * ``lr_scale``: Adam's update is
    linear in lr, so this is exactly JAX's scaling of the updates, with the
    moments kept."""
    for group in optimizer.param_groups:
        group["lr"] = group.setdefault("base_lr", group["lr"]) * lr_scale


def _zero_unreached_grads(optimizer: torch.optim.Optimizer) -> None:
    """A trained parameter the loss does not reach (a fusion tower's own
    classifier) gets a zero gradient, which optax's chain sees in JAX, so
    the L2 term still moves it; torch's Adam would skip a ``None``."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def _sharded(batch: dict, mesh):
    """The ``data_parallel`` (or, on a 3-D mesh, ``tensor_parallel``)
    block of a shard, a null context else."""
    if not isinstance(batch, BatchShard):
        return contextlib.nullcontext()
    if mesh is None:
        raise ValueError("a BatchShard needs a step built with mesh=")
    if isinstance(mesh, Mesh3D):
        if not isinstance(batch, BatchShard3D):
            raise ValueError("a 3-D mesh takes shard_batch_3d's batches")
        return tensor_parallel(mesh, batch)
    return data_parallel(mesh, batch.global_rows, batch.offset)


def _reduction_meshes(mesh) -> tuple:
    """(the ranks the gradients are summed over, the ranks the loss is
    summed over, the divisor of the loss each rank back-propagates)."""
    if isinstance(mesh, Mesh3D):
        return mesh.data_spatial, mesh.data, mesh.shape[2]
    return mesh, mesh, 1


def _gathered(dp, tree: dict) -> dict:
    """The global batch's outputs of a shard's step, ``tree`` else."""
    return tree if dp is None else gather_rows(tree, dp)


def make_train_step(model: torch.nn.Module, criterion: Callable,
                    optimizer: torch.optim.Optimizer,
                    preprocess: Optional[Callable] = None,
                    dropout_generator: Optional[torch.Generator] = None,
                    mesh: Optional[Mesh | Mesh3D] = None):
    """Build ``step(state, batch) -> (state, aux)``: preprocess, forward in
    train mode (BatchNorm statistics update), loss, backward, Adam update.
    ``aux`` holds the detached 'loss', 'logits' and 'labels'. Each phase is
    a ``utils.profiling.span`` inside ``mmalz.step`` (``.preprocess``,
    ``.forward``, ``.loss``, ``.backward``, ``.optimizer``, the mesh's
    all-reduces in the last), recorded where a profiler runs.

    The model's dropout layers draw their masks from ``dropout_generator``
    (on the model's device), whose state advances with every step: JAX
    passes ``rngs={"dropout": ...}`` with a fresh key per step. A model with
    no dropout draws nothing from it."""
    if dropout_generator is not None:
        set_dropout_generator(model, dropout_generator)

    def train_step(state: TrainState, batch: dict):
        with span("mmalz.step"):
            model.train()
            with _sharded(batch, mesh) as dp:
                if preprocess is not None:
                    with span("mmalz.step.preprocess"):
                        batch = preprocess(batch)
                _set_learning_rates(optimizer, state.lr_scale)
                optimizer.zero_grad(set_to_none=True)
                with span("mmalz.step.forward"):
                    out = model(batch)
                with span("mmalz.step.loss"):
                    loss = criterion(out["logits"], batch["label"])
                with span("mmalz.step.backward"):
                    if dp is None:
                        loss.backward()
                    else:
                        grad_mesh, loss_mesh, share = _reduction_meshes(mesh)
                        (loss if share == 1 else loss / share).backward()
            with span("mmalz.step.optimizer"):
                _zero_unreached_grads(optimizer)
                if dp is not None:
                    coalesced_([p.grad for group in optimizer.param_groups
                                for p in group["params"]], grad_mesh,
                               "all_reduce")
                    loss = loss_mesh.all_reduce_(loss.detach().clone())
                optimizer.step()
            state.step += 1
            return state, {"loss": loss.detach(),
                           **_gathered(dp, {"logits": out["logits"].detach(),
                                            "labels": batch["label"]})}

    return train_step


def make_eval_step(model: torch.nn.Module, criterion: Callable,
                   preprocess: Optional[Callable] = None,
                   mesh: Optional[Mesh | Mesh3D] = None):
    """``step(batch) -> {'loss', 'logits', 'labels', 'embeddings'}`` in eval
    mode (running BatchNorm statistics), without autograd; with ``mesh``, a
    ``BatchShard``'s outputs are the global batch's on every rank."""

    def eval_step(batch: dict) -> dict:
        model.eval()
        with torch.inference_mode(), _sharded(batch, mesh) as dp:
            if preprocess is not None:
                batch = preprocess(batch)
            out = model(batch)
            loss = criterion(out["logits"], batch["label"])
            if dp is not None:
                loss = _reduction_meshes(mesh)[1].all_reduce_(loss)
            return {"loss": loss, **_gathered(dp, {
                "logits": out["logits"], "labels": batch["label"],
                "embeddings": out["embeddings"]})}

    return eval_step
