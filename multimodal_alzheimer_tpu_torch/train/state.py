"""Train state and the train/eval steps (the Lightning-loop replacement).

Port of ``multimodal_alzheimer_tpu/train/state.py``. The contract is JAX's:
the preprocess runs inside the step, on the device, and a step returns
``{'loss', 'logits', 'labels'}`` (the reference's general_step dict,
pet_cnn.py:60-70). PyTorch updates the model and the optimizer in place, so
``TrainState`` holds them with the step count and the plateau multiplier
``lr_scale``; the step returns the same state object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from multimodal_alzheimer_tpu_torch.models.layers import set_dropout_generator


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


def make_train_step(model: torch.nn.Module, criterion: Callable,
                    optimizer: torch.optim.Optimizer,
                    preprocess: Optional[Callable] = None,
                    dropout_generator: Optional[torch.Generator] = None):
    """Build ``step(state, batch) -> (state, aux)``: preprocess, forward in
    train mode (BatchNorm statistics update), loss, backward, Adam update.
    ``aux`` holds the detached 'loss', 'logits' and 'labels'.

    The model's dropout layers draw their masks from ``dropout_generator``
    (on the model's device), whose state advances with every step: JAX
    passes ``rngs={"dropout": ...}`` with a fresh key per step. A model with
    no dropout draws nothing from it."""
    if dropout_generator is not None:
        set_dropout_generator(model, dropout_generator)

    def train_step(state: TrainState, batch: dict):
        model.train()
        if preprocess is not None:
            batch = preprocess(batch)
        _set_learning_rates(optimizer, state.lr_scale)
        optimizer.zero_grad(set_to_none=True)
        out = model(batch)
        loss = criterion(out["logits"], batch["label"])
        loss.backward()
        _zero_unreached_grads(optimizer)
        optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(),
                       "logits": out["logits"].detach(),
                       "labels": batch["label"]}

    return train_step


def make_eval_step(model: torch.nn.Module, criterion: Callable,
                   preprocess: Optional[Callable] = None):
    """``step(batch) -> {'loss', 'logits', 'labels', 'embeddings'}`` in eval
    mode (running BatchNorm statistics), without autograd."""

    def eval_step(batch: dict) -> dict:
        model.eval()
        with torch.inference_mode():
            if preprocess is not None:
                batch = preprocess(batch)
            out = model(batch)
            loss = criterion(out["logits"], batch["label"])
        return {"loss": loss, "logits": out["logits"],
                "labels": batch["label"], "embeddings": out["embeddings"]}

    return eval_step
