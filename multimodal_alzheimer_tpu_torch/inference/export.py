"""Ahead-of-time export of serving graphs (``torch.export``).

Port of ``multimodal_alzheimer_tpu/inference/export.py``: a (model,
preprocess) pair or any serve core is traced by ``torch.export.export`` and
saved with ``torch.export.save`` to bytes, an artifact that reloads and runs
without the model's Python code. Weights and the quantized trees' tensors
are baked in as constants; the artifact is specialised to the example
batch's shapes, dtypes and device.

The port's kernels enter the traced graph as the custom ops
``mmalz_port::order_stats``, ``::minmax_apply``, ``::zscore`` (K1-K3,
``ops/hopper_norm.py``) and ``::int8_conv3d`` (K9, ``ops/int8_conv.py``), so
an artifact made on the card launches the same kernels. Unlike JAX's
StableHLO artifact it is therefore not self-contained: ``load_exported``
imports those modules to register the ops before it loads.
"""

from __future__ import annotations

import io

import torch


class _Serve(torch.nn.Module):
    """A serve core as a module, ``torch.export``'s unit; ``model`` (when
    given) is registered so its weights are the program's parameters."""

    def __init__(self, serve, model=None):
        super().__init__()
        self.serve = serve
        self.model = model

    def forward(self, batch: dict) -> dict:
        return self.serve(batch)


def _save(module: torch.nn.Module, example_batch: dict) -> bytes:
    with torch.no_grad():
        program = torch.export.export(module, (dict(example_batch),))
    program.example_inputs = None  # else the example batch is saved too
    buffer = io.BytesIO()
    torch.export.save(program, buffer)
    return buffer.getvalue()


def export_model(model, example_batch: dict, preprocess=None) -> bytes:
    """Serialize ``model``'s eval-mode inference, ``preprocess`` fused in,
    returning ``{'logits', 'probs'}``; see ``load_exported``."""
    model.eval()

    def serve(batch):
        if preprocess is not None:
            batch = preprocess(batch)
        logits = model(batch)["logits"]
        return {"logits": logits, "probs": torch.softmax(logits, dim=-1)}

    return _save(_Serve(serve, model), example_batch)


def export_serve_fn(serve_fn, example_batch: dict) -> bytes:
    """Serialize any serve core (batch dict -> output dict): the int8 and
    BN-folded serves of ``inference/quantize.py`` and the fusion serves with
    their towers; their trees are closure constants, baked in."""
    return _save(_Serve(serve_fn), example_batch)


def load_exported(blob: bytes):
    """Deserialize an artifact; returns ``fn(batch) -> outputs``."""
    from multimodal_alzheimer_tpu_torch.ops import (  # noqa: F401 (ops)
        hopper_norm,
        int8_conv,
    )

    module = torch.export.load(io.BytesIO(blob)).module()

    def serve(batch: dict) -> dict:
        with torch.no_grad():
            return module(dict(batch))

    return serve
