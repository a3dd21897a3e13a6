"""Carry the JAX package's trained weights over to the port.

``state_dict_from_flax`` turns a flax ``{'params', 'batch_stats'}`` tree
(numpy leaves) into a ``state_dict`` for a port module whose submodule names
follow the flax tree (``models/resnet3d.py``, ``models/heads.py``):

  conv  kernel (D, H, W, I, O) -> weight (O, I, D, H, W)
  Dense kernel (in, out)       -> weight (out, in)
  BN    scale / bias / mean / var -> weight / bias / running_mean / running_var

The conversion is strict: a flax leaf with no counterpart, a model entry with
no flax leaf, or a shape mismatch raises. Flax keeps no batch counter, so
``num_batches_tracked`` is set to 0.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
               "mean": "running_mean", "var": "running_var"}
_COLLECTIONS = ("params", "batch_stats")


def _leaves(tree, path=()):
    for name, value in tree.items():
        if hasattr(value, "items"):
            yield from _leaves(value, path + (name,))
        else:
            yield path + (name,), value


def _to_torch_layout(name: str, arr: np.ndarray) -> np.ndarray:
    if name == "kernel" and arr.ndim == 5:
        return arr.transpose(4, 3, 0, 1, 2)
    if name == "kernel" and arr.ndim == 2:
        return arr.T
    return arr


def state_dict_from_flax(variables, model: nn.Module) -> dict:
    """Flax variables -> ``state_dict`` for ``model`` (load it strictly)."""
    extra = set(variables) - set(_COLLECTIONS)
    if extra:
        raise KeyError(f"unexpected flax collections {sorted(extra)}")
    target = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    for collection in _COLLECTIONS:
        for path, leaf in _leaves(variables.get(collection, {})):
            flax_name = f"{collection}/{'/'.join(path)}"
            if path[-1] not in _LEAF_NAMES:
                raise KeyError(f"no torch counterpart for {flax_name}")
            key = ".".join(path[:-1] + (_LEAF_NAMES[path[-1]],))
            if key not in target or key in out:
                raise KeyError(f"{flax_name} maps to {key!r}, which the "
                               f"model does not have or already got")
            arr = _to_torch_layout(path[-1], np.asarray(leaf, np.float32))
            if tuple(arr.shape) != tuple(target[key].shape):
                raise ValueError(f"{flax_name}: shape {arr.shape} does not "
                                 f"fit {key} {tuple(target[key].shape)}")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    for key, ref in target.items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros_like(ref, device="cpu")
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"model entries with no flax leaf: {missing}")
    return out
