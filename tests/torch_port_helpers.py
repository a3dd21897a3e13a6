"""Shared fixtures for the PyTorch-port parity tests (tests/test_torch_*.py).

Weights are drawn with numpy from a seed into the JAX model's variable tree
(shapes from ``jax.eval_shape``, so no init is compiled), then converted to
the port with ``models.convert.state_dict_from_flax``.
"""

import jax
import jax.numpy as jnp
import numpy as np

from multimodal_alzheimer_tpu.models.mri_models.anat_cnn import (
    AnatCNN as JaxAnatCNN,
)
from multimodal_alzheimer_tpu_torch.models.convert import state_dict_from_flax
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN


def random_flax_variables(model, volume_shape, seed, input_key="mri"):
    """numpy {'params', 'batch_stats'} of ``model`` (which reads batch key
    ``input_key``) with non-trivial BN statistics and a positive classifier
    bias (keeps the trailing ReLU off its floor)."""
    example = {input_key: jnp.zeros((1,) + tuple(volume_shape), jnp.float32)}
    return random_variables(model, seed, example, train=False)


def random_variables(model, seed, *args, **kwargs):
    """``random_flax_variables`` for any flax model, whose ``init`` takes
    ``args`` and ``kwargs`` (e.g. a fusion's batch dict of 'mri', 'pet1451'
    and 'tabular', or TabPFN's sequence, labels and train count)."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        names = [p.key for p in path]
        name, shape = names[-1], s.shape
        if name == "kernel":
            x = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            x = rng.uniform(0.5, 1.5, shape)
        elif name == "mean":
            x = rng.uniform(-0.5, 0.5, shape)
        elif name == "var":
            x = rng.uniform(0.5, 1.5, shape)
        elif names[-2] == "cls":
            x = rng.uniform(0.5, 1.5, shape)
        else:
            x = rng.normal(size=shape) * 0.1
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def model_pair(hparams, volume_shape, seed=0, **overrides):
    """(jax model, jax variables, port model in eval mode) with the same
    weights."""
    jax_model = JaxAnatCNN.from_hparams(hparams, **overrides)
    variables = random_flax_variables(jax_model, volume_shape, seed)
    port = AnatCNN.from_hparams(hparams, **overrides)
    port.load_state_dict(state_dict_from_flax(variables, port))
    return jax_model, variables, port.eval()


class Trial:
    """optuna's suggest API from a seeded numpy generator; records the
    calls."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.calls = []

    def suggest_float(self, name, low, high, log=False):
        self.calls.append((name, low, high, log))
        return float(self.rng.uniform(low, high))

    def suggest_categorical(self, name, choices):
        self.calls.append((name, tuple(choices)))
        return choices[int(self.rng.integers(len(choices)))]


def run_unfused(fn, *args):
    """``jax.jit(fn)(*args)`` compiled without XLA's fusion pass. On the CPU
    the fused program may recompute a max's operand with other rounding than
    the max itself, and the ``x == max`` winner tests of the JAX "sf"/"wf"
    pool backward and of ``jnp.max``'s VJP (the ``s2d_pool`` blocks) then
    miss: early-layer gradients that finite differences refute. Unfused, the
    program agrees with eager JAX and with finite differences."""
    compiled = jax.jit(fn).lower(*args).compile(
        {"xla_disable_hlo_passes": "fusion"})
    return compiled(*args)
