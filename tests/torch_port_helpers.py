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


def random_flax_variables(model, volume_shape, seed):
    """numpy {'params', 'batch_stats'} of ``model`` with non-trivial BN
    statistics and a positive classifier bias (keeps the trailing ReLU off
    its floor)."""
    example = {"mri": jnp.zeros((1,) + tuple(volume_shape), jnp.float32)}
    shapes = jax.eval_shape(
        lambda b: model.init(jax.random.PRNGKey(0), b, train=False), example)
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
