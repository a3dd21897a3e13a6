"""The port's AnatCNN against the JAX AnatCNN on converted weights (CPU).

Tolerance rtol 1e-3, atol 1e-4 (tests/test_weight_conversion.py): the two
frameworks sum the convolutions in another order, and the JAX stem is a
space-to-depth rewrite of the direct 7^3 conv the port runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.models.mri_models.anat_cnn import (
    AnatCNN as JaxAnatCNN,
)
from multimodal_alzheimer_tpu_torch.models.convert import state_dict_from_flax
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from torch_port_helpers import model_pair, random_flax_variables

TOL = dict(rtol=1e-3, atol=1e-4)

CONFIGS = {
    "r18_flagship": ({"n_classes": 3, "resnet_depth": 18,
                      "linear_out": ()}, (12, 14, 12)),
    "r10_strided": ({"n_classes": 3, "resnet_depth": 10,
                     "dilated": False}, (24, 28, 24)),
    "r10_bn_dense": ({"n_classes": 2, "resnet_depth": 10,
                      "batchnorm_begin": True, "linear_out": (16,),
                      "batchnorm_dense": True}, (12, 14, 12)),
    "r10_conv_ladder": ({"n_classes": 3, "resnet_depth": 10,
                         "conv_out": (8,), "filter_size": (2,),
                         "batchnorm_conv": True}, (32, 36, 32)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_and_gap_match_jax(name):
    hparams, shape = CONFIGS[name]
    hparams = dict(hparams)
    jax_model, variables, port = model_pair(
        hparams, shape, seed=1, dilated=hparams.pop("dilated", True))

    x = np.random.default_rng(2).random((3,) + shape).astype(np.float32)
    want = jax.jit(lambda v, b: jax_model.apply(v, b, train=False))(
        variables, {"mri": jnp.asarray(x)})
    with torch.inference_mode():
        got = port({"mri": torch.from_numpy(x)})

    logits = got["logits"].numpy()
    assert logits.dtype == np.float32 and logits.shape == (
        3, hparams["n_classes"])
    np.testing.assert_allclose(logits, np.asarray(want["logits"]), **TOL)
    np.testing.assert_allclose(
        got["embeddings"]["backbone_gap"].numpy(),
        np.asarray(want["embeddings"]["backbone_gap"]), **TOL)
    top2 = np.sort(np.asarray(want["logits"]), axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-3
    np.testing.assert_array_equal(
        logits.argmax(1)[clear], np.asarray(want["logits"]).argmax(1)[clear])


@pytest.mark.parametrize("depth", [34, 50])
def test_deep_backbones_convert_complete(depth):
    """The converted tree covers every entry of the port model, shape-exact
    (the conversion raises otherwise)."""
    hparams = {"n_classes": 3, "resnet_depth": depth}
    jax_model = JaxAnatCNN.from_hparams(hparams)
    variables = random_flax_variables(jax_model, (16, 16, 16), seed=3)
    port = AnatCNN.from_hparams(hparams, device="meta")
    sd = state_dict_from_flax(variables, port)
    target = port.state_dict()
    assert set(sd) == set(target)
    for key, value in sd.items():
        assert value.shape == target[key].shape, key


def _mutated(variables, how):
    params = dict(variables["params"])
    head = dict(params["head"])
    if how == "extra":
        head["surplus"] = {"kernel": np.zeros((2, 2), np.float32)}
    elif how == "missing":
        del head["cls"]
    else:  # shape
        head["cls"] = {"kernel": np.zeros((7, 3), np.float32),
                       "bias": head["cls"]["bias"]}
    params["head"] = head
    return {"params": params, "batch_stats": variables["batch_stats"]}


@pytest.mark.parametrize("how,error", [("extra", KeyError),
                                       ("missing", KeyError),
                                       ("shape", ValueError)])
def test_conversion_is_strict(how, error):
    hparams = {"n_classes": 3, "resnet_depth": 10}
    jax_model = JaxAnatCNN.from_hparams(hparams)
    variables = random_flax_variables(jax_model, (12, 14, 12), seed=4)
    port = AnatCNN.from_hparams(hparams, device="meta")
    with pytest.raises(error):
        state_dict_from_flax(_mutated(variables, how), port)


def test_from_hparams_rules():
    base = {"n_classes": 3, "resnet_depth": 10}
    assert AnatCNN.from_hparams({**base, "lr_pretrained": None},
                                device="meta").freeze_backbone
    assert not AnatCNN.from_hparams({**base, "lr_pretrained": 1e-4},
                                    device="meta").freeze_backbone
    assert not AnatCNN.from_hparams(base, device="meta").freeze_backbone
    with pytest.raises(ValueError, match="resnet_depth"):
        AnatCNN.from_hparams({**base, "resnet_depth": 26})


def test_seeded_init_is_reproducible():
    from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

    a = AnatCNN(3, 10, generator=make_generator(7))
    b = AnatCNN(3, 10, generator=make_generator(7))
    c = AnatCNN(3, 10, generator=make_generator(8))
    wa, wb, wc = (m.backbone.conv1.weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)

