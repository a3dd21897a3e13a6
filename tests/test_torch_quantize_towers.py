"""The port's int8 PET tower and fusion serving graphs
(``inference/quantize.py``) against the JAX package's on the CPU.

Split from tests/test_torch_quantize.py, whose helpers and tolerances
(stated there) it uses: the PET quantizer with and without BatchNorm and
its hidden Linear, an even kernel, its folded float32 calibration graph
(rtol 2e-4, atol 2e-5 of the float model), the stage-2 quantizer with and
without ``quantize_pet``, stage 3's with and without it, the folded fusion
serves in float32 (probability error below 1e-3, JAX's own bound) and
bfloat16 (argmax kept), and the ``share_towers`` refusals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.inference import quantize as JQ
from multimodal_alzheimer_tpu.models.fusion_models import (
    all_modalities_fusion as jax_stage3,
)
from multimodal_alzheimer_tpu.models.fusion_models.anat_pet_fusion import (
    AnatPETFusion as JaxAnatPETFusion,
)
from multimodal_alzheimer_tpu.models.fusion_models.tabular_mri_fusion import (
    TabularMRIFusion as JaxTabularMRIFusion,
)
from multimodal_alzheimer_tpu.models.pet_models.pet_cnn import (
    SmallPETCNN as JaxSmallPETCNN,
)
from multimodal_alzheimer_tpu.train import checkpoint as jax_checkpoint
from multimodal_alzheimer_tpu_torch.inference import quantize as Q
from multimodal_alzheimer_tpu_torch.models.convert import state_dict_from_flax
from multimodal_alzheimer_tpu_torch.models.fusion_models.all_modalities_fusion import (
    AllModalitiesFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.anat_pet_fusion import (
    AnatPETFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.tabular_mri_fusion import (
    TabularMRIFusion,
)
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
    SmallPETCNN,
)
from test_torch_quantize import FOLD_TOL, MRI_HP, _check_int8_pair
from torch_port_helpers import random_variables
from torch_threads import torch_threads  # noqa: F401 (autouse)


# --------------------------------------------------------------------------
# The PET tower
# --------------------------------------------------------------------------

PET_HP = {"n_classes": 3, "conv_out": (4, 16, 32), "filter_size": (5, 3, 3),
          "linear_out": 8}
PET_CASES = {
    "plain": {},
    "bn": {"conv_out": (4, 8), "filter_size": (5, 3), "batchnorm": True},
    "no_hidden": {"n_classes": 2, "linear_out": 0},
    "even_kernel": {"conv_out": (4, 8), "filter_size": (4, 3)},
}


def _pet_pair(overrides, seed=20, spatial=(17, 18, 16)):
    hp = dict(PET_HP, **overrides)
    jax_model = JaxSmallPETCNN.from_hparams(hp)
    variables = random_variables(
        jax_model, seed, {"pet1451": jnp.zeros((1,) + spatial, jnp.float32)},
        train=False)
    port = SmallPETCNN.from_hparams(hp)
    port.load_state_dict(state_dict_from_flax(variables, port))
    rng = np.random.default_rng(seed)
    vol = rng.normal(0.5, 0.5, (2,) + spatial).astype(np.float32)
    return (jax_model, variables, port.eval(), {"pet1451": jnp.asarray(vol)},
            {"pet1451": torch.from_numpy(vol)})


@pytest.mark.parametrize("label", list(PET_CASES))
def test_quantize_pet_cnn_matches_jax(label):
    jax_model, variables, port, jb, pb = _pet_pair(PET_CASES[label])
    specs = Q._pet_block_specs(port)
    assert specs == JQ._pet_block_specs(jax_model, variables)
    jax_serve, jq = JQ.quantize_pet_cnn(jax_model, variables, [jb])
    port_serve, pq = Q.quantize_pet_cnn(port, [pb])
    assert set(pq["scales"]) == set(jq["scales"])
    for site, s in jq["scales"].items():  # float32 graphs in other orders
        assert pq["scales"][site] == pytest.approx(s, rel=1e-5), site
    _check_int8_pair(jax_model, variables, jax_serve, port, port_serve, jb,
                     pb)


def test_pet_calibration_graph_matches_float():
    """The folded float32 PET graph (BN folded) equals the model's eval
    forward."""
    _, _, port, _, pb = _pet_pair(PET_CASES["bn"])
    specs = Q._pet_block_specs(port)
    with torch.no_grad():
        fmap = Q._pet_tower_forward(Q.fold_pet_tower(port, specs),
                                    pb["pet1451"][:, None], Q._FloatCtx(),
                                    specs)
        ref = port.convs(pb["pet1451"][:, None])
    np.testing.assert_allclose(fmap.numpy(), ref.numpy(), **FOLD_TOL)


# --------------------------------------------------------------------------
# The fusions: int8 or folded towers through the ``towers=`` hook
# --------------------------------------------------------------------------

FUSION_PET = {"n_classes": 3, "conv_out": (4,), "filter_size": (3,),
              "linear_out": 8}
FUSION_TAB = {"n_classes": 3, "hidden": (16, 32)}
FUSION_S = (16, 16, 16)


def _fusion_batch(seed, keys=("pet1451", "mri", "tabular")):
    rng = np.random.default_rng(seed)
    shapes = {"pet1451": (2,) + FUSION_S, "mri": (2,) + FUSION_S,
              "tabular": (2, 9)}
    x = {k: rng.normal(size=shapes[k]).astype(np.float32) for k in keys}
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.from_numpy(v) for k, v in x.items()})


def _stage2_pair(kind):
    hp2 = {"n_classes": 3, "lr": 1e-3, "lr_pretrained": None}
    if kind == "anat_pet":
        args = (hp2, FUSION_PET, MRI_HP)
        jax_cls, port_cls, keys = JaxAnatPETFusion, AnatPETFusion, (
            "pet1451", "mri")
    else:
        args = (hp2, MRI_HP, FUSION_TAB)
        jax_cls, port_cls, keys = JaxTabularMRIFusion, TabularMRIFusion, (
            "mri", "tabular")
    jb, pb = _fusion_batch(9, keys)
    jax_model = jax_cls.from_hparams(*args)
    variables = random_variables(jax_model, 3, jb, train=False)
    port = port_cls.from_hparams(*args)
    port.load_state_dict(state_dict_from_flax(variables, port))
    return jax_model, variables, port.eval(), jb, pb


@pytest.mark.parametrize("kind,quantize_pet", [("anat_pet", False),
                                               ("anat_pet", True),
                                               ("mri_tab", False)])
def test_quantize_mri_fusion_matches_jax(kind, quantize_pet):
    jax_model, variables, port, jb, pb = _stage2_pair(kind)
    jax_serve, jq = JQ.quantize_mri_fusion(jax_model, variables, [jb],
                                           quantize_pet=quantize_pet)
    port_serve, pq = Q.quantize_mri_fusion(port, [pb],
                                           quantize_pet=quantize_pet)
    assert set(pq) == set(jq)
    _check_int8_pair(jax_model, variables, jax_serve, port, port_serve, jb,
                     pb)
    if kind == "mri_tab":
        with pytest.raises(ValueError, match="pet_model"):
            Q.quantize_mri_fusion(port, [pb], quantize_pet=True)
        serve32, _ = Q.fold_mri_fusion(port, dtype=torch.float32)
        err = Q.quantization_error(port, serve32, pb)
        assert err["argmax_agree"] == 1.0 and err["prob_max_abs_err"] < 1e-3


@pytest.fixture(scope="module")
def stage3():
    hp2 = {"n_classes": 3}  # no lr_pretrained: frozen, shared towers
    args = ({"n_classes": 3, "lr": 1e-3, "lr_pretrained": None}, hp2, hp2,
            hp2, FUSION_PET, MRI_HP, FUSION_TAB)
    jb, pb = _fusion_batch(7)
    jax_model = jax_stage3.AllModalitiesFusion.from_hparams(*args)
    variables = jax_checkpoint.sync_tower_duplicates(
        random_variables(jax_model, 4, jb, train=False))
    port = AllModalitiesFusion.from_hparams(*args)
    port.load_state_dict(state_dict_from_flax(variables, port))
    assert port.share_towers and jax_model.share_towers
    return jax_model, variables, port.eval(), jb, pb


@pytest.mark.parametrize("quantize_pet", [False, True])
def test_quantize_all_modalities_fusion_matches_jax(stage3, quantize_pet):
    jax_model, variables, port, jb, pb = stage3
    jax_serve, _ = JQ.quantize_all_modalities_fusion(
        jax_model, variables, [jb], quantize_pet=quantize_pet)
    port_serve, pq = Q.quantize_all_modalities_fusion(
        port, [pb], quantize_pet=quantize_pet)
    assert ({"mri", "pet"} if quantize_pet else {"scales", "config"}) \
        <= set(pq)
    _check_int8_pair(jax_model, variables, jax_serve, port, port_serve, jb,
                     pb)


def test_stage3_folded_and_unshared(stage3):
    _, _, port, _, pb = stage3
    serve32, _ = Q.fold_all_modalities_fusion(port, dtype=torch.float32)
    err = Q.quantization_error(port, serve32, pb)
    assert err["argmax_agree"] == 1.0 and err["prob_max_abs_err"] < 1e-3, err
    err16 = Q.quantization_error(port, Q.fold_all_modalities_fusion(port)[0],
                                 pb)
    assert err16["argmax_agree"] == 1.0, err16
    port.share_towers = False
    try:
        for build in (lambda: Q.quantize_all_modalities_fusion(port, [pb]),
                      lambda: Q.fold_all_modalities_fusion(port)):
            with pytest.raises(ValueError, match="share_towers"):
                build()
    finally:
        port.share_towers = True


def test_fusion_serves_leave_the_callers_mode():
    # Building or calling a fusion serve runs the fusion in eval mode and
    # leaves every module of the caller's model in the mode it was in; a
    # serve built from a model in training mode gives the eval serve's bits.
    _, _, port, _, pb = _stage2_pair("mri_tab")
    eval_out = Q.quantize_mri_fusion(port, [pb])[0](pb)
    port.train()
    modes = [m.training for m in port.modules()]
    builds = {"int8": lambda: Q.quantize_mri_fusion(port, [pb])[0],
              "folded": lambda: Q.fold_mri_fusion(port,
                                                  dtype=torch.float32)[0]}
    outs = {}
    for name, build in builds.items():
        serve = build()
        assert [m.training for m in port.modules()] == modes, name
        outs[name] = serve(pb)
        assert [m.training for m in port.modules()] == modes, name
    for key in ("logits", "probs"):
        assert torch.equal(outs["int8"][key], eval_out[key]), key
