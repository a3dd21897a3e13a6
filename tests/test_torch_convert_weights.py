"""The port's weight importers (``tools/convert_medicalnet.py``,
``tools/convert_reference.py`` of ``multimodal_alzheimer_tpu_torch``)
against the JAX package's root ``tools/`` converters, on the CPU.

The reference replicas are the JAX tests' own (``TorchMed3D``, the
``_Torch*`` fusion replicas of ``test_convert_fusion.py``), with seeded
random weights and BatchNorm statistics. For every one of the JAX package's
twelve conversion cases:

- the port's converted ``state_dict``, merged over a model's state
  (``merge_state_dicts``), equals bit for bit JAX's converter followed by
  ``merge_variables`` and ``models/convert.state_dict_from_flax`` over the
  same state, on every key (both copy the same float32 values; the flax
  layout's transposes are undone exactly);
- the converted port model's logits equal the replica's within rtol 1e-5,
  atol 1e-6, in float32 (the same torch convolutions on the same weights;
  BatchNorm and pooling sum in other orders).

Stage 3 in the frozen regime (``share_towers``) also gets its duplicate
towers synced, as JAX's ``sync_tower_duplicates`` does, so
``assert_tower_duplicates_equal`` holds. Then the Lightning ``.ckpt``
route (``convert_lightning_checkpoint`` and both CLIs' ``main``) through
the port's checkpoint loaders.
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import convert_medicalnet as jax_medicalnet  # noqa: E402
import convert_reference as jax_reference  # noqa: E402

from multimodal_alzheimer_tpu.models import (  # noqa: E402
    AllModalitiesFusion as JaxAllModalitiesFusion,
    AnatCNN as JaxAnatCNN,
    AnatPETFusion as JaxAnatPETFusion,
    PETMRIEarlyFusion as JaxPETMRIEarlyFusion,
    PETMRIFeatureMapFusion as JaxPETMRIFeatureMapFusion,
    PETResNetCNN as JaxPETResNetCNN,
    PETTabularFusion as JaxPETTabularFusion,
    SmallPETCNN as JaxSmallPETCNN,
    TabularMRIFusion as JaxTabularMRIFusion,
)
from multimodal_alzheimer_tpu.train.checkpoint import (  # noqa: E402
    sync_tower_duplicates as jax_sync_tower_duplicates,
)
from multimodal_alzheimer_tpu_torch.inference import (  # noqa: E402
    test_all_mod_fusion,
    test_anat_pet_fusion,
)
from multimodal_alzheimer_tpu_torch.models.convert import (  # noqa: E402
    flax_from_state_dict,
    state_dict_from_flax,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.all_modalities_fusion import (  # noqa: E402,E501
    AllModalitiesFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.anat_pet_fusion import (  # noqa: E402,E501
    AnatPETFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.early_fusion import (  # noqa: E402,E501
    PETMRIEarlyFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.featuremap_fusion import (  # noqa: E402,E501
    PETMRIFeatureMapFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.pet_tabular_fusion import (  # noqa: E402,E501
    PETTabularFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.tabular_mri_fusion import (  # noqa: E402,E501
    TabularMRIFusion,
)
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import (  # noqa: E402,E501
    AnatCNN,
)
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (  # noqa: E402,E501
    SmallPETCNN,
)
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_resnet_cnn import (  # noqa: E402,E501
    PETResNetCNN,
)
from multimodal_alzheimer_tpu_torch.models.resnet3d import (  # noqa: E402
    MedicalNetResNet3D,
)
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabpfn import (  # noqa: E402,E501
    convert_state_dict as convert_tabpfn_layout,
    model_from_state_dict,
)
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp import (  # noqa: E402,E501
    TabularMLP,
)
from multimodal_alzheimer_tpu_torch.tools import (  # noqa: E402
    convert_medicalnet,
    convert_reference as C,
)
from multimodal_alzheimer_tpu_torch.train.checkpoint import (  # noqa: E402
    assert_tower_duplicates_equal,
    graft_params,
    load_checkpoint,
    save_checkpoint,
)
from tests.test_convert_fusion import (  # noqa: E402
    MRI_HP,
    MRI_HP_NOBN,
    PET_HP_2,
    PET_HP_3,
    _inputs,
    _np_sd,
    _pet_sequential,
    _randomize_bn,
    _TorchAllMod,
    _TorchAnatCNN,
    _TorchAnatPET,
    _TorchPETTab,
    _TorchTabularMRT,
)
from tests.test_convert_reference import _torch_anat_cnn  # noqa: E402
from tests.test_pet_cnn_torch_parity import _torch_small_pet_cnn  # noqa: E402
from tests.test_tabpfn import TorchTabPFN  # noqa: E402
from tests.test_weight_conversion import TorchMed3D  # noqa: E402
from torch_port_helpers import random_variables  # noqa: E402
from torch_threads import torch_threads  # noqa: E402,F401 (autouse)

LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
GRID = (24, 28, 24)


def _torch_sd(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _logits(model, batch):
    model.eval()
    with torch.no_grad():
        out = model({k: torch.from_numpy(np.asarray(v))
                     for k, v in batch.items()})
    return out["logits"].numpy()


def _assert_bitwise(got: dict, want: dict):
    assert set(got) == set(want)
    for key in sorted(want):
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key].cpu(), want[key].cpu()), key


def _check_against_jax(jax_model, port_model, jax_partial, port_partial,
                       batch, expected):
    """The port's conversion merged over one random base state
    (``port_state_dict``) equals JAX's, bit for bit; a stage-3 model that
    shares its towers is held to JAX's ``sync_tower_duplicates`` of the
    merge. The port model then gives the replica's logits. Returns the
    merged state dict."""
    init_batch = {k: jnp.asarray(v) for k, v in batch.items()
                  if k != "tabular_embedding"}
    if "tabular_embedding" in batch:  # JAX builds the MLP on raw rows only
        init_batch["tabular"] = jnp.zeros((len(batch["mri"]), 9))
    base = random_variables(jax_model, 0, init_batch, train=False)
    merged = jax_reference.merge_variables(base, jax_partial)
    if getattr(port_model, "share_towers", False):
        merged = jax_sync_tower_duplicates(merged)
    want = state_dict_from_flax(merged, port_model)
    port_model.load_state_dict(state_dict_from_flax(base, port_model))
    got = C.port_state_dict(port_model, port_partial)
    _assert_bitwise(got, want)
    port_model.load_state_dict(got)
    np.testing.assert_allclose(_logits(port_model, batch), expected,
                               **LOGIT_TOL)
    return got


# --------------------------------------------------------------------------
# MedicalNet backbones (tests/test_weight_conversion.py)
# --------------------------------------------------------------------------

def _med3d(layers, seed):
    torch.manual_seed(seed)
    ref = TorchMed3D(layers).eval()
    _randomize_bn(ref)
    return ref


@pytest.mark.parametrize("depth,layers", [(10, (1, 1, 1, 1)),
                                          (18, (2, 2, 2, 2))])
def test_backbone_matches_medicalnet_and_jax(depth, layers):
    ref = _med3d(layers, depth)
    x = np.random.default_rng(0).normal(size=(2, 1) + GRID).astype(
        np.float32)
    with torch.no_grad():
        expected = ref(torch.from_numpy(x)).numpy()

    backbone = MedicalNetResNet3D(depth).eval()
    want = state_dict_from_flax(
        jax_medicalnet.convert_state_dict(_np_sd(ref), depth), backbone)
    got = C.merge_state_dicts(backbone.state_dict(),
                              convert_medicalnet.convert_state_dict(
                                  _torch_sd(ref), depth))
    _assert_bitwise(got, want)
    backbone.load_state_dict(got)
    with torch.no_grad():
        out = backbone(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, expected, **LOGIT_TOL)


@pytest.mark.parametrize("depth,layers", [(10, (1, 1, 1, 1)),
                                          (18, (2, 2, 2, 2))])
def test_converted_backbone_names_match_the_port(depth, layers):
    """Every name and shape of the port's backbone, and nothing else (the
    counterpart of JAX's converted-tree-equals-init test)."""
    converted = convert_medicalnet.convert_state_dict(
        _torch_sd(_med3d(layers, 1)), depth)
    target = MedicalNetResNet3D(depth).state_dict()
    assert set(converted) == set(target)
    for key, value in converted.items():
        assert value.shape == target[key].shape, key
        assert value.dtype == torch.float32, key


def test_batch_counter_and_running_var_change_nothing_in_eval():
    """The reference counted 1234 batches (``num_batches_tracked``) and
    keeps its unbiased ``running_var``; the port's BatchNorms, flax's or
    torch's statistics (``bn_torch_stats``), keep no counter, so the
    conversion drops it, and carries ``running_var`` as stored. In eval
    neither changes the output."""
    hp = {"n_classes": 3, "resnet_depth": 10, "batchnorm_begin": True,
          "linear_out": (16,)}
    ref = _torch_anat_cnn(hp)
    torch.manual_seed(3)
    _randomize_bn(ref)
    for m in ref.modules():
        if isinstance(m, nn.BatchNorm3d):
            m.num_batches_tracked.fill_(1234)
    ref.eval()
    converted = C.convert_anat_cnn(_torch_sd(ref), hp)
    assert not [k for k in converted if "num_batches_tracked" in k]
    assert torch.equal(converted["backbone.bn1.running_var"],
                       ref.model.bn1.running_var)
    x = np.random.default_rng(4).normal(size=(2,) + GRID).astype(np.float32)
    with torch.no_grad():
        expected = ref(torch.from_numpy(x).unsqueeze(1)).numpy()
    for torch_stats in (False, True):
        model = AnatCNN.from_hparams(hp, bn_torch_stats=torch_stats)
        model.load_state_dict(C.merge_state_dicts(model.state_dict(),
                                                  converted))
        np.testing.assert_allclose(_logits(model, {"mri": x}), expected,
                                   **LOGIT_TOL)


# --------------------------------------------------------------------------
# Stage-1 models (tests/test_convert_reference.py)
# --------------------------------------------------------------------------

def test_full_anat_cnn_conversion():
    hp = {"n_classes": 3, "resnet_depth": 10, "batchnorm_begin": True,
          "linear_out": (32,), "batchnorm_dense": False}
    torch.manual_seed(0)
    ref = _torch_anat_cnn(hp).eval()
    _randomize_bn(ref)
    x = np.random.default_rng(0).normal(size=(2, 1) + GRID).astype(
        np.float32)
    with torch.no_grad():
        expected = ref(torch.from_numpy(x)).numpy()
    batch = {"mri": x[:, 0]}
    _check_against_jax(JaxAnatCNN.from_hparams(hp), AnatCNN.from_hparams(hp),
                       jax_reference.convert_anat_cnn(_np_sd(ref), hp),
                       C.convert_anat_cnn(_torch_sd(ref), hp), batch,
                       expected)
    assert expected.min() >= 0  # the trailing-ReLU quirk


def test_small_pet_cnn_conversion():
    hp = {"n_classes": 3, "conv_out": (4, 8), "filter_size": (5, 3),
          "batchnorm": True, "linear_out": 16}
    torch.manual_seed(2)
    ref = _torch_small_pet_cnn((4, 8), (5, 3), True, 16, 3).eval()
    _randomize_bn(ref)
    sd = {f"model.{k}": v for k, v in ref.state_dict().items()}
    x = np.random.default_rng(3).normal(size=(2, 20, 24, 20)).astype(
        np.float32)
    with torch.no_grad():
        expected = ref(torch.from_numpy(x).unsqueeze(1)).numpy()
    _check_against_jax(
        JaxSmallPETCNN.from_hparams(hp), SmallPETCNN.from_hparams(hp),
        jax_reference.convert_small_pet_cnn(
            {k: v.numpy() for k, v in sd.items()}, hp),
        C.convert_small_pet_cnn(sd, hp), {"pet1451": x}, expected)


# --------------------------------------------------------------------------
# PET ResNet, the baselines and the fusions (tests/test_convert_fusion.py)
# --------------------------------------------------------------------------

def test_pet_resnet_cnn_conversion():
    hp = {"n_classes": 3, "resnet_depth": 10, "batchnorm_begin": True,
          "conv_out": (16,), "filter_size": (3,), "batchnorm_conv": True,
          "linear_out": (24,), "batchnorm_dense": False}
    torch.manual_seed(0)
    ref = _TorchAnatCNN(hp).eval()
    _randomize_bn(ref)
    batch = _inputs(1, with_tab=False)
    with torch.no_grad():
        expected = ref(torch.from_numpy(batch["pet1451"]).unsqueeze(1))
    _check_against_jax(
        JaxPETResNetCNN.from_hparams(hp), PETResNetCNN.from_hparams(hp),
        jax_reference.convert_anat_cnn(_np_sd(ref), hp),
        C.convert_anat_cnn(_torch_sd(ref), hp),
        {"pet1451": batch["pet1451"]}, expected.numpy())


def test_early_fusion_conversion():
    hp = {"n_classes": 2, "conv_out": (4, 8), "filter_size": (5, 3),
          "batchnorm": True, "linear_out": 16}
    torch.manual_seed(1)
    seq = _pet_sequential(hp, n_in=2).eval()
    _randomize_bn(seq)
    batch = _inputs(2, with_tab=False)
    x = torch.stack([torch.from_numpy(batch["pet1451"]),
                     torch.from_numpy(batch["mri"])], dim=1)
    with torch.no_grad():
        expected = seq(x).numpy()
    sd = {f"model.{k}": v for k, v in seq.state_dict().items()}
    _check_against_jax(
        JaxPETMRIEarlyFusion.from_hparams(hp),
        PETMRIEarlyFusion.from_hparams(hp),
        jax_reference.convert_small_pet_cnn(
            {k: v.numpy() for k, v in sd.items()}, hp),
        C.convert_small_pet_cnn(sd, hp), batch, expected)


def _featuremap_replica(hp, mode):
    def towers():
        mods, n_in = [], 1
        for c, k in zip(hp["conv_out"], hp["filter_size"]):
            mods += [nn.Conv3d(n_in, c, k, padding="same"),
                     nn.BatchNorm3d(c), nn.ReLU(), nn.MaxPool3d(2)]
            n_in = c
        return nn.Sequential(*mods)

    n_in = (2 * hp["conv_out"][-1] if mode == "concatenate"
            else hp["conv_out"][-1])
    fuse = nn.Sequential(
        nn.Conv3d(n_in, hp["n_out_fusion"], hp["filter_size_fusion"],
                  padding="same"),
        nn.BatchNorm3d(hp["n_out_fusion"]), nn.ReLU(), nn.MaxPool3d(2),
        nn.AdaptiveAvgPool3d(1), nn.Flatten(),
        nn.Linear(hp["n_out_fusion"], 64), nn.ReLU(),
        nn.Linear(64, hp["n_classes"]))

    class FMF(nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone_pet = towers()
            self.backbone_mri = towers()
            self.fuse_model = fuse

        def forward(self, x_pet, x_mri):
            a, b = self.backbone_pet(x_pet), self.backbone_mri(x_mri)
            fused = (torch.cat((a, b), dim=1) if mode == "concatenate"
                     else torch.max(torch.stack((a, b)), 0)[0])
            return self.fuse_model(fused)

    return FMF()


@pytest.mark.parametrize("mode,seed", [("concatenate", 3), ("maxout", 4)])
def test_featuremap_fusion_conversion(mode, seed):
    hp = {"n_classes": 2, "fusion_mode": mode, "conv_out": (4, 8),
          "filter_size": (5, 3), "batchnorm": True, "n_layers_fusion": 1,
          "n_out_fusion": 12, "filter_size_fusion": 3,
          "batchnorm_fusion": True}
    torch.manual_seed(seed)
    ref = _featuremap_replica(hp, mode).eval()
    _randomize_bn(ref)
    batch = _inputs(seed, with_tab=False)
    with torch.no_grad():
        expected = ref(torch.from_numpy(batch["pet1451"]).unsqueeze(1),
                       torch.from_numpy(batch["mri"]).unsqueeze(1)).numpy()
    _check_against_jax(
        JaxPETMRIFeatureMapFusion.from_hparams(hp),
        PETMRIFeatureMapFusion.from_hparams(hp),
        jax_reference.convert_featuremap_fusion(_np_sd(ref), hp),
        C.convert_featuremap_fusion(_torch_sd(ref), hp), batch, expected)


@pytest.mark.parametrize("n_classes,pet_hp,mri_hp,seed", [
    (2, PET_HP_2, MRI_HP_NOBN, 5),   # GAP tap, model[:-3]
    (3, PET_HP_3, MRI_HP, 6),        # dense tap, model[:-1], dropout indices
], ids=["2class", "3class"])
def test_anat_pet_fusion_conversion(n_classes, pet_hp, mri_hp, seed):
    hp = {"n_classes": n_classes, "lr": 1e-3}
    torch.manual_seed(seed)
    ref = _TorchAnatPET(hp, pet_hp, mri_hp).eval()
    _randomize_bn(ref)
    batch = _inputs(seed, with_tab=False)
    with torch.no_grad():
        expected = ref(torch.from_numpy(batch["pet1451"]).unsqueeze(1),
                       torch.from_numpy(batch["mri"]).unsqueeze(1)).numpy()
    _check_against_jax(
        JaxAnatPETFusion.from_hparams(hp, pet_hp, mri_hp),
        AnatPETFusion.from_hparams(hp, pet_hp, mri_hp),
        jax_reference.convert_anat_pet_fusion(_np_sd(ref), hp, pet_hp,
                                              mri_hp),
        C.convert_anat_pet_fusion(_torch_sd(ref), hp, pet_hp, mri_hp),
        batch, expected)


def test_tabular_mri_fusion_conversion():
    hp = {"n_classes": 3, "lr": 1e-3}
    torch.manual_seed(7)
    ref = _TorchTabularMRT(hp, MRI_HP).eval()
    _randomize_bn(ref)
    batch = _inputs(7)
    with torch.no_grad():
        expected = ref(torch.from_numpy(batch["tabular_embedding"]),
                       torch.from_numpy(batch["mri"]).unsqueeze(1)).numpy()
    tab_hp = {"n_classes": 3}
    _check_against_jax(
        JaxTabularMRIFusion.from_hparams(hp, MRI_HP, tab_hp),
        TabularMRIFusion.from_hparams(hp, MRI_HP, tab_hp),
        jax_reference.convert_tabular_mri_fusion(_np_sd(ref), hp, MRI_HP),
        C.convert_tabular_mri_fusion(_torch_sd(ref), hp, MRI_HP), batch,
        expected)


@pytest.mark.parametrize("simple,seed", [(True, 8), (False, 9)])
def test_pet_tabular_fusion_conversion(simple, seed):
    hp = {"n_classes": 2, "simple_dim_red": simple, "lr": 1e-3}
    torch.manual_seed(seed)
    ref = _TorchPETTab(hp, PET_HP_2).eval()
    _randomize_bn(ref)
    batch = _inputs(seed)
    with torch.no_grad():
        expected = ref(torch.from_numpy(batch["pet1451"]).unsqueeze(1),
                       torch.from_numpy(batch["tabular_embedding"])).numpy()
    tab_hp = {"n_classes": 2}
    _check_against_jax(
        JaxPETTabularFusion.from_hparams(hp, PET_HP_2, tab_hp),
        PETTabularFusion.from_hparams(hp, PET_HP_2, tab_hp),
        jax_reference.convert_pet_tabular_fusion(_np_sd(ref), hp, PET_HP_2),
        C.convert_pet_tabular_fusion(_torch_sd(ref), hp, PET_HP_2), batch,
        expected)


def _all_mod_replica(hp, ap_hp, at_hp, pt_hp, seed, shared):
    torch.manual_seed(seed)
    ref = _TorchAllMod(hp, _TorchAnatPET(ap_hp, PET_HP_3, MRI_HP),
                       _TorchTabularMRT(at_hp, MRI_HP),
                       _TorchPETTab(pt_hp, PET_HP_3)).eval()
    _randomize_bn(ref)
    if shared:
        # the frozen regime: both copies of a tower come from one stage-1
        # checkpoint
        ref.model_pet_tab.model_pet.load_state_dict(
            ref.model_anat_pet.model_pet.state_dict())
        ref.model_anat_tab.model_mri.load_state_dict(
            ref.model_anat_pet.model_mri.state_dict())
    return ref


def _all_mod_forward(ref, batch):
    with torch.no_grad():
        return ref(torch.from_numpy(batch["pet1451"]).unsqueeze(1),
                   torch.from_numpy(batch["mri"]).unsqueeze(1),
                   torch.from_numpy(batch["tabular_embedding"])).numpy()


@pytest.mark.parametrize("shared", [False, True],
                         ids=["towers_trained", "frozen_shared"])
def test_all_modalities_fusion_conversion(shared):
    """Unshared: the stage-2 hparams carry ``lr_pretrained`` (towers
    trained, duplicates differ; JAX's case). Shared: the frozen regime,
    where the converted state also gets its duplicates synced and passes
    ``assert_tower_duplicates_equal``."""
    hp = {"n_classes": 3, "lr": 1e-3}
    lr_pre = {} if shared else {"lr_pretrained": 1e-6}
    ap_hp = {"n_classes": 3, "lr": 1e-3, **lr_pre}
    at_hp = {"n_classes": 3, "lr": 1e-3, **lr_pre}
    pt_hp = {"n_classes": 3, "simple_dim_red": False, "lr": 1e-3, **lr_pre}
    ref = _all_mod_replica(hp, ap_hp, at_hp, pt_hp, 10, shared)
    batch = _inputs(10)
    hps = (hp, ap_hp, at_hp, pt_hp, PET_HP_3, MRI_HP, {"n_classes": 3})
    model = AllModalitiesFusion.from_hparams(*hps)
    assert model.share_towers == shared
    got = _check_against_jax(
        JaxAllModalitiesFusion.from_hparams(*hps), model,
        jax_reference.convert_all_modalities_fusion(
            _np_sd(ref), hp, ap_hp, at_hp, pt_hp, PET_HP_3, MRI_HP),
        C.convert_all_modalities_fusion(
            _torch_sd(ref), hp, ap_hp, at_hp, pt_hp, PET_HP_3, MRI_HP),
        batch, _all_mod_forward(ref, batch))
    if shared:
        assert_tower_duplicates_equal(got)
    else:  # the trained duplicates differ, and sharing is refused
        with pytest.raises(ValueError, match="duplicate"):
            assert_tower_duplicates_equal(got)


def test_merge_state_dicts_is_strict():
    base = {"a.weight": torch.zeros(2, 3), "bn.num_batches_tracked":
            torch.tensor(7)}
    merged = C.merge_state_dicts(base, {"a.weight": torch.ones(2, 3)})
    assert torch.equal(merged["a.weight"], torch.ones(2, 3))
    assert int(merged["bn.num_batches_tracked"]) == 0
    assert int(base["bn.num_batches_tracked"]) == 7  # base left as it was
    with pytest.raises(KeyError, match="b.weight"):
        C.merge_state_dicts(base, {"b.weight": torch.ones(2, 3)})
    with pytest.raises(ValueError, match="a.weight"):
        C.merge_state_dicts(base, {"a.weight": torch.ones(3, 2)})


# --------------------------------------------------------------------------
# Lightning checkpoints and the two CLIs
# --------------------------------------------------------------------------

def _save_ckpt(path, model_or_sd, hparams):
    sd = (model_or_sd.state_dict() if isinstance(model_or_sd, nn.Module)
          else model_or_sd)
    torch.save({"state_dict": dict(sd), "hyper_parameters": dict(hparams),
                "epoch": 3}, path)
    return str(path)


def _assert_tree_equal(got, want, path=""):
    """Equal leaves; JAX's converters leave empty dicts where surgery cut
    a head, which a state dict cannot hold."""
    want = {k: v for k, v in want.items() if not (isinstance(v, dict)
                                                   and not v)}
    assert set(got) == set(want), path
    for key in want:
        if isinstance(want[key], dict):
            _assert_tree_equal(got[key], want[key], f"{path}/{key}")
        else:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                          err_msg=f"{path}/{key}")


def _stage2_ckpts(tmp_path):
    """A 2-class Anat_PET_CNN replica saved as a Lightning .ckpt whose
    hparams name its stage-1 checkpoints, and those checkpoints."""
    torch.manual_seed(11)
    ref = _TorchAnatPET({"n_classes": 2}, PET_HP_2, MRI_HP_NOBN).eval()
    _randomize_bn(ref)
    pet = _save_ckpt(tmp_path / "stage1_pet.ckpt",
                     _pet_sequential(PET_HP_2), PET_HP_2)
    mri = _save_ckpt(tmp_path / "stage1_mri.ckpt",
                     _TorchAnatCNN(MRI_HP_NOBN), MRI_HP_NOBN)
    hp = {"n_classes": 2, "lr": 1e-3, "path_pet": pet, "path_mri": mri}
    return ref, _save_ckpt(tmp_path / "ap.ckpt", ref, hp), hp


def test_convert_lightning_checkpoint_resolves_sub_hparams(tmp_path):
    ref, ckpt, hp = _stage2_ckpts(tmp_path)
    got, hparams = C.convert_lightning_checkpoint(ckpt, "anat_pet_fusion")
    assert hparams == hp
    want = C.convert_anat_pet_fusion(_torch_sd(ref), hp, PET_HP_2,
                                     MRI_HP_NOBN)
    _assert_bitwise(got, want)
    jax_vars, jax_hp = jax_reference.convert_lightning_checkpoint(
        ckpt, "anat_pet_fusion")
    assert jax_hp == hparams
    _assert_tree_equal(flax_from_state_dict(got), jax_vars)


def test_convert_lightning_checkpoint_sub_override_and_refusal(tmp_path):
    ref, _, hp = _stage2_ckpts(tmp_path)
    broken = dict(hp, path_pet=str(tmp_path / "moved.ckpt"))
    del broken["path_mri"]
    ckpt = _save_ckpt(tmp_path / "ap2.ckpt", ref, broken)
    with pytest.raises(ValueError, match="path_mri"):
        C.convert_lightning_checkpoint(ckpt, "anat_pet_fusion",
                                       {"pet_hparams": hp["path_pet"]})
    got, _ = C.convert_lightning_checkpoint(
        ckpt, "anat_pet_fusion", {"pet_hparams": hp["path_pet"],
                                  "mri_hparams": hp["path_mri"]})
    _assert_bitwise(got, C.convert_anat_pet_fusion(
        _torch_sd(ref), hp, PET_HP_2, MRI_HP_NOBN))
    with pytest.raises(ValueError, match="path_mri"):  # as JAX refuses
        jax_reference.convert_lightning_checkpoint(
            ckpt, "anat_pet_fusion", {"pet_hparams": hp["path_pet"]})


def test_convert_medicalnet_main_grafts_into_anat_cnn(tmp_path):
    """A DataParallel-style .pth ('module.' prefix, under 'state_dict')
    through ``main``; the checkpoint grafts under an AnatCNN's backbone."""
    ref = _med3d((1, 1, 1, 1), 5)
    pth = tmp_path / "resnet_10_23dataset.pth"
    torch.save({"state_dict": {f"module.{k}": v
                               for k, v in ref.state_dict().items()}}, pth)
    out = tmp_path / "medicalnet"
    convert_medicalnet.main([str(pth), str(out), "--depth", "10"],
                            device="cpu")
    state, hparams, _ = load_checkpoint(out)
    assert hparams == {"resnet_depth": 10, "source": "MedicalNet 23dataset"}
    model = AnatCNN.from_hparams({"n_classes": 3, "resnet_depth": 10})
    model.load_state_dict(graft_params(model.state_dict(),
                                       {"backbone": state}))
    x = np.random.default_rng(6).normal(size=(2, 1) + GRID).astype(
        np.float32)
    with torch.no_grad():
        got = model.eval().backbone(torch.from_numpy(x)).numpy()
        expected = ref(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, expected, **LOGIT_TOL)


def test_convert_reference_main_stage1_and_stage2(tmp_path):
    """Both stage-1 checkpoints and the stage-2 fusion through ``main``,
    the fusion's paths pointed at the converted stage-1 directories; the
    port's loaders (a stage-1 model from its hparams, the stage-2
    ``load_fusion``) take them strictly and give the replicas' logits."""
    torch.manual_seed(12)
    mri_ref = _TorchAnatCNN(MRI_HP_NOBN).eval()
    _randomize_bn(mri_ref)
    mri_ckpt = _save_ckpt(tmp_path / "mri.ckpt", mri_ref, MRI_HP_NOBN)
    pet_seq = _pet_sequential(PET_HP_2).eval()
    _randomize_bn(pet_seq)
    pet_ckpt = _save_ckpt(tmp_path / "pet.ckpt",
                          {f"model.{k}": v for k, v in
                           pet_seq.state_dict().items()}, PET_HP_2)
    dirs = {name: str(tmp_path / name) for name in ("mri", "pet", "ap")}
    C.main([mri_ckpt, dirs["mri"], "--arch", "anat_cnn"], device="cpu")
    C.main([pet_ckpt, dirs["pet"], "--arch", "pet_cnn"], device="cpu")

    batch = _inputs(13, with_tab=False)
    state, hparams, _ = load_checkpoint(dirs["mri"])
    assert hparams == json.loads(json.dumps(MRI_HP_NOBN))
    model = AnatCNN.from_hparams(hparams)
    model.load_state_dict(state)
    with torch.no_grad():
        want = mri_ref(torch.from_numpy(batch["mri"]).unsqueeze(1)).numpy()
    np.testing.assert_allclose(_logits(model, {"mri": batch["mri"]}), want,
                               **LOGIT_TOL)

    ref, ap_ckpt, _ = _stage2_ckpts(tmp_path)
    C.main([ap_ckpt, dirs["ap"], "--arch", "anat_pet_fusion",
            "--path", f"path_pet={dirs['pet']}",
            "--path", f"path_mri={dirs['mri']}"], device="cpu")
    model, state, hparams, _, _ = test_anat_pet_fusion.load_fusion(
        dirs["ap"])
    assert hparams["path_pet"] == dirs["pet"]
    model.load_state_dict(state)
    with torch.no_grad():
        want = ref(torch.from_numpy(batch["pet1451"]).unsqueeze(1),
                   torch.from_numpy(batch["mri"]).unsqueeze(1)).numpy()
    np.testing.assert_allclose(_logits(model, batch), want, **LOGIT_TOL)


def test_convert_reference_main_stage3_loads_shared(tmp_path):
    """The frozen-regime stage-3 chain through ``main``: five reference
    checkpoints and the stage-3 one converted, the paths pointed at the
    port's directories (a TabularMLP checkpoint for ``path_tabular``);
    ``test_all_mod_fusion.load_fusion`` checks the duplicate towers and the
    model gives the replica's logits."""
    hp3 = {"n_classes": 3, "lr": 1e-3}
    ap_hp = {"n_classes": 3, "lr": 1e-3}
    at_hp = {"n_classes": 3, "lr": 1e-3}
    pt_hp = {"n_classes": 3, "simple_dim_red": False, "lr": 1e-3}
    ref = _all_mod_replica(hp3, ap_hp, at_hp, pt_hp, 14, shared=True)
    ckpts = {
        "pet": _save_ckpt(tmp_path / "pet.ckpt", {
            f"model.{k}": v for k, v in
            _pet_sequential(PET_HP_3).state_dict().items()}, PET_HP_3),
        "mri": _save_ckpt(tmp_path / "mri.ckpt", _TorchAnatCNN(MRI_HP),
                          MRI_HP),
        "anat_pet": _save_ckpt(tmp_path / "ap.ckpt", ref.model_anat_pet,
                               ap_hp),
        "anat_tab": _save_ckpt(tmp_path / "at.ckpt", ref.model_anat_tab,
                               at_hp),
        "pet_tab": _save_ckpt(tmp_path / "pt.ckpt", ref.model_pet_tab,
                              pt_hp),
    }
    tab_dir = str(tmp_path / "tab")
    save_checkpoint(tab_dir, TabularMLP.from_hparams(
        {"n_classes": 3}).state_dict(), {"n_classes": 3})
    paths = {f"path_{k}": v for k, v in ckpts.items()}
    all_ckpt = _save_ckpt(tmp_path / "all.ckpt", ref, dict(hp3, **paths))
    port = {k: str(tmp_path / f"port_{k}") for k in ckpts}
    C.main([ckpts["pet"], port["pet"], "--arch", "pet_cnn"], device="cpu")
    C.main([ckpts["mri"], port["mri"], "--arch", "anat_cnn"], device="cpu")
    for key, arch in (("anat_pet", "anat_pet_fusion"),
                      ("anat_tab", "tabular_mri_fusion"),
                      ("pet_tab", "pet_tabular_fusion")):
        C.main([ckpts[key], port[key], "--arch", arch,
                "--sub", f"pet_hparams={ckpts['pet']}",
                "--sub", f"mri_hparams={ckpts['mri']}",
                "--path", f"path_tabular={tab_dir}"], device="cpu")
    out = str(tmp_path / "port_all")
    C.main([all_ckpt, out, "--arch", "all_modalities_fusion",
            "--path", f"path_tabular={tab_dir}"]
           + [f"--path=path_{k}={v}" for k, v in port.items()],
           device="cpu")
    model, state, _, _, _ = test_all_mod_fusion.load_fusion(out)
    assert model.share_towers
    model.load_state_dict(state)
    batch = _inputs(15)
    np.testing.assert_allclose(_logits(model, batch),
                               _all_mod_forward(ref, batch), **LOGIT_TOL)


def test_convert_reference_main_tabpfn(tmp_path):
    """The reference's ``tabular_baseline.pth`` ('model_state_dict' and
    its train F1) through ``main``: the TabPFN transformer loads the
    checkpoint strictly, equal to the layout mapping's output."""
    torch.manual_seed(16)
    ref = TorchTabPFN().eval()
    pth = tmp_path / "tabular_baseline.pth"
    torch.save({"model_state_dict": ref.state_dict(),
                "tabular_baseline_F1": 0.71}, pth)
    out = tmp_path / "tabpfn"
    C.main([str(pth), str(out), "--arch", "tabpfn"], device="cpu")
    state, hparams, _ = load_checkpoint(out)
    assert hparams == {"tabular_baseline_F1": 0.71}
    model = model_from_state_dict(state)
    model.load_state_dict(state)
    _assert_bitwise(state, convert_tabpfn_layout(ref.state_dict()))
