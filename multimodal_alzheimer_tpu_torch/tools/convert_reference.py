"""Convert reference (torch/Lightning) checkpoints to the port.

Port of the JAX package's ``tools/convert_reference.py``, function for
function. A Lightning ``.ckpt`` (``{'state_dict', 'hyper_parameters'}``)
converts into a port checkpoint (``train.checkpoint.save_checkpoint``)
with the same hparams, so ``inference/test_*.py``, the fusion grafting and
``tools/export_artifact.py`` consume it.

Supported (all 9 reference model classes):
  * Small_PET_CNN (reference pet_models/pet_cnn.py:14-45)
  * Anat_CNN / PET_CNN_ResNet (Med3D backbone + conv_seg head,
    mri_models/anat_cnn.py:33-79): the backbone through
    ``tools.convert_medicalnet``
  * PET_MRI_EF (early fusion; the Small_PET_CNN recipe,
    early_fusion.py:29-59)
  * PET_MRI_FMF (twin towers + fused tower, anat_pet_featuremapfusion.py)
  * Anat_PET_CNN / Tabular_MRT_Model / PET_TABULAR_CNN /
    All_Modalities_Fusion: the checkpoint-surgery chain
    (anat_pet_fusion.py:16-32, all_modalities_fusion.py:16-31). Fusion
    conversions are partial: the stage-1 classifier weights that surgery
    removed and the TabPFN branch keep the port model's initial values
    (they never reach the fusion logits); ``merge_state_dicts`` overlays
    the converted entries on the model's ``state_dict``. TabPFN decoder
    activations computed offline feed the converted models through the
    'tabular_embedding' batch key.
  * TabPFN (the prior-fitted transformer of ``tabular_baseline.pth``)

Torch to torch: module names change, layouts do not. A converted
stage-3 model that shares its towers (``share_towers``, the frozen regime)
gets its duplicate towers synced to the canonical copies after the merge
(``train.checkpoint.sync_tower_duplicates``), so the stage-3 loader's
``assert_tower_duplicates_equal`` holds.

Usage:
    python -m multimodal_alzheimer_tpu_torch.tools.convert_reference \\
        ckpt.ckpt out_dir --arch pet_cnn

A converted fusion keeps the reference's ``path_*`` hparams, which name
``.ckpt`` files; ``--path path_pet=<port checkpoint dir>`` (repeatable)
points one at the converted sub-checkpoint, as the port's loaders need
(``path_tabular`` too, which the reference's TabPFN branch lacks).
"""

from __future__ import annotations

import argparse
import re
from typing import Dict

import torch

from multimodal_alzheimer_tpu_torch.tools.convert_medicalnet import (
    _BN_LEAVES,
    _tensor,
)
from multimodal_alzheimer_tpu_torch.tools.convert_medicalnet import (
    convert_state_dict as convert_backbone,
)


def _param(out: Dict, dst: str, sd: Dict, src: str,
           leaves=("weight", "bias")) -> None:
    for leaf in leaves:
        out[f"{dst}.{leaf}"] = _tensor(sd[f"{src}.{leaf}"])


def _bn(out: Dict, dst: str, sd: Dict, src: str) -> None:
    _param(out, dst, sd, src, _BN_LEAVES)


def _prefixed(prefix: str, sd: Dict) -> Dict:
    return {prefix + k: v for k, v in sd.items()}


def convert_small_pet_cnn(sd: Dict, hparams: Dict) -> Dict:
    """torch Small_PET_CNN state_dict -> SmallPETCNN (or PETMRIEarlyFusion)
    state dict.

    The reference model is one nn.Sequential under 'model.'; module indices
    are reconstructed from hparams exactly as pet_cnn.py:14-45 builds them.
    """
    conv_out = list(hparams["conv_out"])
    batchnorm = bool(hparams.get("batchnorm", False))
    has_conv_dropout = "dropout_conv_p" in hparams
    linear_out = hparams.get("linear_out") or 0
    has_dense_dropout = "dropout_dense_p" in hparams and linear_out

    out: Dict = {}
    idx = 0
    for i in range(len(conv_out)):
        _param(out, f"convs.block_{i}.conv", sd, f"model.{idx}")
        idx += 1
        if batchnorm:
            _bn(out, f"convs.block_{i}.bn", sd, f"model.{idx}")
            idx += 1
        idx += 2  # ReLU, MaxPool
        if has_conv_dropout:
            idx += 1  # Dropout
    idx += 2  # GAP, Flatten
    if has_dense_dropout:
        idx += 1  # Dropout
    # Presence guards: stage-2 surgery truncates the Sequential
    # (model[:-3] drops hidden+cls, model[:-1] drops cls —
    # anat_pet_fusion.py:28-31) but keeps the original module indices.
    if linear_out and f"model.{idx}.weight" in sd:
        _param(out, "hidden", sd, f"model.{idx}")
    if linear_out:
        idx += 2  # Linear, ReLU
    if f"model.{idx}.weight" in sd:
        _param(out, "cls", sd, f"model.{idx}")
    return out


def convert_anat_cnn(sd: Dict, hparams: Dict) -> Dict:
    """torch Anat_CNN (or PET_CNN_ResNet) state_dict -> AnatCNN (or
    PETResNetCNN) state dict.

    Splits the state_dict into the Med3D backbone ('model.*' minus
    conv_seg) and the conv_seg head, reconstructing head module indices
    from hparams (anat_cnn.py:33-79).
    """
    backbone_sd = {re.sub(r"^model\.", "", k): v for k, v in sd.items()
                   if k.startswith("model.")
                   and not k.startswith("model.conv_seg")}
    head_sd = {re.sub(r"^model\.conv_seg\.", "", k): v
               for k, v in sd.items() if k.startswith("model.conv_seg.")}

    depth = int(hparams["resnet_depth"])
    out = _prefixed("backbone.", convert_backbone(backbone_sd, depth))

    head: Dict = {}
    idx = 0
    if hparams.get("batchnorm_begin"):
        _bn(head, "bn_begin", head_sd, f"{idx}")
        idx += 1
    conv_out = list(hparams.get("conv_out") or ())
    for i in range(len(conv_out)):
        if f"{idx}.weight" not in head_sd:
            break  # conv_seg[:2] surgery dropped the conv stack
        _param(head, f"conv_{i}", head_sd, f"{idx}")
        idx += 1
        if hparams.get("batchnorm_conv"):
            _bn(head, f"bn_conv_{i}", head_sd, f"{idx}")
            idx += 1
        idx += 2  # ReLU, MaxPool
    idx += 2  # GAP, Flatten
    linear_out = list(hparams.get("linear_out") or ())
    for i in range(len(linear_out)):
        if f"{idx}.weight" not in head_sd:
            break  # conv_seg[:2] surgery dropped the dense stack
        _param(head, f"dense_{i}", head_sd, f"{idx}")
        idx += 1
        if hparams.get("batchnorm_dense"):
            _bn(head, f"bn_dense_{i}", head_sd, f"{idx}")
            idx += 1
        idx += 1  # ReLU
    if f"{idx}.weight" in head_sd:
        _param(head, "cls", head_sd, f"{idx}")
    out.update(_prefixed("head.", head))
    return out


def _sub_sd(sd: Dict, prefix: str, new_prefix: str = "model.") -> Dict:
    """Extract a submodule's state_dict, re-prefixed for the converters.

    torch ``nn.Sequential`` slicing preserves the original module indices,
    so truncated stage-1 towers inside fusion checkpoints keep the index
    layout the stage-1 converters reconstruct from hparams.
    """
    return {new_prefix + k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


def _dense(out: Dict, dst: str, sd: Dict, key: str, alt: str = None) -> None:
    """One torch Linear, with an alternate key (the fusion heads register
    stage2out/cls2 both as attributes and inside the shared model_fuse
    Sequential)."""
    if f"{key}.weight" not in sd and alt is not None:
        key = alt
    _param(out, dst, sd, key)


def merge_state_dicts(base: Dict, partial: Dict) -> Dict:
    """Overlay converted (possibly partial) entries onto a model's
    ``state_dict`` (JAX's ``merge_variables`` over ``model.init``).

    Strict: every converted entry must name an entry of ``base`` with its
    shape. Entries the conversion leaves out keep ``base``'s values, and
    every ``num_batches_tracked`` is 0, as ``models/convert.py`` sets it.
    """
    out = dict(base)
    for key, value in partial.items():
        if key not in base:
            raise KeyError(f"converted entry {key!r} is not in the model")
        if tuple(value.shape) != tuple(base[key].shape):
            raise ValueError(f"{key}: converted shape {tuple(value.shape)} "
                             f"does not fit {tuple(base[key].shape)}")
        out[key] = value
    for key, value in out.items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros_like(value)
    return out


def convert_anat_pet_fusion(sd: Dict, hparams: Dict, pet_hparams: Dict,
                            mri_hparams: Dict) -> Dict:
    """torch Anat_PET_CNN state_dict -> AnatPETFusion (partial) state dict.

    Reference: fusion_models/anat_pet_fusion.py:16-51 — truncated stage-1
    towers under 'model_pet.'/'model_mri.', reduce_dim_mri Sequential
    (Linear at index 0), fuse head stage2out/cls2.
    """
    out = _prefixed("pet_model.", convert_small_pet_cnn(
        _sub_sd(sd, "model_pet."), pet_hparams))
    out.update(_prefixed("mri_model.", convert_anat_cnn(
        _sub_sd(sd, "model_mri.model.", "model."), mri_hparams)))
    _dense(out, "reduce_dim_mri", sd, "reduce_dim_mri.0")
    _dense(out, "stage2out", sd, "stage2out", "model_fuse.0")
    if "cls2.weight" in sd or "model_fuse.2.weight" in sd:
        _dense(out, "cls2", sd, "cls2", "model_fuse.2")
    return out


def convert_tabular_mri_fusion(sd: Dict, hparams: Dict,
                               mri_hparams: Dict) -> Dict:
    """torch Tabular_MRT_Model -> TabularMRIFusion (partial) state dict.

    Reference: fusion_models/tabular_mri_fusion.py:12-48. The TabPFN
    branch has no converted weights — feed offline TabPFN decoder
    activations via the 'tabular_embedding' batch key for logit parity.
    """
    out = _prefixed("mri_model.", convert_anat_cnn(
        _sub_sd(sd, "model_mri.model.", "model."), mri_hparams))
    _dense(out, "reduce_tab", sd, "reduce_tab.0")
    _dense(out, "stage2out", sd, "stage2out", "model_fuse.0")
    if "cls2.weight" in sd or "model_fuse.2.weight" in sd:
        _dense(out, "cls2", sd, "cls2", "model_fuse.2")
    return out


def convert_pet_tabular_fusion(sd: Dict, hparams: Dict,
                               pet_hparams: Dict) -> Dict:
    """torch PET_TABULAR_CNN -> PETTabularFusion (partial) state dict.

    Reference: fusion_models/pet_tabular_fusion.py:17-61; reduce_tab is
    Linear(1024->512)+ReLU+Linear(512->64)+ReLU when ``simple_dim_red``
    (indices 0, 2), else Linear(1024->64)+ReLU (index 0).
    """
    out = _prefixed("pet_model.", convert_small_pet_cnn(
        _sub_sd(sd, "model_pet."), pet_hparams))
    _dense(out, "stage2out", sd, "stage2out", "model_fuse.0")
    if hparams.get("simple_dim_red"):
        _dense(out, "reduce_tab_0", sd, "reduce_tab.0")
        _dense(out, "reduce_tab_1", sd, "reduce_tab.2")
    else:
        _dense(out, "reduce_tab", sd, "reduce_tab.0")
    if "cls2.weight" in sd or "model_fuse.2.weight" in sd:
        _dense(out, "cls2", sd, "cls2", "model_fuse.2")
    return out


def convert_all_modalities_fusion(sd: Dict, hparams: Dict,
                                  anat_pet_hparams: Dict,
                                  anat_tab_hparams: Dict,
                                  pet_tab_hparams: Dict,
                                  pet_hparams: Dict,
                                  mri_hparams: Dict) -> Dict:
    """torch All_Modalities_Fusion -> AllModalitiesFusion (partial).

    Reference: fusion_models/all_modalities_fusion.py:16-57 — the three
    stage-2 submodels (their model_fuse cut to the pre-ReLU 64-d tap,
    :29-31) plus the stage-3 head stage3out/cls3.
    """
    out = _prefixed("model_anat_pet.", convert_anat_pet_fusion(
        _sub_sd(sd, "model_anat_pet.", ""), anat_pet_hparams, pet_hparams,
        mri_hparams))
    out.update(_prefixed("model_anat_tab.", convert_tabular_mri_fusion(
        _sub_sd(sd, "model_anat_tab.", ""), anat_tab_hparams, mri_hparams)))
    out.update(_prefixed("model_pet_tab.", convert_pet_tabular_fusion(
        _sub_sd(sd, "model_pet_tab.", ""), pet_tab_hparams, pet_hparams)))
    _dense(out, "stage3out", sd, "stage3out", "model_fuse.0")
    _dense(out, "cls3", sd, "cls3", "model_fuse.2")
    return out


def convert_featuremap_fusion(sd: Dict, hparams: Dict) -> Dict:
    """torch PET_MRI_FMF -> PETMRIFeatureMapFusion state dict.

    Reference: fusion_models/anat_pet_featuremapfusion.py:34-93 — twin
    conv towers 'backbone_pet.'/'backbone_mri.' and the fused tower
    'fuse_model.' (n_layers_fusion conv blocks + GAP + Dense(64) + cls).
    """
    batchnorm = bool(hparams.get("batchnorm", False))
    has_conv_dropout = "dropout_conv_p" in hparams
    out: Dict = {}

    for tower in ("backbone_pet", "backbone_mri"):
        idx = 0
        for i in range(len(hparams["conv_out"])):
            _param(out, f"{tower}.block_{i}.conv", sd, f"{tower}.{idx}")
            idx += 1
            if batchnorm:
                _bn(out, f"{tower}.block_{i}.bn", sd, f"{tower}.{idx}")
                idx += 1
            idx += 2  # ReLU, MaxPool
            if has_conv_dropout:
                idx += 1

    idx = 0
    for i in range(int(hparams.get("n_layers_fusion", 1))):
        _param(out, f"fusion_conv_{i}", sd, f"fuse_model.{idx}")
        idx += 1
        if hparams.get("batchnorm_fusion"):
            _bn(out, f"fusion_bn_{i}", sd, f"fuse_model.{idx}")
            idx += 1
        idx += 2  # ReLU, MaxPool
    idx += 2  # GAP, Flatten
    if "dropout_dense_p" in hparams:
        idx += 1
    _dense(out, "hidden", sd, f"fuse_model.{idx}")
    idx += 2  # Linear, ReLU
    _dense(out, "cls", sd, f"fuse_model.{idx}")
    return out


def convert_tabpfn(sd: Dict, hparams: Dict) -> Dict:
    """tabular_baseline.pth (reference dl_approach.py:44) -> the port's
    TabPFNTransformer state dict.

    The reference saves ``classifier.model[2].state_dict()`` — the
    prior-fitted transformer itself — so this is a pure layout mapping
    (``models/tabular_models/tabpfn.py``'s ``convert_state_dict``).
    """
    del hparams
    from multimodal_alzheimer_tpu_torch.models.tabular_models.tabpfn import (
        convert_state_dict,
    )

    return convert_state_dict(sd)


CONVERTERS = {
    "pet_cnn": convert_small_pet_cnn,
    "tabpfn": convert_tabpfn,
    "anat_cnn": convert_anat_cnn,
    "pet_resnet_cnn": convert_anat_cnn,
    "early_fusion": convert_small_pet_cnn,  # PET_MRI_EF shares the recipe
    "featuremap_fusion": convert_featuremap_fusion,
    # Fusion stages need stage-1 hparams too -- see
    # convert_lightning_checkpoint below.
    "anat_pet_fusion": convert_anat_pet_fusion,
    "tabular_mri_fusion": convert_tabular_mri_fusion,
    "pet_tabular_fusion": convert_pet_tabular_fusion,
    "all_modalities_fusion": convert_all_modalities_fusion,
}

# Converters whose extra positional args are stage-1/2 hparam dicts.
FUSION_EXTRA_HPARAMS = {
    "anat_pet_fusion": ("pet_hparams", "mri_hparams"),
    "tabular_mri_fusion": ("mri_hparams",),
    "pet_tabular_fusion": ("pet_hparams",),
    "all_modalities_fusion": ("anat_pet_hparams", "anat_tab_hparams",
                              "pet_tab_hparams", "pet_hparams",
                              "mri_hparams"),
}


def _load_ckpt(ckpt_path: str) -> tuple:
    # weights_only=False: a Lightning save carries a hyper_parameters dict
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    # Lightning .ckpt carries 'state_dict'; the TabPFN artifact
    # (dl_approach.py:44) carries 'model_state_dict' + its train F1.
    raw = ckpt.get("state_dict", ckpt.get("model_state_dict", ckpt))
    sd = {k: v for k, v in raw.items() if isinstance(v, torch.Tensor)}
    hparams = dict(ckpt.get("hyper_parameters", {}))
    if "tabular_baseline_F1" in ckpt:
        hparams["tabular_baseline_F1"] = float(ckpt["tabular_baseline_F1"])
    return sd, hparams


# How each fusion arch's extra hparams resolve to checkpoint paths inside
# the fusion checkpoint's own hyper_parameters (the reference embeds them:
# anat_pet_fusion.py:20-23, all_modalities_fusion.py:17-26).
_HPARAM_PATH_KEYS = {
    "pet_hparams": "path_pet",
    "mri_hparams": "path_mri",
    "anat_pet_hparams": "path_anat_pet",
    "anat_tab_hparams": "path_anat_tab",
    "pet_tab_hparams": "path_pet_tab",
}


def _extra_hparams(arch: str, hparams: Dict, sub_ckpts: Dict = None) -> list:
    """The nested stage-1/2 hparams a fusion arch's converter takes, read
    from the checkpoints its hparams name, ``sub_ckpts`` taking
    precedence."""
    extras = []
    for name in FUSION_EXTRA_HPARAMS.get(arch, ()):
        override = (sub_ckpts or {}).get(name)
        path = override or hparams.get(_HPARAM_PATH_KEYS[name])
        if path is None:
            raise ValueError(
                f"{arch} conversion needs {name}: pass --sub "
                f"{name}=<stage ckpt> or ensure the fusion checkpoint's "
                f"hparams contain {_HPARAM_PATH_KEYS[name]}")
        extras.append(_load_ckpt(str(path))[1])
    return extras


def convert_lightning_checkpoint(ckpt_path: str, arch: str,
                                 sub_ckpts: Dict = None) -> tuple:
    """Load a Lightning .ckpt and convert: returns (state dict, hparams).

    For fusion archs the converter needs the nested stage-1/2 hparams to
    reconstruct truncated-tower module indices; they are read from the
    checkpoints named in the fusion hparams (path_pet/path_mri/...), with
    ``sub_ckpts`` (e.g. {'pet_hparams': 'pet.ckpt'}) taking precedence.
    """
    sd, hparams = _load_ckpt(ckpt_path)
    extras = _extra_hparams(arch, hparams, sub_ckpts)
    return CONVERTERS[arch](sd, hparams, *extras), hparams


def build_model(arch: str, hparams: Dict, extras=(), tab_hparams=None,
                partial: Dict = None, device=None) -> torch.nn.Module:
    """The port model a converted ``arch`` checkpoint loads into.
    ``tab_hparams`` builds the tabular tower of the tabular fusions
    (``TabularMLP``, whose 1024-d ``decoder`` tap the reference's TabPFN
    embedding replaces; by default its published widths); TabPFN's widths
    come from the converted ``partial`` itself."""
    from multimodal_alzheimer_tpu_torch.models.fusion_models.all_modalities_fusion import (  # noqa: E501
        AllModalitiesFusion,
    )
    from multimodal_alzheimer_tpu_torch.models.fusion_models.anat_pet_fusion import (  # noqa: E501
        AnatPETFusion,
    )
    from multimodal_alzheimer_tpu_torch.models.fusion_models.early_fusion import (  # noqa: E501
        PETMRIEarlyFusion,
    )
    from multimodal_alzheimer_tpu_torch.models.fusion_models.featuremap_fusion import (  # noqa: E501
        PETMRIFeatureMapFusion,
    )
    from multimodal_alzheimer_tpu_torch.models.fusion_models.pet_tabular_fusion import (  # noqa: E501
        PETTabularFusion,
    )
    from multimodal_alzheimer_tpu_torch.models.fusion_models.tabular_mri_fusion import (  # noqa: E501
        TabularMRIFusion,
    )
    from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import (
        AnatCNN,
    )
    from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
        SmallPETCNN,
    )
    from multimodal_alzheimer_tpu_torch.models.pet_models.pet_resnet_cnn import (  # noqa: E501
        PETResNetCNN,
    )
    from multimodal_alzheimer_tpu_torch.models.tabular_models.tabpfn import (
        model_from_state_dict,
    )

    if arch == "tabpfn":
        return model_from_state_dict(partial).to(device)
    tab = tab_hparams or {"n_classes": hparams["n_classes"]}
    kw = {"device": device}
    builders = {
        "pet_cnn": lambda: SmallPETCNN.from_hparams(hparams, **kw),
        "anat_cnn": lambda: AnatCNN.from_hparams(hparams, **kw),
        "pet_resnet_cnn": lambda: PETResNetCNN.from_hparams(hparams, **kw),
        "early_fusion": lambda: PETMRIEarlyFusion.from_hparams(hparams,
                                                               **kw),
        "featuremap_fusion": lambda: PETMRIFeatureMapFusion.from_hparams(
            hparams, **kw),
        "anat_pet_fusion": lambda: AnatPETFusion.from_hparams(
            hparams, *extras, **kw),
        "tabular_mri_fusion": lambda: TabularMRIFusion.from_hparams(
            hparams, *extras, tab, **kw),
        "pet_tabular_fusion": lambda: PETTabularFusion.from_hparams(
            hparams, *extras, tab, **kw),
        "all_modalities_fusion": lambda: AllModalitiesFusion.from_hparams(
            hparams, *extras, tab, **kw),
    }
    return builders[arch]()


def port_state_dict(model: torch.nn.Module, partial: Dict) -> Dict:
    """``partial`` merged over ``model``'s ``state_dict``; a stage-3 model
    that shares its towers gets its duplicates synced to the canonical
    copies (its unconverted tabular towers differ at init otherwise)."""
    from multimodal_alzheimer_tpu_torch.train.checkpoint import (
        sync_tower_duplicates,
    )

    state = merge_state_dicts(model.state_dict(), partial)
    if getattr(model, "share_towers", False):
        state = sync_tower_duplicates(state)
    return state


def main(argv=None, device="cuda"):
    """Convert a reference checkpoint, load it strictly into the port model
    built on ``device`` (the card unless the caller asks for the CPU), and
    save it as a port checkpoint."""
    parser = argparse.ArgumentParser()
    parser.add_argument("ckpt")
    parser.add_argument("out_dir")
    parser.add_argument("--arch", required=True, choices=sorted(CONVERTERS))
    parser.add_argument("--sub", action="append", default=[],
                        metavar="NAME=CKPT",
                        help="stage-1/2 checkpoint override, e.g. "
                             "pet_hparams=best_pet.ckpt")
    parser.add_argument("--path", action="append", default=[],
                        metavar="KEY=DIR",
                        help="set hparams KEY (path_pet, path_mri, "
                             "path_tabular, ...) of the written checkpoint "
                             "to a port checkpoint directory; a "
                             "path_tabular directory's hparams also build "
                             "the tabular tower")
    args = parser.parse_args(argv)

    from multimodal_alzheimer_tpu_torch.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from multimodal_alzheimer_tpu_torch.utils.device import resolve_device

    sub_ckpts = dict(s.split("=", 1) for s in args.sub)
    paths = dict(p.split("=", 1) for p in args.path)
    partial, hparams = convert_lightning_checkpoint(args.ckpt, args.arch,
                                                    sub_ckpts)
    extras = _extra_hparams(args.arch, hparams, sub_ckpts)
    tab_hparams = (load_checkpoint(paths["path_tabular"])[1]
                   if "path_tabular" in paths else None)
    model = build_model(args.arch, hparams, extras, tab_hparams, partial,
                        device=resolve_device(device))
    model.load_state_dict(port_state_dict(model, partial))
    save_checkpoint(args.out_dir, model.state_dict(),
                    dict(hparams, **paths))
    print(f"wrote {args.out_dir}")


if __name__ == "__main__":
    main()
