"""Stage-2 PET+MRI late fusion (reference Anat_PET_CNN parity).

Port of ``multimodal_alzheimer_tpu/models/fusion_models/anat_pet_fusion.py``
(reference: pkg/models/fusion_models/anat_pet_fusion.py:11-127). The
reference loads stage-1 checkpoints and truncates them (model[:-3]/[:-1]
for PET -> 64-d, conv_seg[:2] for MRI -> 512-d GAP); here the stage-1
models are submodules whose embedding taps are read directly, and the
checkpoints are grafted by submodule prefix (``train/checkpoint.py``
``graft_params``).

Head: ``reduce_dim_mri`` Linear(512->64) + ReLU; concat (PET, MRI);
``stage2out`` Linear(128->64) -> ReLU -> ``cls2`` Linear(n_classes). The
``fusion`` tap is the pre-ReLU ``stage2out`` output (the reference's
``model_fuse[:-2]`` cut, all_modalities_fusion.py:29-31).

``freeze_towers`` is torch's ``requires_grad=False`` (JAX's
``stop_gradient`` at the taps): the towers run under ``torch.no_grad()``,
in the fusion's train or eval mode, so in train mode their BatchNorm
statistics still update while no tower backward runs. The optimizer leaves
them out (``train/driver.py`` ``fusion_optimizer``). ``towers`` supplies
precomputed tower outputs and ``return_towers`` returns them, for a stage-3
parent that runs each tower once. ``dtype`` is the compute dtype of the
towers and the head; the logits are float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_alzheimer_tpu_torch.models.layers import (
    Linear,
    reset_parameters,
)
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
    SmallPETCNN,
)


def _pet_tap(pet_out: dict, n_classes: int) -> torch.Tensor:
    """The reference's 2-class cut is the GAP features, the 3-class one the
    hidden dense output (anat_pet_fusion.py:28-31); GAP where the PET model
    has no hidden Linear."""
    emb = pet_out["embeddings"]
    if n_classes != 2 and "dense" in emb:
        return emb["dense"]
    return emb["gap"]


def _pet_tap_width(pet_model: SmallPETCNN, n_classes: int) -> int:
    if n_classes != 2 and pet_model.hidden is not None:
        return pet_model.hidden.out_features
    return pet_model.convs.out_features


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach()


def run_tower(module: nn.Module, batch: dict, given, frozen: bool) -> dict:
    """A tower's output dict: ``given`` where a parent precomputed it, else
    ``module`` run on ``batch`` (under ``torch.no_grad()`` when
    ``frozen``); detached when ``frozen``."""
    if given is None:
        with torch.no_grad() if frozen else contextlib.nullcontext():
            given = module(batch)
    return _detach(given) if frozen else given


class AnatPETFusion(nn.Module):
    def __init__(self, n_classes: int, pet_model: SmallPETCNN,
                 mri_model: AnatCNN, freeze_towers: bool = False,
                 dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        """``generator`` draws the head's initial weights (torch's global
        RNG when None); the towers keep theirs."""
        super().__init__()
        self.n_classes = n_classes
        self.freeze_towers = freeze_towers
        self.pet_model = pet_model
        self.mri_model = mri_model
        kw = dict(device=device, compute_dtype=dtype)
        self.reduce_dim_mri = Linear(mri_model.feature_width, 64, **kw)
        self.stage2out = Linear(_pet_tap_width(pet_model, n_classes) + 64,
                                64, **kw)
        self.cls2 = Linear(64, n_classes, **kw)
        for head in (self.reduce_dim_mri, self.stage2out, self.cls2):
            reset_parameters(head, generator)

    @classmethod
    def from_hparams(cls, hparams: dict, pet_hparams: dict,
                     mri_hparams: dict, **overrides) -> "AnatPETFusion":
        """Freezing below this fusion is decided by THIS stage's
        ``lr_pretrained`` (reference anat_pet_fusion.py:34-40): the MRI
        tower's own ``freeze_backbone`` is forced off, and control lives
        at this model's taps. ``dtype``, ``device`` and ``generator`` go to
        the towers too."""
        sub = {k: overrides[k] for k in ("dtype", "device", "generator")
               if k in overrides}
        kwargs = dict(
            n_classes=hparams["n_classes"],
            pet_model=SmallPETCNN.from_hparams(pet_hparams, **sub),
            mri_model=AnatCNN.from_hparams(mri_hparams, freeze_backbone=False,
                                           **sub),
        )
        if "lr_pretrained" in hparams:
            kwargs["freeze_towers"] = not hparams["lr_pretrained"]
        kwargs.update(overrides)
        return cls(**kwargs)

    def forward(self, batch: dict, towers: dict | None = None,
                return_towers: bool = False) -> dict:
        towers = towers or {}
        pet_out = run_tower(self.pet_model, batch, towers.get("pet"),
                            self.freeze_towers)
        mri_out = run_tower(self.mri_model, batch, towers.get("mri"),
                            self.freeze_towers)
        out_pet = _pet_tap(pet_out, self.n_classes)
        out_mri = F.relu(self.reduce_dim_mri(
            mri_out["embeddings"]["backbone_gap"]))
        fused = self.stage2out(torch.cat([out_pet, out_mri], dim=1))
        logits = self.cls2(F.relu(fused))
        out = {"logits": logits.to(torch.float32),
               "embeddings": {"fusion": fused}}
        if return_towers:
            out["towers"] = {"pet": pet_out, "mri": mri_out}
        return out

    def fusion_tap(self) -> str:
        return "fusion"
