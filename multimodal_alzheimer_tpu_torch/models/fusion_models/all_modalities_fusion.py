"""Stage-3 all-modalities fusion (reference All_Modalities_Fusion parity).

Port of ``multimodal_alzheimer_tpu/models/fusion_models/
all_modalities_fusion.py`` (reference: pkg/models/fusion_models/
all_modalities_fusion.py:12-137). The three stage-2 fusions are submodules
(``model_anat_pet``, ``model_anat_tab``, ``model_pet_tab``); each one's
64-d pre-ReLU ``fusion`` tap (the reference's ``model_fuse[:-2]`` cut,
:29-31) is concatenated in that order (:74-77) and classified by
``stage3out`` Linear(192->64) -> ReLU -> ``cls3`` Linear(n_classes). The
``fusion`` tap of this model is the pre-ReLU ``stage3out`` output.

``freeze_towers`` is JAX's ``stop_gradient`` at the three stage-2 taps: the
stage-2 forwards run under ``torch.no_grad()`` in this model's train or
eval mode, so their BatchNorm statistics still move in train mode while no
stage-2 (or stage-1) backward runs.

``share_towers`` runs each stage-1 tower once and feeds every consumer,
where the reference runs each of its two private copies (:66-79): PET and
MRI from ``model_anat_pet``, tabular from ``model_anat_tab`` (the
canonical copies), through the stage-2 modules' ``towers=`` /
``return_towers=`` API. It is only legal when all three stage-2 sub-models
freeze their towers, and it leaves the duplicate copies untouched: they
are never read, their BatchNorm statistics never move, and
``train/checkpoint.sync_tower_duplicates`` mirrors the canonical copies
over them when a checkpoint is saved. JAX runs the unshared graph at init
so that every duplicate tower's variables exist; a torch module simply owns
all six towers always.

``towers`` supplies precomputed stage-1 tower outputs (keys 'pet', 'mri',
'tab'), only under ``share_towers``. ``fusion_inputs`` supplies the three
stage-2 taps (keys 'anat_pet', 'anat_tab', 'pet_tab', each (B, 64)) and
skips the sub-models, only under ``freeze_towers``. ``dtype`` is the
compute dtype of the head (the sub-models take theirs from
``from_hparams``); the logits are float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_alzheimer_tpu_torch.models.fusion_models.anat_pet_fusion import (
    AnatPETFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.pet_tabular_fusion import (
    PETTabularFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.tabular_mri_fusion import (
    TabularMRIFusion,
)
from multimodal_alzheimer_tpu_torch.models.layers import (
    Linear,
    reset_parameters,
)

SUB_MODELS = ("model_anat_pet", "model_anat_tab", "model_pet_tab")


class AllModalitiesFusion(nn.Module):
    def __init__(self, n_classes: int, model_anat_pet: AnatPETFusion,
                 model_anat_tab: TabularMRIFusion,
                 model_pet_tab: PETTabularFusion,
                 freeze_towers: bool = False, share_towers: bool = False,
                 dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        """``generator`` draws the head's initial weights (torch's global
        RNG when None); the sub-models keep theirs."""
        super().__init__()
        self.n_classes = n_classes
        self.freeze_towers = freeze_towers
        self.share_towers = share_towers
        self.model_anat_pet = model_anat_pet
        self.model_anat_tab = model_anat_tab
        self.model_pet_tab = model_pet_tab
        width = sum(getattr(self, m).stage2out.out_features
                    for m in SUB_MODELS)
        kw = dict(device=device, compute_dtype=dtype)
        self.stage3out = Linear(width, 64, **kw)
        self.cls3 = Linear(64, n_classes, **kw)
        for head in (self.stage3out, self.cls3):
            reset_parameters(head, generator)

    @classmethod
    def from_hparams(cls, hparams: dict, anat_pet_hparams: dict,
                     anat_tab_hparams: dict, pet_tab_hparams: dict,
                     pet_hparams: dict, mri_hparams: dict,
                     tab_hparams: dict,
                     **overrides) -> "AllModalitiesFusion":
        """Each stage-2 sub-model freezes its stage-1 towers as that
        stage-2 checkpoint's own ``lr_pretrained`` says (the reference's
        load_from_checkpoint re-runs e.g. Anat_PET_CNN.__init__ with the
        stage-2 hparams, anat_pet_fusion.py:34-40), so even an unfrozen
        stage-3 run never updates stage-1 towers unless the stage-2 hparams
        unfroze them. This stage's ``lr_pretrained`` decides
        ``freeze_towers``; ``share_towers`` follows from all three
        sub-models being frozen. An explicit override wins. ``dtype``,
        ``device`` and ``generator`` go to the sub-models too."""
        sub = {k: overrides[k] for k in ("dtype", "device", "generator")
               if k in overrides}
        kwargs = dict(
            n_classes=hparams["n_classes"],
            model_anat_pet=AnatPETFusion.from_hparams(
                anat_pet_hparams, pet_hparams, mri_hparams,
                freeze_towers=not anat_pet_hparams.get("lr_pretrained"),
                **sub),
            model_anat_tab=TabularMRIFusion.from_hparams(
                anat_tab_hparams, mri_hparams, tab_hparams,
                freeze_towers=not anat_tab_hparams.get("lr_pretrained"),
                **sub),
            model_pet_tab=PETTabularFusion.from_hparams(
                pet_tab_hparams, pet_hparams, tab_hparams,
                freeze_towers=not pet_tab_hparams.get("lr_pretrained"),
                **sub),
        )
        if "lr_pretrained" in hparams:
            kwargs["freeze_towers"] = not hparams["lr_pretrained"]
        kwargs["share_towers"] = all(kwargs[m].freeze_towers
                                     for m in SUB_MODELS)
        kwargs.update(overrides)
        return cls(**kwargs)

    def forward(self, batch: dict, towers: dict | None = None,
                fusion_inputs: dict | None = None) -> dict:
        if towers and not self.share_towers:
            raise ValueError("external towers require share_towers=True")
        if fusion_inputs is not None:
            if not self.freeze_towers:
                raise ValueError(
                    "fusion_inputs requires freeze_towers=True (a trainable "
                    "sub-model cannot be computed externally)")
            taps = [fusion_inputs[k] for k in ("anat_pet", "anat_tab",
                                               "pet_tab")]
        else:
            with (torch.no_grad() if self.freeze_towers
                  else contextlib.nullcontext()):
                taps = (self._shared_taps(batch, towers or {})
                        if self.share_towers else
                        [getattr(self, m)(batch)["embeddings"]["fusion"]
                         for m in SUB_MODELS])
        if self.freeze_towers:
            taps = [t.detach() for t in taps]
        fused = self.stage3out(torch.cat(taps, dim=1))
        logits = self.cls3(F.relu(fused))
        return {"logits": logits.to(torch.float32),
                "embeddings": {"fusion": fused}}

    def _shared_taps(self, batch: dict, ext: dict) -> list:
        """The three stage-2 taps with each stage-1 tower run once: PET and
        MRI in ``model_anat_pet``, tabular in ``model_anat_tab``."""
        if not all(getattr(self, m).freeze_towers for m in SUB_MODELS):
            raise ValueError(
                "share_towers=True requires freeze_towers=True on all "
                "three stage-2 sub-models (sharing an unfrozen tower "
                "would merge two independently-trained copies)")
        ap = self.model_anat_pet(
            batch, towers={k: ext[k] for k in ("pet", "mri") if k in ext},
            return_towers=True)
        at_towers = {"mri": ap["towers"]["mri"]}
        if "tab" in ext:
            at_towers["tab"] = ext["tab"]
        at = self.model_anat_tab(batch, towers=at_towers, return_towers=True)
        pt = self.model_pet_tab(batch, towers={"pet": ap["towers"]["pet"],
                                               "tab": at["towers"]["tab"]})
        return [out["embeddings"]["fusion"] for out in (ap, at, pt)]
