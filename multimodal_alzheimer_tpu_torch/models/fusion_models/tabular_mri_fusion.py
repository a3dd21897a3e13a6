"""Stage-2 MRI+tabular fusion (reference Tabular_MRT_Model parity).

Port of ``multimodal_alzheimer_tpu/models/fusion_models/tabular_mri_fusion.py``
(reference: pkg/models/fusion_models/tabular_mri_fusion.py:11-124):
``reduce_tab`` Linear(1024->512) + ReLU on the tabular ``decoder``
embedding; concat (tabular, MRI) (:76-78); ``stage2out`` Linear(1024->64)
-> ReLU -> ``cls2`` Linear(n_classes); the ``fusion`` tap is the pre-ReLU
``stage2out`` output.

The reference's ``requires_Grad`` typo (:30) means its tabular encoder is
never truly frozen; here freezing is explicit, with the typo's effective
behaviour: the encoder is out of the optimizer unless ``lr_pretrained``.
``freeze_towers``, ``towers`` and ``return_towers`` work as in
``anat_pet_fusion.py``: frozen towers run under ``torch.no_grad()`` in the
fusion's mode, so their BatchNorm statistics update in train mode and no
tower backward runs (with ``fused_bn="full"``, no K6/K7 launch).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_alzheimer_tpu_torch.models.fusion_models.anat_pet_fusion import (
    run_tower,
)
from multimodal_alzheimer_tpu_torch.models.layers import (
    Linear,
    reset_parameters,
)
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp import (
    TabularMLP,
)


class TabularMRIFusion(nn.Module):
    def __init__(self, n_classes: int, mri_model: AnatCNN,
                 tab_model: TabularMLP, freeze_towers: bool = False,
                 dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        """``generator`` draws the head's initial weights (torch's global
        RNG when None); the towers keep theirs."""
        super().__init__()
        self.n_classes = n_classes
        self.freeze_towers = freeze_towers
        self.mri_model = mri_model
        self.tab_model = tab_model
        kw = dict(device=device, compute_dtype=dtype)
        self.reduce_tab = Linear(tab_model.hidden[-1], 512, **kw)
        self.stage2out = Linear(512 + mri_model.feature_width, 64, **kw)
        self.cls2 = Linear(64, n_classes, **kw)
        for head in (self.reduce_tab, self.stage2out, self.cls2):
            reset_parameters(head, generator)

    @classmethod
    def from_hparams(cls, hparams: dict, mri_hparams: dict,
                     tab_hparams: dict, **overrides) -> "TabularMRIFusion":
        """This stage's ``lr_pretrained`` decides the freezing; the MRI
        tower's ``freeze_backbone`` is forced off. ``dtype``, ``device`` and
        ``generator`` go to the towers too."""
        sub = {k: overrides[k] for k in ("dtype", "device", "generator")
               if k in overrides}
        kwargs = dict(
            n_classes=hparams["n_classes"],
            mri_model=AnatCNN.from_hparams(mri_hparams, freeze_backbone=False,
                                           **sub),
            tab_model=TabularMLP.from_hparams(tab_hparams, **sub),
        )
        if "lr_pretrained" in hparams:
            kwargs["freeze_towers"] = not hparams["lr_pretrained"]
        kwargs.update(overrides)
        return cls(**kwargs)

    def forward(self, batch: dict, towers: dict | None = None,
                return_towers: bool = False) -> dict:
        towers = towers or {}
        mri_out = run_tower(self.mri_model, batch, towers.get("mri"),
                            self.freeze_towers)
        tab_out = run_tower(self.tab_model, batch, towers.get("tab"),
                            self.freeze_towers)
        out_tab = F.relu(self.reduce_tab(tab_out["embeddings"]["decoder"]))
        out_mri = mri_out["embeddings"]["backbone_gap"]
        fused = self.stage2out(torch.cat([out_tab, out_mri], dim=1))
        logits = self.cls2(F.relu(fused))
        out = {"logits": logits.to(torch.float32),
               "embeddings": {"fusion": fused}}
        if return_towers:
            out["towers"] = {"mri": mri_out, "tab": tab_out}
        return out

    def fusion_tap(self) -> str:
        return "fusion"
