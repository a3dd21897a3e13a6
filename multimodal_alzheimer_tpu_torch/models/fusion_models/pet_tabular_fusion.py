"""Stage-2 PET+tabular fusion (reference PET_TABULAR_CNN parity).

Port of ``multimodal_alzheimer_tpu/models/fusion_models/pet_tabular_fusion.py``
(reference: pkg/models/fusion_models/pet_tabular_fusion.py:15-149). The
reference's tabular branch is a TabPFN whose 1024-d decoder activations
are hooked out of a CPU forward in every step (:80-97); here it is
``TabularMLP``'s ``decoder`` tap, or TabPFN's through the
'tabular_embedding' batch key.

``reduce_tab`` is Linear(1024->64) + ReLU, or with ``simple_dim_red``
``reduce_tab_0`` Linear(1024->512) + ReLU -> ``reduce_tab_1``
Linear(512->64) + ReLU (:54-57); concat (PET, tabular); ``stage2out``
Linear(128->64) -> ReLU -> ``cls2`` Linear(n_classes); the ``fusion`` tap
is the pre-ReLU ``stage2out`` output. ``freeze_towers``, ``towers`` and
``return_towers`` work as in ``anat_pet_fusion.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_alzheimer_tpu_torch.models.fusion_models.anat_pet_fusion import (
    _pet_tap,
    _pet_tap_width,
    run_tower,
)
from multimodal_alzheimer_tpu_torch.models.layers import (
    Linear,
    reset_parameters,
)
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (
    SmallPETCNN,
)
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp import (
    TabularMLP,
)


class PETTabularFusion(nn.Module):
    def __init__(self, n_classes: int, pet_model: SmallPETCNN,
                 tab_model: TabularMLP, simple_dim_red: bool = False,
                 freeze_towers: bool = False, dtype=torch.float32,
                 device=None, generator: torch.Generator | None = None):
        """``generator`` draws the head's initial weights (torch's global
        RNG when None); the towers keep theirs."""
        super().__init__()
        self.n_classes = n_classes
        self.simple_dim_red = simple_dim_red
        self.freeze_towers = freeze_towers
        self.pet_model = pet_model
        self.tab_model = tab_model
        kw = dict(device=device, compute_dtype=dtype)
        width = tab_model.hidden[-1]
        if simple_dim_red:
            self.reduce_tab_0 = Linear(width, 512, **kw)
            self.reduce_tab_1 = Linear(512, 64, **kw)
            heads = [self.reduce_tab_0, self.reduce_tab_1]
        else:
            self.reduce_tab = Linear(width, 64, **kw)
            heads = [self.reduce_tab]
        self.stage2out = Linear(_pet_tap_width(pet_model, n_classes) + 64,
                                64, **kw)
        self.cls2 = Linear(64, n_classes, **kw)
        for head in heads + [self.stage2out, self.cls2]:
            reset_parameters(head, generator)

    @classmethod
    def from_hparams(cls, hparams: dict, pet_hparams: dict,
                     tab_hparams: dict, **overrides) -> "PETTabularFusion":
        """This stage's ``lr_pretrained`` decides the freezing. ``dtype``,
        ``device`` and ``generator`` go to the towers too."""
        sub = {k: overrides[k] for k in ("dtype", "device", "generator")
               if k in overrides}
        kwargs = dict(
            n_classes=hparams["n_classes"],
            pet_model=SmallPETCNN.from_hparams(pet_hparams, **sub),
            tab_model=TabularMLP.from_hparams(tab_hparams, **sub),
            simple_dim_red=bool(hparams.get("simple_dim_red", False)),
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
        tab_out = run_tower(self.tab_model, batch, towers.get("tab"),
                            self.freeze_towers)
        out_pet = _pet_tap(pet_out, self.n_classes)
        emb_tab = tab_out["embeddings"]["decoder"]
        if self.simple_dim_red:
            out_tab = F.relu(self.reduce_tab_1(F.relu(
                self.reduce_tab_0(emb_tab))))
        else:
            out_tab = F.relu(self.reduce_tab(emb_tab))
        fused = self.stage2out(torch.cat([out_pet, out_tab], dim=1))
        logits = self.cls2(F.relu(fused))
        out = {"logits": logits.to(torch.float32),
               "embeddings": {"fusion": fused}}
        if return_towers:
            out["towers"] = {"pet": pet_out, "tab": tab_out}
        return out

    def fusion_tap(self) -> str:
        return "fusion"
