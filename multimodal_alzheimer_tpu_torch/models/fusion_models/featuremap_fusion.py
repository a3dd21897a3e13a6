"""Intermediate feature-map PET+MRI fusion (reference PET_MRI_FMF parity).

Port of ``multimodal_alzheimer_tpu/models/fusion_models/featuremap_fusion.py``
(reference: pkg/models/fusion_models/anat_pet_featuremapfusion.py:20-172).
Two conv towers of the same recipe, ``backbone_pet`` and ``backbone_mri``,
give 3D feature maps, fused by channel concatenation (PET first) or by the
voxelwise max (``fusion_mode`` 'concatenate' or 'maxout', :116-124); then
``n_layers_fusion`` x (``fusion_conv_{i}`` 'same' -> [``fusion_bn_{i}``] ->
ReLU -> max-pool 2), GAP, [dense dropout], ``hidden`` Linear(64) + ReLU
and ``cls``. ``bn_torch_stats`` reaches the towers' and the fusion's
BatchNorms.

The reference has a latent channel-count bug for ``n_layers_fusion > 1``
(``n_in_fusion *= 2``, :79); only one layer is ever used. The JAX package
chains the channels correctly (each fusion conv after the first reads
``n_out_fusion`` channels), and so does the port: the same model for every
configuration the reference runs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_alzheimer_tpu_torch.models.layers import (
    Conv3d,
    ConvTower3D,
    Dropout,
    Linear,
    batch_norm,
    global_avg_pool,
    max_pool3d,
    reset_parameters,
)

FUSION_MODES = ("concatenate", "maxout")


class PETMRIFeatureMapFusion(nn.Module):
    def __init__(self, n_classes: int, fusion_mode: str = "maxout",
                 conv_out: Sequence[int] = (8, 16, 32),
                 filter_size: Sequence[int] = (5, 5, 3),
                 batchnorm: bool = False,
                 n_layers_fusion: int = 1,
                 n_out_fusion: int = 64,
                 filter_size_fusion: int = 3,
                 batchnorm_fusion: bool = False,
                 bn_torch_stats: bool = False,
                 dropout_conv_p: Optional[float] = None,
                 dropout_dense_p: Optional[float] = None,
                 dtype=torch.float32,
                 device=None,
                 generator: torch.Generator | None = None):
        """``generator`` draws the initial weights (torch's global RNG when
        None); it must live on ``device``."""
        super().__init__()
        if fusion_mode not in FUSION_MODES:
            raise ValueError(f"fusion_mode must be one of {FUSION_MODES}, "
                             f"got {fusion_mode!r}")
        self.n_classes = n_classes
        self.fusion_mode = fusion_mode
        self.n_layers_fusion = n_layers_fusion
        self.dtype = dtype
        tower = (conv_out, filter_size, batchnorm, dropout_conv_p,
                 bn_torch_stats, device, dtype)
        self.backbone_pet = ConvTower3D(1, *tower)
        self.backbone_mri = ConvTower3D(1, *tower)
        width = self.backbone_pet.out_features
        if fusion_mode == "concatenate":
            width *= 2
        for i in range(n_layers_fusion):
            self.add_module(f"fusion_conv_{i}", Conv3d(
                width, n_out_fusion, filter_size_fusion, padding="same",
                device=device, compute_dtype=dtype))
            if batchnorm_fusion:
                self.add_module(f"fusion_bn_{i}", batch_norm(
                    n_out_fusion, "torch_stats" if bn_torch_stats else False,
                    device, dtype))
            width = n_out_fusion
        self.batchnorm_fusion = batchnorm_fusion
        self.dense_dropout = (Dropout(dropout_dense_p)
                              if dropout_dense_p is not None else None)
        self.hidden = Linear(width, 64, device=device, compute_dtype=dtype)
        self.cls = Linear(64, n_classes, device=device, compute_dtype=dtype)
        reset_parameters(self, generator)

    @classmethod
    def from_hparams(cls, hparams: dict,
                     **overrides) -> "PETMRIFeatureMapFusion":
        kwargs = dict(
            n_classes=hparams["n_classes"],
            fusion_mode=hparams["fusion_mode"],
            conv_out=tuple(hparams["conv_out"]),
            filter_size=tuple(hparams["filter_size"]),
            batchnorm=bool(hparams.get("batchnorm", False)),
            n_layers_fusion=int(hparams.get("n_layers_fusion", 1)),
            n_out_fusion=int(hparams.get("n_out_fusion", 64)),
            filter_size_fusion=int(hparams.get("filter_size_fusion", 3)),
            batchnorm_fusion=bool(hparams.get("batchnorm_fusion", False)),
            dropout_conv_p=hparams.get("dropout_conv_p"),
            dropout_dense_p=hparams.get("dropout_dense_p"),
            bn_torch_stats=bool(hparams.get("bn_torch_stats", False)),
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    def forward(self, batch: dict) -> dict:
        out_pet = self.backbone_pet(
            batch["pet1451"].unsqueeze(1).to(self.dtype))
        out_mri = self.backbone_mri(batch["mri"].unsqueeze(1).to(self.dtype))
        if self.fusion_mode == "concatenate":
            fused = torch.cat([out_pet, out_mri], dim=1)
        else:
            fused = torch.maximum(out_pet, out_mri)
        for i in range(self.n_layers_fusion):
            fused = getattr(self, f"fusion_conv_{i}")(fused)
            if self.batchnorm_fusion:
                fused = getattr(self, f"fusion_bn_{i}")(fused)
            fused = max_pool3d(F.relu(fused))
        h = global_avg_pool(fused)
        if self.dense_dropout is not None:
            h = self.dense_dropout(h)
        h = F.relu(self.hidden(h))
        logits = self.cls(h)
        return {"logits": logits.to(torch.float32),
                "embeddings": {"dense": h}}
