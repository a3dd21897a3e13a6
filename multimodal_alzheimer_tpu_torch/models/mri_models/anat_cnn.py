"""MRI classifier: Med3D ResNet backbone + configurable head (Anat_CNN).

Port of ``multimodal_alzheimer_tpu/models/mri_models/anat_cnn.py``
(reference: pkg/models/mri_models/anat_cnn.py:13-136). Consumes batch key
'mri' of shape (B, D, H, W), the JAX package's public layout, and returns
``{'logits', 'embeddings': {'backbone_gap'}}``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from multimodal_alzheimer_tpu_torch.models.heads import ClassifierHead3D
from multimodal_alzheimer_tpu_torch.models.layers import reset_parameters
from multimodal_alzheimer_tpu_torch.models.resnet3d import (
    FEATURE_WIDTH,
    MedicalNetResNet3D,
)


class AnatCNN(nn.Module):
    def __init__(self, n_classes: int, resnet_depth: int = 18,
                 conv_out: Sequence[int] = (),
                 filter_size: Sequence[int] = (),
                 linear_out: Sequence[int] = (),
                 batchnorm_begin: bool = False,
                 batchnorm_conv: bool = False,
                 batchnorm_dense: bool = False,
                 trailing_relu: bool = True,
                 freeze_backbone: bool = False,
                 dilated: bool = True,
                 fused_bn=False,
                 bn_torch_stats: bool = False,
                 maxpool_impl: str = "xla",
                 input_key: str = "mri",
                 dtype=torch.float32,
                 remat: bool = False,
                 device=None,
                 generator: torch.Generator | None = None):
        """``generator`` draws the initial weights (torch's global RNG when
        None); it must live on ``device``. ``dtype`` is the compute dtype
        (JAX's ``dtype``): the input is cast to it and every layer computes
        in it, while parameters and BatchNorm statistics stay float32 and
        the logits return as float32; ``torch.bfloat16`` runs the JAX
        package's bf16 configuration. ``remat`` recomputes the residual
        blocks' activations in the backward pass. ``fused_bn`` picks the backbone's
        BatchNorm (``models.layers.batch_norm``); ``bn_torch_stats`` gives
        backbone and head torch's running statistics and overrides it.
        ``maxpool_impl`` picks the stem pool's backward (``"xla"``, ``"sf"``
        or ``"wf"``; ``models.resnet3d.MedicalNetResNet3D``).
        ``freeze_backbone`` cuts the gradient below the head, so a frozen
        backbone runs no backward; its BatchNorm statistics still update in
        train mode."""
        super().__init__()
        if resnet_depth not in FEATURE_WIDTH:
            raise ValueError(
                "hparams['resnet_depth'] is not in [10, 18, 34, 50]")
        self.n_classes = n_classes
        self.feature_width = FEATURE_WIDTH[resnet_depth]  # backbone_gap's
        self.freeze_backbone = freeze_backbone
        self.input_key = input_key
        self.dtype = dtype
        self.backbone = MedicalNetResNet3D(
            resnet_depth, dilated, device=device,
            fused_bn="torch_stats" if bn_torch_stats else fused_bn,
            maxpool_impl=maxpool_impl, dtype=dtype, remat=remat)
        self.head = ClassifierHead3D(
            FEATURE_WIDTH[resnet_depth], n_classes, conv_out, filter_size,
            linear_out, batchnorm_begin, batchnorm_conv, batchnorm_dense,
            trailing_relu, bn_torch_stats, device=device, dtype=dtype)
        reset_parameters(self, generator)

    @classmethod
    def from_hparams(cls, hparams: dict, **overrides) -> "AnatCNN":
        kwargs = ClassifierHead3D.kwargs_from_hparams(hparams)
        kwargs["resnet_depth"] = hparams.get("resnet_depth", 18)
        # The reference freezes the backbone when ``lr_pretrained`` is None
        # (anat_cnn.py:111-126); derived only when the key is present.
        if "lr_pretrained" in hparams:
            kwargs["freeze_backbone"] = not hparams["lr_pretrained"]
        kwargs.update(overrides)
        return cls(**kwargs)

    def forward(self, batch: dict) -> dict:
        x = batch[self.input_key]
        if x.ndim == 4:
            x = x.unsqueeze(1)  # (B, D, H, W) -> NCDHW
        fmap = self.backbone(x.to(self.dtype))
        if self.freeze_backbone:
            # torch's requires_grad=False in the reference; JAX's
            # stop_gradient: no backbone dgrad or wgrad work is done.
            fmap = fmap.detach()
        return self.head(fmap)
