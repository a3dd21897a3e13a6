"""Configurable classifier head over a 3D feature map (conv_seg parity).

Port of ``multimodal_alzheimer_tpu/models/heads.py``:
[BN3d?] -> (Conv3d -> [BN3d] -> ReLU -> MaxPool(2))* -> GAP ->
(Linear -> [BN1d] -> ReLU)* -> Linear(n_classes) -> [ReLU].

``trailing_relu`` (default on) reproduces the reference's ReLU on the logits
(anat_cnn.py:77). ``embeddings['backbone_gap']`` is the (optionally BN'd)
GAP feature taken before the conv ladder, the fusion stages' input.
The head's BatchNorms are flax's, or torch's running statistics with
``bn_torch_stats``; never the fused kernels, as in JAX. ``dtype`` is the
compute dtype: convolutions, dense layers and BatchNorms compute in it, the
``backbone_gap`` tap stays in it, and the logits are cast to float32 last
(JAX ``heads.py:74``).

Under a 3-D mesh (``parallel/tp.py``) the head's layers shard as the
backbone's do; the 'same' depth padding of a head conv comes from the
neighbours' planes, the ``backbone_gap`` tap is gathered over the model
ranks for the outputs, and the trailing ReLU acts on the logits after the
model-axis sum.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_alzheimer_tpu_torch.models.layers import (
    Conv3d,
    Linear,
    batch_norm,
    global_avg_pool,
    max_pool3d,
)
from multimodal_alzheimer_tpu_torch.parallel import tp as sharding


def _same_padding(kernel: int) -> tuple[int, ...]:
    """F.pad widths for flax ``padding='SAME'`` at stride 1: lo = (k-1)//2,
    hi = k//2 on each of W, H, D (asymmetric for even k)."""
    return ((kernel - 1) // 2, kernel // 2) * 3


class ClassifierHead3D(nn.Module):
    def __init__(self, in_features: int, n_classes: int,
                 conv_out: Sequence[int] = (),
                 filter_size: Sequence[int] = (),
                 linear_out: Sequence[int] = (),
                 batchnorm_begin: bool = False,
                 batchnorm_conv: bool = False,
                 batchnorm_dense: bool = False,
                 trailing_relu: bool = True,
                 bn_torch_stats: bool = False,
                 device=None,
                 dtype=torch.float32):
        super().__init__()
        self.in_features = in_features
        self.trailing_relu = trailing_relu
        bn_kind = "torch_stats" if bn_torch_stats else False
        self.bn_begin = (batch_norm(in_features, bn_kind, device, dtype)
                         if batchnorm_begin else None)
        self.convs = []  # (conv name, bn name or None, kernel)
        width = in_features
        for i, (features, kernel) in enumerate(zip(conv_out, filter_size)):
            self.add_module(f"conv_{i}", Conv3d(width, features, kernel,
                                                device=device,
                                                compute_dtype=dtype))
            bn = None
            if batchnorm_conv:
                bn = f"bn_conv_{i}"
                self.add_module(bn, batch_norm(features, bn_kind, device,
                                               dtype))
            self.convs.append((f"conv_{i}", bn, kernel))
            width = features
        self.denses = []  # (dense name, bn name or None)
        for i, features in enumerate(linear_out):
            self.add_module(f"dense_{i}", Linear(width, features,
                                                 device=device,
                                                 compute_dtype=dtype))
            bn = None
            if batchnorm_dense:
                bn = f"bn_dense_{i}"
                self.add_module(bn, batch_norm(features, bn_kind, device,
                                               dtype))
            self.denses.append((f"dense_{i}", bn))
            width = features
        self.cls = Linear(width, n_classes, device=device,
                          compute_dtype=dtype)

    def forward(self, fmap: torch.Tensor) -> dict:
        x = fmap
        if self.bn_begin is not None:
            x = self.bn_begin(x)
        tap = global_avg_pool(x)
        depth_sharded = sharding.spatial() is not None
        for conv, bn, kernel in self.convs:
            pads = _same_padding(kernel)
            if depth_sharded:
                x = getattr(self, conv)(F.pad(x, pads[:4]),
                                        depth_pad=pads[4:])
            else:
                x = getattr(self, conv)(F.pad(x, pads))
            if bn is not None:
                x = getattr(self, bn)(x)
            x = max_pool3d(F.relu(x))
        h = global_avg_pool(x)
        for dense, bn in self.denses:
            h = getattr(self, dense)(h)
            if bn is not None:
                h = getattr(self, bn)(h)
            h = F.relu(h)
        logits = self.cls(h)
        if self.trailing_relu:
            logits = F.relu(logits)
        tp = sharding.active()
        if tp is not None:
            tap = sharding.channels(tap, self.in_features, "replicated", tp)
        return {"logits": logits.to(torch.float32),
                "embeddings": {"backbone_gap": tap}}

    @staticmethod
    def kwargs_from_hparams(hparams: dict) -> dict:
        return dict(
            n_classes=hparams["n_classes"],
            conv_out=tuple(hparams.get("conv_out") or ()),
            filter_size=tuple(hparams.get("filter_size") or ()),
            linear_out=tuple(hparams.get("linear_out") or ()),
            batchnorm_begin=bool(hparams.get("batchnorm_begin", False)),
            batchnorm_conv=bool(hparams.get("batchnorm_conv", False)),
            batchnorm_dense=bool(hparams.get("batchnorm_dense", False)),
            bn_torch_stats=bool(hparams.get("bn_torch_stats", False)),
        )
