"""Input-level PET+MRI early fusion (reference PET_MRI_EF parity).

Port of ``multimodal_alzheimer_tpu/models/fusion_models/early_fusion.py``
(reference: pkg/models/fusion_models/early_fusion.py:19-118). The PET and
MRI volumes are stacked as a 2-channel input, PET first (reference
general_step:89, ``torch.stack((pet, mri), dim=1)``), into the same
conv/dense recipe as ``SmallPETCNN``: ``convs`` (a ``ConvTower3D`` of two
input channels) -> GAP -> [dense dropout -> ``hidden`` Linear -> ReLU] ->
``cls``.

Embedding taps as in JAX: ``gap`` (after the dense dropout, which runs only
when there is a hidden Linear) and, with ``linear_out``, ``dense``.
Submodule names follow the flax tree, so ``models/convert.py`` maps weights
by name. ``dtype`` is the compute dtype: f32 parameters, the input cast to
``dtype``, f32 logits.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_alzheimer_tpu_torch.models.layers import (
    ConvTower3D,
    Dropout,
    Linear,
    global_avg_pool,
    reset_parameters,
)


class PETMRIEarlyFusion(nn.Module):
    def __init__(self, n_classes: int,
                 conv_out: Sequence[int] = (8, 16, 32, 64),
                 filter_size: Sequence[int] = (5, 5, 3, 3),
                 batchnorm: bool = False,
                 linear_out: int = 64,
                 dropout_conv_p: Optional[float] = None,
                 dropout_dense_p: Optional[float] = None,
                 dtype=torch.float32,
                 device=None,
                 generator: torch.Generator | None = None):
        """``linear_out`` 0 (or falsy) leaves out the hidden Linear and the
        dense dropout. ``generator`` draws the initial weights (torch's
        global RNG when None); it must live on ``device``."""
        super().__init__()
        self.n_classes = n_classes
        self.dtype = dtype
        self.convs = ConvTower3D(2, conv_out, filter_size, batchnorm,
                                 dropout_conv_p, False, device, dtype)
        width = self.convs.out_features
        self.dense_dropout = self.hidden = None
        if linear_out:
            if dropout_dense_p is not None:
                self.dense_dropout = Dropout(dropout_dense_p)
            self.hidden = Linear(width, linear_out, device=device,
                                 compute_dtype=dtype)
            width = linear_out
        self.cls = Linear(width, n_classes, device=device,
                          compute_dtype=dtype)
        reset_parameters(self, generator)

    @classmethod
    def from_hparams(cls, hparams: dict, **overrides) -> "PETMRIEarlyFusion":
        kwargs = dict(
            n_classes=hparams["n_classes"],
            conv_out=tuple(hparams["conv_out"]),
            filter_size=tuple(hparams["filter_size"]),
            batchnorm=bool(hparams.get("batchnorm", False)),
            linear_out=int(hparams.get("linear_out") or 0),
            dropout_conv_p=hparams.get("dropout_conv_p"),
            dropout_dense_p=hparams.get("dropout_dense_p"),
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    def forward(self, batch: dict) -> dict:
        x = torch.stack([batch["pet1451"], batch["mri"]], dim=1)
        h = global_avg_pool(self.convs(x.to(self.dtype)))
        if self.dense_dropout is not None:
            h = self.dense_dropout(h)
        embeddings = {"gap": h}
        if self.hidden is not None:
            h = F.relu(self.hidden(h))
            embeddings["dense"] = h
        logits = self.cls(h)
        return {"logits": logits.to(torch.float32), "embeddings": embeddings}
