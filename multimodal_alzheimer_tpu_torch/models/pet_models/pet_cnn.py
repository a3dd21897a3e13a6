"""Small configurable 3D PET CNN (reference Small_PET_CNN parity).

Port of ``multimodal_alzheimer_tpu/models/pet_models/pet_cnn.py``
(reference: pkg/models/pet_models/pet_cnn.py:14-45):
n x (Conv3d 'same' -> [BN3d] -> ReLU -> MaxPool3d(2) -> [Dropout]) ->
GAP -> [Dropout -> Linear -> ReLU] -> Linear(n_classes).

Embedding taps, as in JAX: ``embeddings['gap']`` is the post-GAP feature
(after the dense dropout, which the reference's truncated Sequential keeps),
``embeddings['dense']`` the post-ReLU hidden Linear output. The module reads
batch key 'pet1451' of shape (B, D, H, W) and adds the channel axis.
Submodule names follow the flax tree (``convs.block_{i}.{conv,bn}``,
``hidden``, ``cls``), so ``models/convert.py`` maps weights by name. The
dropout masks come from each ``Dropout``'s generator
(``models.layers.set_dropout_generator``).
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
    TracedDropout,
    global_avg_pool,
    reset_parameters,
)


class SmallPETCNN(nn.Module):
    def __init__(self, n_classes: int,
                 conv_out: Sequence[int] = (8, 16, 32, 64),
                 filter_size: Sequence[int] = (5, 5, 3, 3),
                 batchnorm: bool = False,
                 linear_out: int = 64,
                 dropout_conv_p: Optional[float] = None,
                 dropout_dense_p: Optional[float] = None,
                 input_key: str = "pet1451",
                 bn_torch_stats: bool = False,
                 dtype=torch.float32,
                 device=None,
                 generator: torch.Generator | None = None):
        """``linear_out`` 0 (or falsy) leaves out the hidden Linear and the
        dense dropout. ``generator`` draws the initial weights (torch's
        global RNG when None); it must live on ``device``. ``dtype`` is the
        compute dtype: the input is cast to it, the embeddings stay in it
        and the logits return as float32, as in JAX."""
        super().__init__()
        self.n_classes = n_classes
        self.input_key = input_key
        self.dtype = dtype
        self.convs = ConvTower3D(1, conv_out, filter_size, batchnorm,
                                 dropout_conv_p, bn_torch_stats, device,
                                 dtype)
        width = self.convs.out_features
        self.dense_dropout = self.hidden = None
        self.traced_dropout = TracedDropout(dtype)
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
    def from_hparams(cls, hparams: dict, **overrides) -> "SmallPETCNN":
        kwargs = dict(
            n_classes=hparams["n_classes"],
            conv_out=tuple(hparams["conv_out"]),
            filter_size=tuple(hparams["filter_size"]),
            batchnorm=bool(hparams.get("batchnorm", False)),
            linear_out=int(hparams.get("linear_out") or 0),
            dropout_conv_p=hparams.get("dropout_conv_p"),
            dropout_dense_p=hparams.get("dropout_dense_p"),
            bn_torch_stats=bool(hparams.get("bn_torch_stats", False)),
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    def forward(self, batch: dict, dropout_conv_rate=None,
                dropout_dense_rate=None) -> dict:
        """``dropout_conv_rate`` / ``dropout_dense_rate``, given, replace the
        static dropout of the conv blocks / before the hidden Linear with a
        call-time rate (``layers.traced_dropout``, as JAX's traced rates);
        0.0 is bit-exact no dropout."""
        x = batch[self.input_key]
        if x.ndim == 4:
            x = x.unsqueeze(1)  # (B, D, H, W) -> NCDHW
        h = global_avg_pool(self.convs(x.to(self.dtype), dropout_conv_rate))
        if dropout_dense_rate is not None and self.hidden is not None:
            h = self.traced_dropout(h, dropout_dense_rate)
        elif self.dense_dropout is not None:
            h = self.dense_dropout(h)
        embeddings = {"gap": h}
        if self.hidden is not None:
            h = F.relu(self.hidden(h))
            embeddings["dense"] = h
        logits = self.cls(h)
        return {"logits": logits.to(torch.float32), "embeddings": embeddings}

    def fusion_tap(self) -> str:
        """Which embedding the stage-2 fusion uses (anat_pet_fusion.py:28-31):
        the 2-class checkpoints are cut to the GAP features, the 3-class
        ones to the hidden dense output."""
        return "gap" if self.n_classes == 2 else "dense"


class RandomBenchmarkAllCN(SmallPETCNN):
    """Predict-all-CN floor baseline (reference pet_cnn.py:85-90): the
    network runs, and the logits are one-hot on class 0."""

    def forward(self, batch: dict, **rates) -> dict:
        out = super().forward(batch, **rates)
        logits = torch.zeros_like(out["logits"])
        logits[..., 0] = 1.0
        out["logits"] = logits
        return out
