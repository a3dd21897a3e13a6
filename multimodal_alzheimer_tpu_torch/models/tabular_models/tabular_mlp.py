"""On-device tabular classifier (the JAX package's TabPFN replacement).

Port of ``multimodal_alzheimer_tpu/models/tabular_models/tabular_mlp.py``:
a standardising MLP over the 9 clinical features (batch key 'tabular',
(B, 9), or the reference's (B, 1, 9)) whose last hidden layer is the
``decoder`` embedding tap, 1024 wide by default, the width of the
reference's TabPFN decoder hook that the fusion heads consume
(reference tabular_models/dl_approach.py:71-78).

When the batch holds 'tabular_embedding', that array is the ``decoder``
embedding and the trunk is skipped: TabPFN decoder activations computed
beforehand (``TabPFNClassifier.embed``) feed a fusion checkpoint exactly.

Submodules follow the flax tree (``dense_{i}``, ``cls``), so
``models/convert.py`` maps weights by name; the feature statistics are
hyperparameters, kept as buffers outside the ``state_dict``. ``dtype`` is
the compute dtype (f32 parameters, f32 logits, the tap in ``dtype``). The
HPO path's traced dropout rate is not ported; ``dropout_p`` is.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_alzheimer_tpu_torch.models.layers import (
    Dropout,
    Linear,
    reset_parameters,
)


class TabularMLP(nn.Module):
    def __init__(self, n_classes: int, hidden: Sequence[int] = (256, 1024),
                 dropout_p: float = 0.0,
                 feature_mean: Sequence[float] | None = None,
                 feature_std: Sequence[float] | None = None,
                 in_features: int = 9,
                 input_key: str = "tabular",
                 embedding_key: str = "tabular_embedding",
                 dtype=torch.float32,
                 device=None,
                 generator: torch.Generator | None = None):
        """``feature_mean``/``feature_std``: the train split's per-feature
        statistics (``compute_feature_stats``); None leaves the features as
        they are. ``generator`` draws the initial weights (torch's global
        RNG when None); it must live on ``device``."""
        super().__init__()
        self.n_classes = n_classes
        self.hidden = tuple(hidden)
        self.input_key = input_key
        self.embedding_key = embedding_key
        self.dtype = dtype
        self.standardize = feature_mean is not None
        if self.standardize:
            for name, value in (("feature_mean", feature_mean),
                                ("feature_std", feature_std)):
                self.register_buffer(name, torch.tensor(
                    value, dtype=torch.float32, device=device),
                    persistent=False)
        width = in_features
        for i, features in enumerate(self.hidden):
            self.add_module(f"dense_{i}", Linear(width, features,
                                                 device=device,
                                                 compute_dtype=dtype))
            if dropout_p:
                self.add_module(f"dropout_{i}", Dropout(dropout_p))
            width = features
        self.dropout_p = float(dropout_p)
        self.cls = Linear(width, n_classes, device=device,
                          compute_dtype=dtype)
        reset_parameters(self, generator)

    @classmethod
    def from_hparams(cls, hparams: dict, **overrides) -> "TabularMLP":
        kwargs = dict(
            n_classes=hparams["n_classes"],
            hidden=tuple(hparams.get("hidden", (256, 1024))),
            dropout_p=float(hparams.get("dropout_p", 0.0)),
            feature_mean=(tuple(hparams["feature_mean"])
                          if hparams.get("feature_mean") is not None
                          else None),
            feature_std=(tuple(hparams["feature_std"])
                         if hparams.get("feature_std") is not None
                         else None),
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    def forward(self, batch: dict) -> dict:
        dt = self.dtype
        if self.embedding_key and self.embedding_key in batch:
            h = batch[self.embedding_key].to(dt)
            return {"logits": self.cls(h).to(torch.float32),
                    "embeddings": {"decoder": h}}
        x = batch[self.input_key].to(dt)
        if x.ndim == 3:  # the reference's unsqueeze(1)
            x = x[:, 0, :]
        if self.standardize:
            # (x - mean) / std on operands cast to dtype, rounded once
            x = ((x.float() - self.feature_mean.to(dt).float())
                 / self.feature_std.to(dt).float()).to(dt)
        h = x
        for i in range(len(self.hidden)):
            h = F.relu(getattr(self, f"dense_{i}")(h))
            if self.dropout_p:
                h = getattr(self, f"dropout_{i}")(h)
        return {"logits": self.cls(h).to(torch.float32),
                "embeddings": {"decoder": h}}

    def fusion_tap(self) -> str:
        return "decoder"


def compute_feature_stats(features) -> tuple[list, list]:
    """Per-feature mean and (biased) std over the train split, in float64;
    a constant feature gets std 1."""
    arr = np.asarray(features, dtype=np.float64)
    mean = arr.mean(axis=0)
    std = arr.std(axis=0)
    std = np.where(std == 0, 1.0, std)
    return mean.tolist(), std.tolist()
