"""TabPFN: the reference's pretrained tabular transformer, in PyTorch.

Port of ``multimodal_alzheimer_tpu/models/tabular_models/tabpfn.py``. The
reference's tabular branch is ``tabpfn.TabPFNClassifier``, a
prior-data-fitted transformer (arXiv 2207.01848) that classifies a test row
by in-context attention over the whole training set, as an ensemble of
input permutations (reference tabular_models/dl_approach.py:47-78). Its
saved artifact is ``classifier.model[2].state_dict()`` (dl_approach.py:44);
its fusion contribution is the 1024-d pre-GELU ``decoder[0]`` activation
at the test rows, averaged over the ensemble members (dl_approach.py:71-78).

* ``TabPFNTransformer``: the architecture behind that state dict (Linear
  feature and label encoders, post-norm encoder layers with the PFN
  train/test attention mask, the 512->1024->10 decoder), with submodule
  names that follow the JAX package's flax tree (``encoder``,
  ``y_encoder``, ``layers_{i}.{in_proj,out_proj,norm1,norm2,linear1,
  linear2}``, ``decoder_0``, ``decoder_2``), so ``models/convert.py``
  carries JAX weights over and ``convert_state_dict`` carries the tabpfn
  layout over. Attention is plain matmul and softmax (XLA's in JAX, where no
  Pallas kernel computes it).
* ``TabPFNClassifier``: ``fit`` stores the train set, ``predict_proba``
  attends test rows over it, ``embed`` returns the ensemble mean of the
  decoder tap, the fusion models' 'tabular_embedding' batch key. All
  members run as one batched forward with a leading member axis, as the
  JAX package runs them in one ``jax.vmap``-ed program.

Divergences from upstream that the JAX package documents are kept: the
members' configurations are deterministic class and feature rotations, and
the preprocessing is the 'none' pipeline. Faults of the JAX reference are
kept too (ROADMAP section C): the inlier mask of ``_preprocess`` is a
hard-coded +-2 sigma band not centred on the mean, upstream's [-100, 100]
clip is missing, and ``class_shifts``/``feature_shifts`` are cut to the
ensemble size without a length check. The JAX ``_forward`` is jitted with
the classifier itself static, so a refit with another class count can reuse
a stale program; the port has no such cache and recomputes. The ``mesh=``
ensemble parallelism is not ported.

``dtype`` is the compute dtype: Linear and LayerNorm compute in it, and as
in JAX the query scaled by a NumPy scalar promotes the attention scores,
softmax and context to float32 (``out_proj`` casts the context back);
logits and the decoder tap are returned in float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_alzheimer_tpu_torch.models.layers import (
    Linear,
    reset_parameters,
)
from multimodal_alzheimer_tpu_torch.utils.device import resolve_device
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator

MAX_FEATURES = 100
N_OUT = 10
LN_EPS = 1e-5


def pfn_attention_mask(seq_len: int, n_train: int,
                       device=None) -> torch.Tensor:
    """Additive float32 attention mask of the prior-fitted-network kind:
    position r attends to c iff c is a train position or r == c (tabpfn
    ``generate_D_q_matrix``), so a test row's prediction does not depend on
    the other test rows."""
    cols = torch.arange(seq_len, device=device)
    allowed = (cols[None, :] < n_train) | (cols[None, :] == cols[:, None])
    return torch.where(allowed, 0.0, -math.inf).to(torch.float32)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: float32 statistics with the
    fast variance ``max(0, E[x^2] - E[x]^2)``, ``(x - mean) * (rsqrt(var +
    eps) * scale) + bias`` in float32, cast to ``dtype`` once."""

    def __init__(self, features: int, eps: float = LN_EPS, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias
        return y.to(self.dtype)


class EncoderLayer(nn.Module):
    """Post-norm ``nn.TransformerEncoderLayer`` (GELU, dropout 0) over a
    (..., S, E) sequence: fused ``in_proj``, q scaled by 1/sqrt(dh) before
    the product, additive mask, erf-exact GELU, LayerNorm eps 1e-5."""

    def __init__(self, emsize: int, nhead: int, nhid: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.nhead = nhead
        kw = dict(device=device, compute_dtype=dtype)
        self.in_proj = Linear(emsize, 3 * emsize, **kw)
        self.out_proj = Linear(emsize, emsize, **kw)
        self.norm1 = LayerNorm(emsize, device=device, dtype=dtype)
        self.linear1 = Linear(emsize, nhid, **kw)
        self.linear2 = Linear(nhid, emsize, **kw)
        self.norm2 = LayerNorm(emsize, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        *lead, s, e = x.shape
        dh = e // self.nhead
        q, k, v = self.in_proj(x).chunk(3, dim=-1)

        def heads(t):  # (..., S, E) -> (..., H, S, dh), float32
            return t.reshape(*lead, s, self.nhead, dh).transpose(-3, -2) \
                .to(torch.float32)

        # JAX divides by a NumPy scalar, which promotes q to float32.
        q = heads(q) / math.sqrt(dh)
        scores = q @ heads(k).transpose(-1, -2) + mask
        ctx = torch.softmax(scores, dim=-1) @ heads(v)
        ctx = ctx.transpose(-3, -2).reshape(*lead, s, e)
        x = self.norm1(x + self.out_proj(ctx))
        h = self.linear2(F.gelu(self.linear1(x)))
        return self.norm2(x + h)


class TabPFNTransformer(nn.Module):
    """The state-dict-bearing TabPFN core (reference dl_approach.py:44).

    Input: one (train + test) sequence per member, features zero-padded to
    ``max_features``, as (S, F) or (M, S, F) with labels (n_train,) or (M,
    n_train). Train tokens are ``encoder(x) + y_encoder(y)``, test tokens
    ``encoder(x)`` alone. Returns the test rows' logits and the pre-GELU
    ``decoder_0`` activations (the tap the reference hooks), both float32.
    """

    def __init__(self, emsize: int = 512, nhead: int = 4, nhid: int = 1024,
                 nlayers: int = 12, n_out: int = N_OUT,
                 max_features: int = MAX_FEATURES, dtype=torch.float32,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.emsize, self.nhead, self.nhid = emsize, nhead, nhid
        self.nlayers, self.n_out = nlayers, n_out
        self.max_features = max_features
        self.dtype = dtype
        kw = dict(device=device, compute_dtype=dtype)
        self.encoder = Linear(max_features, emsize, **kw)
        self.y_encoder = Linear(1, emsize, **kw)
        for i in range(nlayers):
            self.add_module(f"layers_{i}", EncoderLayer(
                emsize, nhead, nhid, device=device, dtype=dtype))
        self.decoder_0 = Linear(emsize, nhid, **kw)
        self.decoder_2 = Linear(nhid, n_out, **kw)
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor, y_train: torch.Tensor,
                n_train: int) -> dict:
        seq_len = x.shape[-2]
        tok = self.encoder(x)
        y_tok = self.y_encoder(y_train.unsqueeze(-1))
        h = torch.cat([tok[..., :n_train, :] + y_tok, tok[..., n_train:, :]],
                      dim=-2)
        mask = pfn_attention_mask(seq_len, n_train, x.device)
        for i in range(self.nlayers):
            h = getattr(self, f"layers_{i}")(h, mask)
        dec = self.decoder_0(h[..., n_train:, :])
        logits = self.decoder_2(F.gelu(dec))
        return {"logits": logits.to(torch.float32),
                "embeddings": {"decoder": dec.to(torch.float32)}}


def convert_state_dict(sd) -> dict:
    """tabpfn ``model[2].state_dict()`` -> ``TabPFNTransformer`` state dict.

    Accepts the dict the reference saves at ``tabular_baseline.pth``
    (dl_approach.py:44; tensors or numpy arrays). Linear weights keep
    torch's (out, in) layout; ``transformer_encoder.layers.N`` maps to
    ``layers_N`` with the fused ``in_proj`` kept fused, ``decoder.0`` and
    ``decoder.2`` to ``decoder_0`` and ``decoder_2``.
    """
    a = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
    out = {}

    def move(src, dst):
        for leaf in ("weight", "bias"):
            out[f"{dst}.{leaf}"] = a[f"{src}.{leaf}"]

    for src, dst in (("encoder", "encoder"), ("y_encoder", "y_encoder"),
                     ("decoder.0", "decoder_0"), ("decoder.2", "decoder_2")):
        move(src, dst)
    n_layers = 1 + max(int(k.split(".")[2]) for k in a
                       if k.startswith("transformer_encoder.layers."))
    for i in range(n_layers):
        p = f"transformer_encoder.layers.{i}"
        out[f"layers_{i}.in_proj.weight"] = a[p + ".self_attn.in_proj_weight"]
        out[f"layers_{i}.in_proj.bias"] = a[p + ".self_attn.in_proj_bias"]
        move(p + ".self_attn.out_proj", f"layers_{i}.out_proj")
        for name in ("linear1", "linear2", "norm1", "norm2"):
            move(f"{p}.{name}", f"layers_{i}.{name}")
    return out


def model_from_state_dict(state_dict: dict, nhead: int = 4,
                          dtype=torch.float32) -> TabPFNTransformer:
    """The transformer whose shapes ``state_dict`` (the port's names) has.
    Every width but ``nhead`` is in the weight shapes; tabpfn's published
    prior-fitted checkpoints use nhead 4."""
    emsize, max_features = state_dict["encoder.weight"].shape
    nhid = state_dict["decoder_0.weight"].shape[0]
    n_out = state_dict["decoder_2.weight"].shape[0]
    nlayers = len({k.split(".")[0] for k in state_dict
                   if k.startswith("layers_")})
    return TabPFNTransformer(emsize=emsize, nhead=nhead, nhid=nhid,
                             nlayers=nlayers, n_out=n_out,
                             max_features=max_features, dtype=dtype)


def inlier_mask(tr: torch.Tensor) -> torch.Tensor:
    """The JAX ``_preprocess`` inlier test (``tabpfn.py:209``): within
    +-2 sample std of 0 per feature, not of the feature's mean (a fault of
    the reference, kept)."""
    sd = tr.std(-2, correction=1, keepdim=True)
    return (tr >= -2.0 * sd) & (tr <= 2.0 * sd)


def _preprocess(x_all: torch.Tensor, n_train: int, n_used: int,
                max_features: int, n_sigma: float = 4.0) -> torch.Tensor:
    """The tabpfn 'none' input pipeline from train-row statistics, over the
    last two axes (rows, features) of a float32 (..., S, F) tensor: z-score
    (unbiased std + 1e-6), a soft log outlier clip at ``n_sigma`` sigmas of
    the inliers' statistics, a ``max_features / n_used`` rescale and zero
    padding to ``max_features`` (upstream's [-100, 100] clip is missing, as
    in JAX)."""
    tr = x_all[..., :n_train, :]
    mean = tr.mean(-2, keepdim=True)
    std = tr.std(-2, correction=1, keepdim=True) + 1e-6
    x = (x_all - mean) / std
    tr = x[..., :n_train, :]
    inlier = inlier_mask(tr)
    cnt = torch.clamp(inlier.sum(-2, keepdim=True), min=1)
    m2 = torch.where(inlier, tr, 0.0).sum(-2, keepdim=True) / cnt
    v2 = torch.where(inlier, (tr - m2) ** 2, 0.0).sum(-2, keepdim=True) \
        / torch.clamp(cnt - 1, min=1)
    cut = n_sigma * torch.sqrt(v2)
    x = torch.maximum(-torch.log1p(torch.abs(x)) + (m2 - cut), x)
    x = torch.minimum(torch.log1p(torch.abs(x)) + (m2 + cut), x)
    x = x * (max_features / n_used)
    return F.pad(x, (0, max_features - x.shape[-1]))


class TabPFNClassifier:
    """In-context fit/predict, every ensemble member in one batched forward.

    The API follows the reference's use of ``tabpfn.TabPFNClassifier``
    (dl_approach.py:55-59): ``fit`` stores the train set (the prior-fitted
    weights are the model), ``predict_proba`` attends the test rows over
    it. Member i rotates the class labels by ``class_shifts[i]`` and the
    feature columns by ``feature_shifts[i]``; its softmax probabilities are
    rotated back and the members averaged. ``embed`` returns the members'
    mean pre-GELU decoder activations at the test rows
    (``get_avg_activation``, dl_approach.py:71-78).

    ``state_dict``: the transformer's weights (port names; ``model`` gives
    the shapes, ``TabPFNTransformer()`` by default); None draws random
    weights from ``seed`` (tests and smoke runs only). The model runs on
    ``device``, the card unless the caller asks for the CPU.
    """

    def __init__(self, state_dict: dict | None = None,
                 ensemble_size: int = 4,
                 class_shifts: Sequence[int] | None = None,
                 feature_shifts: Sequence[int] | None = None,
                 softmax_temperature: float = 1.0,
                 model: TabPFNTransformer | None = None,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.model = model or TabPFNTransformer()
        self.state_dict = state_dict
        self.ensemble_size = ensemble_size
        self._class_shifts = class_shifts
        self._feature_shifts = feature_shifts
        self.temperature = softmax_temperature
        self.seed = seed
        self.x_train = None
        self.y_train = None
        self.classes_ = None

    def fit(self, x, y) -> "TabPFNClassifier":
        x = np.asarray(x, np.float32)
        self.classes_, y_idx = np.unique(np.asarray(y), return_inverse=True)
        self.x_train = torch.from_numpy(x).to(self.device)
        self.y_train = torch.from_numpy(
            y_idx.astype(np.float32)).to(self.device)
        if self.state_dict is None:  # random prior: tests and smoke only
            reset_parameters(self.model, make_generator(self.seed))
            for m in self.model.modules():
                if isinstance(m, LayerNorm):
                    m.reset_parameters()
            self.state_dict = self.model.state_dict()
        self.model.load_state_dict(self.state_dict)
        self.model.to(self.device).eval()
        n_c, n_f = len(self.classes_), x.shape[1]
        cs, fs = self._class_shifts, self._feature_shifts
        if cs is None or fs is None:
            pairs = [(c, f) for f in range(n_f) for c in range(n_c)]
            reps = -(-self.ensemble_size // len(pairs))  # cycle if short
            pairs = (pairs * reps)[:self.ensemble_size]
            cs = cs if cs is not None else [p[0] for p in pairs]
            fs = fs if fs is not None else [p[1] for p in pairs]
        self.class_shifts = torch.tensor(list(cs)[:self.ensemble_size],
                                         device=self.device)
        self.feature_shifts = torch.tensor(list(fs)[:self.ensemble_size],
                                           device=self.device)
        return self

    @torch.inference_mode()
    def _run(self, x_test):
        """(mean probabilities (T, n_c), mean decoder tap (T, nhid)) over
        the members, all in one forward."""
        x_test = torch.from_numpy(np.asarray(x_test, np.float32)).to(
            self.device)
        x_all = torch.cat([self.x_train, x_test], 0)
        n_train, n_used = self.x_train.shape[0], x_all.shape[1]
        n_c = len(self.classes_)
        cols = (torch.arange(n_used, device=self.device)[None]
                + self.feature_shifts[:, None]) % n_used  # (M, F)
        xs = _preprocess(x_all[:, cols].transpose(0, 1), n_train, n_used,
                         self.model.max_features)
        ys = (self.y_train[None] + self.class_shifts[:, None]) % n_c
        out = self.model(xs, ys, n_train)
        probs = torch.softmax(out["logits"][..., :n_c] / self.temperature,
                              dim=-1)
        # Member slot (t + c_shift) % n_c holds true class t: undo.
        slots = (torch.arange(n_c, device=self.device)[None]
                 + self.class_shifts[:, None]) % n_c  # (M, n_c)
        probs = torch.take_along_dim(probs, slots[:, None, :], dim=-1)
        return probs.mean(0), out["embeddings"]["decoder"].mean(0)

    def predict_proba(self, x_test, normalize_with_test=False) -> np.ndarray:
        del normalize_with_test  # train-stat normalisation only (default)
        return self._run(x_test)[0].cpu().numpy()

    def predict(self, x_test, return_winning_probability=False):
        probs = self.predict_proba(x_test)
        pred = self.classes_.take(np.argmax(probs, -1))
        if return_winning_probability:
            return pred, probs.max(-1)
        return pred

    def embed(self, x_test) -> np.ndarray:
        """The members' mean 1024-d decoder tap (``get_avg_activation``)."""
        return self._run(x_test)[1].cpu().numpy()
