"""The port's BN-folded and int8 serving graphs (``inference/quantize.py``)
and K9's plain version (``ops/int8_conv.py``) against the JAX package's
``inference/quantize.py`` on the CPU.

Weights are drawn with numpy into the JAX tree and converted
(``models/convert.py``); BN statistics are non-trivial, so folding is
exercised. Tolerances, with their reasons:

- K9's plain version: bit for bit against a numpy int32 oracle (scale 1,
  bias 0) and against JAX's ``_conv_int8`` with random scale and bias (the
  int32 sums are exact; both round the int32 -> float32 conversion, the
  multiply and the add separately, to nearest).
- ``fold_backbone``: bit for bit (both compute ``scale / sqrt(var + eps)``,
  ``kernel * g`` and ``bias - mean * g`` in float32, each operation rounded
  to nearest).
- ``folded_backbone_apply`` against JAX's: rtol 2e-4, atol 2e-5 (JAX's own
  folded-vs-float test; the convolutions sum in other orders).
- ``fold_anat_cnn`` in float32 against the port's float model: the same
  tolerance; in bfloat16 the argmax kept and ``quantization_error``'s
  probability error below JAX's 0.05.
- int8 given JAX's calibration absmax: the quantized weights and every
  scale bit for bit, and every requant site's int8 carrier equal (the
  same int32 sums through the same float32 epilogue and requant); the
  feature map within 1e-6 of its largest value (the head's GAP and residual
  adds are float32 sums in another order).
- End to end, each package calibrating itself: argmax equal, probabilities
  within 5e-3 of JAX's int8 probabilities (the two float32 calibration
  graphs sum in other orders, so an absmax, hence a scale, may differ in
  its last bit, and a value on a rounding boundary may requantize one step
  apart), and each package's ``quantization_error`` within JAX's bounds
  (argmax agreement 1.0, probability error below 0.01).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu.inference import quantize as JQ
from multimodal_alzheimer_tpu.models.mri_models.anat_cnn import (
    AnatCNN as JaxAnatCNN,
)
from multimodal_alzheimer_tpu.models.pet_models.pet_resnet_cnn import (
    PETResNetCNN as JaxPETResNetCNN,
)
from multimodal_alzheimer_tpu_torch.inference import quantize as Q
from multimodal_alzheimer_tpu_torch.models.convert import state_dict_from_flax
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_resnet_cnn import (
    PETResNetCNN,
)
from multimodal_alzheimer_tpu_torch.ops import int8_conv
from torch_port_helpers import random_variables
from torch_threads import torch_threads  # noqa: F401 (autouse)

SPATIAL = (20, 24, 20)
FOLD_TOL = dict(rtol=2e-4, atol=2e-5)
FMAP_TOL = 1e-6
PROB_TOL = 5e-3
DRIFT = {"argmax_agree": 1.0, "prob_max_abs_err": 0.01}
MRI_HP = {"n_classes": 3, "resnet_depth": 10, "linear_out": ()}


# --------------------------------------------------------------------------
# K9's plain version
# --------------------------------------------------------------------------

# (C_in, F, kernel, stride, dilation, pads): the C_in=1 and 2 stems, 3^3 at
# stride 1/2 and dilation 1/2/4, a 1^3 downsample, the PET tower's SAME pads
# (asymmetric for even k), and K not a multiple of 32 (all but 64 x 3^3).
CONV_CASES = [
    (1, 8, (7, 7, 7), 2, 1, ((3, 3),) * 3),
    (2, 8, (7, 7, 7), 2, 1, ((3, 3),) * 3),
    (8, 16, (3, 3, 3), 1, 1, ((1, 1),) * 3),
    (64, 16, (3, 3, 3), 2, 1, ((1, 1),) * 3),
    (64, 24, (1, 1, 1), 2, 1, ((0, 0),) * 3),
    (16, 8, (3, 3, 3), 1, 2, ((2, 2),) * 3),
    (16, 8, (3, 3, 3), 1, 4, ((4, 4),) * 3),
    (8, 4, (4, 4, 4), 1, 1, ((1, 2),) * 3),
    (1, 4, (5, 5, 5), 1, 1, ((2, 2),) * 3),
    (3, 5, (3, 2, 3), 1, 1, ((1, 1), (0, 1), (1, 1))),
]


def _int8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _numpy_conv(x, w, stride, dilation, pads):
    """int32 oracle: x (B, D, H, W, C), w (kd, kh, kw, C, F)."""
    xp = np.pad(x.astype(np.int32), ((0, 0),) + tuple(pads) + ((0, 0),))
    kd, kh, kw = w.shape[:3]
    size = int8_conv.output_size(x.shape[1:4], (kd, kh, kw), stride,
                                 dilation, pads)
    out = np.zeros((x.shape[0],) + size + (w.shape[-1],), np.int32)
    for a in range(kd):
        for b in range(kh):
            for c in range(kw):
                patch = xp[:, a * dilation:, b * dilation:, c * dilation:]
                patch = patch[:, :stride * size[0]:stride,
                              :stride * size[1]:stride,
                              :stride * size[2]:stride]
                out += np.einsum("bdhwc,cf->bdhwf", patch,
                                 w[a, b, c].astype(np.int32))
    return out


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_int8_conv_plain_matches_oracle_and_jax(case):
    cin, f, kernel, stride, dilation, pads = case
    rng = np.random.default_rng(cin * 10 + f)
    x = _int8(rng, (2, 9, 10, 8, cin))
    w = _int8(rng, kernel + (cin, f))  # JAX's DHWIO
    packed = int8_conv.pack_weight(
        torch.from_numpy(w).permute(4, 3, 0, 1, 2).contiguous())
    assert packed.shape == (f, int8_conv.padded_k(np.prod(kernel) * cin))
    ones, zeros = torch.ones(f), torch.zeros(f)
    got = int8_conv.int8_conv3d(torch.from_numpy(x), packed, ones, zeros,
                                kernel, stride, dilation, pads)
    np.testing.assert_array_equal(got.numpy().astype(np.int32),
                                  _numpy_conv(x, w, stride, dilation, pads))

    scale = rng.uniform(1e-4, 1e-2, f).astype(np.float32)
    bias = rng.normal(size=f).astype(np.float32)
    got = int8_conv.int8_conv3d(torch.from_numpy(x), packed,
                                torch.from_numpy(scale),
                                torch.from_numpy(bias), kernel, stride,
                                dilation, pads)
    want = JQ._conv_int8({"wq": jnp.asarray(w), "scale": jnp.asarray(scale),
                          "bias": jnp.asarray(bias)}, jnp.asarray(x), stride,
                         dilation, list(pads))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_conv_refusals():
    x = torch.zeros((1, 4, 4, 4, 8), dtype=torch.int8)
    w = int8_conv.pack_weight(torch.zeros((4, 8, 3, 3, 3), dtype=torch.int8))
    s, b = torch.ones(4), torch.zeros(4)
    args = ((3, 3, 3), 1, 1, ((1, 1),) * 3)
    with pytest.raises(TypeError, match="int8"):
        int8_conv.int8_conv3d(x.float(), w, s, b, *args)
    with pytest.raises(ValueError, match="contiguous"):
        int8_conv.int8_conv3d(x.permute(0, 4, 1, 2, 3), w, s, b, *args)
    with pytest.raises(ValueError, match="columns"):
        int8_conv.int8_conv3d(x, w[:, :-32].contiguous(), s, b, *args)
    big = torch.zeros((1, 4, 4, 4, 5000), dtype=torch.int8)
    with pytest.raises(ValueError, match="overflow"):
        int8_conv.int8_conv3d(big, w, s, b, *args)
    with pytest.raises(ValueError, match="meta"):
        int8_conv.int8_conv3d(x.to("meta"), w.to("meta"), s.to("meta"),
                              b.to("meta"), *args)


# --------------------------------------------------------------------------
# The ResNet backbone: folding and int8 against JAX
# --------------------------------------------------------------------------

def _anat_pair(hp=MRI_HP, seed=0, spatial=SPATIAL, channels=1,
               jax_cls=JaxAnatCNN, port_cls=AnatCNN, key="mri", **overrides):
    """(JAX model, variables, port model, JAX batch, port batch)."""
    jax_model = jax_cls.from_hparams(dict(hp, lr=1e-3), **overrides)
    shape = (1,) + spatial + ((channels,) if channels > 1 else ())
    variables = random_variables(jax_model, seed,
                                 {key: jnp.zeros(shape, jnp.float32)},
                                 train=False)
    port = port_cls.from_hparams(hp, in_channels=channels, **overrides)
    port.load_state_dict(state_dict_from_flax(variables, port))
    rng = np.random.default_rng(seed + 100)
    vol = rng.normal(0.5, 0.5, (2,) + spatial + ((channels,) if channels > 1
                                                  else ())).astype(np.float32)
    port_vol = torch.from_numpy(vol)
    if channels > 1:
        port_vol = port_vol.permute(0, 4, 1, 2, 3).contiguous()
    return (jax_model, variables, port.eval(), {key: jnp.asarray(vol)},
            {key: port_vol})


@pytest.fixture(scope="module")
def anat():
    return {dilated: _anat_pair(dilated=dilated) for dilated in (True, False)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _dhwio(w: torch.Tensor) -> np.ndarray:
    return w.permute(2, 3, 4, 1, 0).numpy()


def test_fold_backbone_matches_jax(anat):
    _, variables, port, _, _ = anat[True]
    want = _flat(JQ.fold_backbone(variables, 10))
    got = _flat(Q.fold_backbone(port, 10))
    assert set(got) == set(want)
    for name, w in want.items():
        g = _dhwio(got[name]) if name.endswith("/w") else got[name].numpy()
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


@pytest.mark.parametrize("dilated", [True, False])
def test_folded_backbone_apply_matches_jax(anat, dilated):
    _, variables, port, jb, pb = anat[dilated]
    want = JQ.folded_backbone_apply(JQ.fold_backbone(variables, 10),
                                    jb["mri"][..., None], depth=10,
                                    dilated=dilated, stem_s2d=False)
    with torch.no_grad():
        got = Q.folded_backbone_apply(Q.fold_backbone(port, 10),
                                      pb["mri"][:, None], depth=10,
                                      dilated=dilated)
        ref = port.backbone(pb["mri"][:, None])
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(want), **FOLD_TOL)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **FOLD_TOL)


def test_fold_anat_cnn(anat):
    _, _, port, _, pb = anat[True]
    serve32, _ = Q.fold_anat_cnn(port, dtype=torch.float32)
    with torch.no_grad():
        ref = port(pb)
    out = serve32(pb)
    assert set(out) == {"logits", "probs", "embeddings"}
    np.testing.assert_allclose(out["logits"].numpy(), ref["logits"].numpy(),
                               **FOLD_TOL)
    np.testing.assert_allclose(out["embeddings"]["backbone_gap"].numpy(),
                               ref["embeddings"]["backbone_gap"].numpy(),
                               **FOLD_TOL)
    serve16, folded = Q.fold_anat_cnn(port)
    assert folded["conv1"]["w"].dtype == torch.bfloat16
    out16 = serve16(pb)
    assert out16["logits"].dtype == torch.float32
    err = Q.quantization_error(port, serve16, pb)
    assert err["argmax_agree"] == 1.0 and err["prob_max_abs_err"] < 0.05, err


class _JaxRecorder(JQ._Int8Ctx):
    def __init__(self, scales):
        super().__init__(scales)
        self.seen = {}

    def requant(self, site, x):
        self.seen[site] = super().requant(site, x)
        return self.seen[site]


class _PortRecorder(Q._Int8Ctx):
    def __init__(self, scales):
        super().__init__(scales)
        self.seen = {}

    def requant(self, site, x):
        self.seen[site] = super().requant(site, x)
        return self.seen[site]


@pytest.mark.parametrize("dilated", [True, False])
def test_int8_backbone_matches_jax_given_its_calibration(anat, dilated):
    _, variables, port, jb, pb = anat[dilated]
    jfolded = JQ.fold_backbone(variables, 10)
    x = jb["mri"][..., None]
    absmax = JQ.calibrate_backbone(jfolded, [x], depth=10, dilated=dilated,
                                   stem_s2d=False)
    jq = JQ.quantize_backbone(jfolded, absmax, depth=10, dilated=dilated,
                              stem_s2d=False)
    with torch.no_grad():
        pq = Q.quantize_backbone(Q.fold_backbone(port, 10), absmax, depth=10,
                                 dilated=dilated, stem_s2d=False)
    assert pq["scales"] == jq["scales"]
    pflat = _flat(pq)
    for name, want in _flat(jq).items():
        if name.startswith(("scales/", "config/")):
            continue
        conv, leaf = name.rsplit("/", 1)
        got = pflat[name]
        if leaf == "wq":
            got = _dhwio(int8_conv.unpack_weight(
                got, pflat[f"{conv}/kernel"], np.asarray(want).shape[3]))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=name)

    jctx, pctx = _JaxRecorder(jq["scales"]), _PortRecorder(pq["scales"])
    want = JQ._backbone_forward(jq, x, jctx, depth=10, dilated=dilated,
                                stem_s2d=False)
    with torch.no_grad():
        got = Q._backbone_forward(pq, pb["mri"][:, None], pctx, depth=10,
                                  dilated=dilated)
    assert list(pctx.seen) == list(jctx.seen)
    for site, q in jctx.seen.items():
        np.testing.assert_array_equal(pctx.seen[site].numpy(), np.asarray(q),
                                      err_msg=site)
    want = np.asarray(want)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               rtol=0, atol=FMAP_TOL * np.abs(want).max())


def _check_int8_pair(jax_model, variables, jax_serve, port, port_serve, jb,
                     pb):
    jax_serve = jax.jit(jax_serve)
    want = jax_serve(jb)
    got = port_serve(pb)
    assert set(got) == set(want) == {"logits", "probs", "embeddings"}
    assert set(got["embeddings"]) == set(want["embeddings"])
    np.testing.assert_array_equal(got["logits"].numpy().argmax(-1),
                                  np.asarray(want["logits"]).argmax(-1))
    np.testing.assert_allclose(got["probs"].numpy(), np.asarray(want["probs"]),
                               rtol=0, atol=PROB_TOL)
    for err in (JQ.quantization_error(jax_model, variables, jax_serve, jb),
                Q.quantization_error(port, port_serve, pb)):
        assert err["argmax_agree"] == DRIFT["argmax_agree"], err
        assert err["prob_max_abs_err"] < DRIFT["prob_max_abs_err"], err


# (label, _anat_pair arguments): depth 10 dilated and strided, depth 50,
# PETResNetCNN and the 2-channel stem.
E2E_CASES = {
    "depth10_dilated": {},
    "depth10_strided": {"dilated": False},
    "depth50": {"hp": dict(MRI_HP, resnet_depth=50), "spatial": (16, 16, 16)},
    "pet_resnet": {"jax_cls": JaxPETResNetCNN, "port_cls": PETResNetCNN,
                   "key": "pet1451"},
    "stem_2ch": {"channels": 2, "seed": 5},
}


@pytest.mark.parametrize("label", list(E2E_CASES))
def test_quantize_anat_cnn_matches_jax(label):
    jax_model, variables, port, jb, pb = _anat_pair(**E2E_CASES[label])
    jax_serve, jq = JQ.quantize_anat_cnn(jax_model, variables, [jb])
    port_serve, pq = Q.quantize_anat_cnn(port, [pb])
    assert pq["config"]["stem_s2d"] == jq["config"]["stem_s2d"]
    assert set(pq["scales"]) == set(jq["scales"])
    _check_int8_pair(jax_model, variables, jax_serve, port, port_serve, jb,
                     pb)
    if label == "stem_2ch":
        with pytest.raises(ValueError, match="single input channel"):
            Q.quantize_anat_cnn(port, [pb], stem_s2d=True)
