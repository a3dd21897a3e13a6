"""The port's deployment CLI (``multimodal_alzheimer_tpu_torch/tools/
export_artifact.py``) against the JAX package's root
``tools/export_artifact.py``, on the CPU.

Each case makes the JAX checkpoint (seeded random weights with non-trivial
BatchNorm statistics), carries it to the port with
``models/convert.state_dict_from_flax`` and saves it as a port checkpoint
with the same hparams, exports with both tools from the same arguments, and
runs both artifacts on one raw batch (the cases of
``tests/test_export_artifact.py``). Tolerances:

- float: rtol 2e-4, atol 2e-5 (JAX's own, ``test_export_artifact.py``);
- folded: the exporter folds into bf16 in both packages, whose rounding of
  convolution sums summed in other orders differs by an ulp here and
  there: probabilities within 0.05 (JAX's bf16 bound) and the argmax equal
  where the top-two margin exceeds 0.1. With the fold's dtype set to
  float32 in both packages, ``FOLD_TOL`` of ``tests/test_torch_quantize.py``
  (rtol 2e-4, atol 2e-5);
- int8, each package calibrating itself on the same synthetic example
  batch (drawn with numpy in the same order): argmax equal, probabilities
  within ``PROB_TOL`` (5e-3) of JAX's, as ``test_torch_quantize.py``.

Every refusal of JAX's tool is reproduced with the same message.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import export_artifact as jax_export  # noqa: E402

from multimodal_alzheimer_tpu.inference import quantize as JQ  # noqa: E402
from multimodal_alzheimer_tpu.inference.export import (  # noqa: E402
    load_exported as jax_load_exported,
)
from multimodal_alzheimer_tpu.models.fusion_models.anat_pet_fusion import (  # noqa: E402,E501
    AnatPETFusion as JaxAnatPETFusion,
)
from multimodal_alzheimer_tpu.models.fusion_models.early_fusion import (  # noqa: E402,E501
    PETMRIEarlyFusion as JaxPETMRIEarlyFusion,
)
from multimodal_alzheimer_tpu.models.mri_models.anat_cnn import (  # noqa: E402,E501
    AnatCNN as JaxAnatCNN,
)
from multimodal_alzheimer_tpu.models.pet_models.pet_cnn import (  # noqa: E402,E501
    SmallPETCNN as JaxSmallPETCNN,
)
from multimodal_alzheimer_tpu.models.tabular_models.tabular_mlp import (  # noqa: E402,E501
    TabularMLP as JaxTabularMLP,
)
from multimodal_alzheimer_tpu.train.checkpoint import (  # noqa: E402
    save_checkpoint as jax_save_checkpoint,
)
from multimodal_alzheimer_tpu_torch.inference import quantize as Q  # noqa: E402,E501
from multimodal_alzheimer_tpu_torch.inference.export import (  # noqa: E402
    load_exported,
)
from multimodal_alzheimer_tpu_torch.models.convert import (  # noqa: E402
    state_dict_from_flax,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.anat_pet_fusion import (  # noqa: E402,E501
    AnatPETFusion,
)
from multimodal_alzheimer_tpu_torch.models.fusion_models.early_fusion import (  # noqa: E402,E501
    PETMRIEarlyFusion,
)
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import (  # noqa: E402,E501
    AnatCNN,
)
from multimodal_alzheimer_tpu_torch.models.pet_models.pet_cnn import (  # noqa: E402,E501
    SmallPETCNN,
)
from multimodal_alzheimer_tpu_torch.models.tabular_models.tabular_mlp import (  # noqa: E402,E501
    TabularMLP,
)
from multimodal_alzheimer_tpu_torch.ops.normalization import (  # noqa: E402
    batched_normalize_mri,
)
from multimodal_alzheimer_tpu_torch.tools import export_artifact  # noqa: E402
from multimodal_alzheimer_tpu_torch.train.checkpoint import (  # noqa: E402
    load_checkpoint,
    save_checkpoint,
)
from torch_port_helpers import random_variables  # noqa: E402
from torch_threads import torch_threads  # noqa: E402,F401 (autouse)

SHAPE = (12, 14, 12)
PET_SHAPE = (17, 18, 16)
FLOAT_TOL = dict(rtol=2e-4, atol=2e-5)
FOLD_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_PROB_TOL = 0.05
PROB_TOL = 5e-3
SHAPE_ARGS = ["--volume-shape", *map(str, SHAPE)]
PET_SHAPE_ARGS = ["--volume-shape", *map(str, PET_SHAPE)]


# --------------------------------------------------------------------------
# checkpoints: the JAX one and its port counterpart
# --------------------------------------------------------------------------

def _pair(tmp_path, name, jax_model, port_model, hparams, init_batch,
          seed):
    """(JAX checkpoint dir, port checkpoint dir) with the same weights."""
    variables = random_variables(
        jax_model, seed, {k: jnp.asarray(v) for k, v in init_batch.items()},
        train=False)
    jax_dir = str(tmp_path / f"jax_{name}")
    port_dir = str(tmp_path / f"port_{name}")
    jax_save_checkpoint(jax_dir, jax.tree_util.tree_map(jnp.asarray,
                                                        variables), hparams)
    save_checkpoint(port_dir, state_dict_from_flax(variables, port_model),
                    hparams)
    return jax_dir, port_dir


def _anat_pair(tmp_path, name="mri", hparams=None):
    hparams = hparams or {"n_classes": 3, "resnet_depth": 10,
                          "linear_out": [], "lr": 1e-3,
                          "norm_percentile": 0.99}
    return _pair(tmp_path, name, JaxAnatCNN.from_hparams(hparams),
                 AnatCNN.from_hparams(hparams), hparams,
                 {"mri": np.zeros((1,) + SHAPE, np.float32)}, 0)


PET_HP = {"n_classes": 3, "conv_out": [4, 8], "filter_size": [5, 3],
          "linear_out": 8, "lr": 1e-3, "norm_mean": 0.5145,
          "norm_std": 0.5383}


def _pet_pair(tmp_path, shape=PET_SHAPE):
    return _pair(tmp_path, "pet", JaxSmallPETCNN.from_hparams(PET_HP),
                 SmallPETCNN.from_hparams(PET_HP), PET_HP,
                 {"pet1451": np.zeros((1,) + shape, np.float32)}, 1)


def _export_both(tmp_path, jax_dir, port_dir, args, tag):
    """Run both tools; returns (JAX serve fn, port serve fn)."""
    jax_out = str(tmp_path / f"{tag}.shlo")
    port_out = str(tmp_path / f"{tag}.pt2")
    jax_export.main([jax_dir, "--out", jax_out] + args)
    assert export_artifact.main([port_dir, "--out", port_out] + args,
                                device="cpu") == port_out
    with open(jax_out, "rb") as f:
        jax_serve = jax_load_exported(f.read())
    with open(port_out, "rb") as f:
        port_serve = load_exported(f.read())
    return jax_serve, port_serve


def _raw(seed, inputs, shape=SHAPE, n=2):
    rng = np.random.default_rng(seed)
    batch = {}
    if "mri" in inputs:
        batch["mri"] = rng.normal(900, 400, (n,) + shape).astype(np.float32)
        batch["mri_mask"] = (rng.random((n,) + shape) > 0.35).astype(
            np.float32)
    if "pet" in inputs:
        batch["pet1451"] = rng.normal(0.5, 0.5, (n,) + shape).astype(
            np.float32)
    if "tabular" in inputs:
        batch["tabular"] = rng.normal(size=(n, 9)).astype(np.float32)
    return batch


def _run_both(jax_serve, port_serve, raw):
    got = port_serve({k: torch.from_numpy(v) for k, v in raw.items()})
    want = jax_serve({k: jnp.asarray(v) for k, v in raw.items()})
    assert got["logits"].shape == tuple(want["logits"].shape)
    np.testing.assert_allclose(got["probs"].sum(-1).numpy(), 1.0, rtol=1e-5)
    return ({k: got[k].numpy() for k in ("logits", "probs")},
            {k: np.asarray(want[k]) for k in ("logits", "probs")})


def _hold(mode, got, want):
    """The tolerance of ``mode`` (module docstring)."""
    if mode == "float":
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   **FLOAT_TOL)
    elif mode == "folded_f32":
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   **FOLD_TOL)
    elif mode == "folded":
        assert np.abs(got["probs"] - want["probs"]).max() < BF16_PROB_TOL
        top2 = np.sort(want["probs"], axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * BF16_PROB_TOL
        np.testing.assert_array_equal(got["probs"].argmax(1)[clear],
                                      want["probs"].argmax(1)[clear])
    else:
        np.testing.assert_array_equal(got["probs"].argmax(1),
                                      want["probs"].argmax(1))
        assert np.abs(got["probs"] - want["probs"]).max() < PROB_TOL


@pytest.fixture
def fold_in_float32(monkeypatch):
    """Both packages' fold functions with the fold's dtype set to
    float32, as the exporters look them up."""
    for module, dtype in ((JQ, jnp.float32), (Q, torch.float32)):
        for name in ("fold_anat_cnn", "fold_mri_fusion",
                     "fold_all_modalities_fusion"):
            monkeypatch.setattr(module, name, functools.partial(
                getattr(module, name), dtype=dtype))


# --------------------------------------------------------------------------
# the cases of tests/test_export_artifact.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["float", "folded", "int8"])
def test_export_anat_cnn_modes(tmp_path, mode):
    jax_dir, port_dir = _anat_pair(tmp_path)
    jax_serve, port_serve = _export_both(
        tmp_path, jax_dir, port_dir,
        ["--model", "anat_cnn", "--mode", mode, "--batch", "2",
         *SHAPE_ARGS, "--synthetic-calib"], f"mri_{mode}")
    got, want = _run_both(jax_serve, port_serve, _raw(3, {"mri"}))
    _hold(mode, got, want)


def test_export_anat_cnn_folded_float32(tmp_path, fold_in_float32):
    jax_dir, port_dir = _anat_pair(tmp_path)
    jax_serve, port_serve = _export_both(
        tmp_path, jax_dir, port_dir,
        ["--model", "anat_cnn", "--mode", "folded", "--batch", "2",
         *SHAPE_ARGS], "mri_folded_f32")
    _hold("folded_f32", *_run_both(jax_serve, port_serve, _raw(3, {"mri"})))


def test_export_pet_cnn_int8_and_float(tmp_path):
    jax_dir, port_dir = _pet_pair(tmp_path)
    for mode in ("float", "int8"):
        jax_serve, port_serve = _export_both(
            tmp_path, jax_dir, port_dir,
            ["--model", "pet_cnn", "--mode", mode, "--batch", "2",
             *PET_SHAPE_ARGS, "--synthetic-calib"], f"pet_{mode}")
        raw = _raw(4, {"pet"}, PET_SHAPE)
        _hold(mode, *_run_both(jax_serve, port_serve, raw))


def _stage2_pair(tmp_path):
    """anat_pet_fusion: stage-1 checkpoints of both packages, the fusion's
    hparams naming each package's own."""
    jax_pet, port_pet = _pet_pair(tmp_path, SHAPE)
    jax_mri, port_mri = _anat_pair(tmp_path)
    _, pet_hp, _ = load_checkpoint(port_pet)
    _, mri_hp, _ = load_checkpoint(port_mri)
    base = {"n_classes": 3, "lr": 1e-3, "lr_pretrained": None}
    variables = random_variables(
        JaxAnatPETFusion.from_hparams(base, pet_hp, mri_hp), 7,
        {"pet1451": jnp.zeros((1,) + SHAPE), "mri": jnp.zeros((1,) + SHAPE)},
        train=False)
    jax_dir, port_dir = str(tmp_path / "jax_ap"), str(tmp_path / "port_ap")
    jax_save_checkpoint(jax_dir, jax.tree_util.tree_map(jnp.asarray,
                                                        variables),
                        dict(base, path_pet=jax_pet, path_mri=jax_mri))
    save_checkpoint(port_dir, state_dict_from_flax(
        variables, AnatPETFusion.from_hparams(base, pet_hp, mri_hp)),
        dict(base, path_pet=port_pet, path_mri=port_mri))
    return jax_dir, port_dir


@pytest.mark.parametrize("mode", ["folded", "int8"])
def test_export_stage2_fusion_folded_and_int8(tmp_path, mode):
    """anat_pet_fusion: the loader resolves the stage-1 sub-checkpoints
    through the embedded paths; folded and int8 route the MRI tower through
    fold_mri_fusion / quantize_mri_fusion."""
    jax_dir, port_dir = _stage2_pair(tmp_path)
    jax_serve, port_serve = _export_both(
        tmp_path, jax_dir, port_dir,
        ["--model", "anat_pet_fusion", "--mode", mode, "--batch", "2",
         *SHAPE_ARGS, "--synthetic-calib"], f"ap_{mode}")
    _hold(mode, *_run_both(jax_serve, port_serve, _raw(8, {"mri", "pet"})))


def test_export_tabular_and_early_fusion(tmp_path):
    tab_hp = {"n_classes": 3, "hidden": [16, 32], "lr": 1e-3}
    jax_dir, port_dir = _pair(
        tmp_path, "tab", JaxTabularMLP.from_hparams(tab_hp),
        TabularMLP.from_hparams(tab_hp), tab_hp,
        {"tabular": np.zeros((1, 9), np.float32)}, 11)
    jax_serve, port_serve = _export_both(
        tmp_path, jax_dir, port_dir,
        ["--model", "tabular", "--mode", "float", "--batch", "2"], "tab")
    _hold("float", *_run_both(jax_serve, port_serve, _raw(12, {"tabular"})))

    ef_hp = {"n_classes": 2, "conv_out": [4, 8], "filter_size": [5, 3],
             "linear_out": 8, "lr": 1e-3, "norm_mean": 0.51,
             "norm_std": 0.54}
    zeros = np.zeros((1,) + PET_SHAPE, np.float32)
    jax_dir, port_dir = _pair(
        tmp_path, "ef", JaxPETMRIEarlyFusion.from_hparams(ef_hp),
        PETMRIEarlyFusion.from_hparams(ef_hp), ef_hp,
        {"pet1451": zeros, "mri": zeros}, 13)
    jax_serve, port_serve = _export_both(
        tmp_path, jax_dir, port_dir,
        ["--model", "early_fusion", "--mode", "float", "--batch", "2",
         *PET_SHAPE_ARGS], "ef")
    raw = _raw(14, {"mri", "pet"}, PET_SHAPE)
    del raw["mri_mask"]  # the all-scan norm takes no mask
    _hold("float", *_run_both(jax_serve, port_serve, raw))


def test_export_uses_checkpoint_quantile(tmp_path):
    """The fused preprocessing comes from the checkpoint's hparams
    (norm_percentile 0.9), in the port's artifact as in JAX's."""
    hparams = {"n_classes": 3, "resnet_depth": 10, "linear_out": [],
               "lr": 1e-3, "norm_percentile": 0.9}
    jax_dir, port_dir = _anat_pair(tmp_path, "q90", hparams)
    jax_serve, port_serve = _export_both(
        tmp_path, jax_dir, port_dir,
        ["--model", "anat_cnn", "--mode", "float", "--batch", "2",
         *SHAPE_ARGS], "q90")
    raw = _raw(5, {"mri"})
    got, want = _run_both(jax_serve, port_serve, raw)
    _hold("float", got, want)

    state, hp, _ = load_checkpoint(port_dir)
    model = AnatCNN.from_hparams(hp)
    model.load_state_dict(state)
    pre = {"mri": batched_normalize_mri(
        torch.from_numpy(raw["mri"]), torch.from_numpy(raw["mri_mask"]),
        {"per_scan_norm": "min_max"}, 0.9)}
    with torch.no_grad():
        ref = model.eval()(pre)["logits"].numpy()
    np.testing.assert_allclose(got["logits"], ref, **FLOAT_TOL)


def test_export_int8_from_calibration_file(tmp_path):
    """``--calib``: both packages calibrate on the npz's rows, the example
    batch is its first ``--batch`` rows."""
    jax_dir, port_dir = _anat_pair(tmp_path)
    calib = tmp_path / "calib.npz"
    np.savez(calib, **_raw(21, {"mri"}, n=3))
    jax_serve, port_serve = _export_both(
        tmp_path, jax_dir, port_dir,
        ["--model", "anat_cnn", "--mode", "int8", "--batch", "2",
         *SHAPE_ARGS, "--calib", str(calib)], "calib")
    _hold("int8", *_run_both(jax_serve, port_serve, _raw(22, {"mri"})))


# --------------------------------------------------------------------------
# refusals: each of JAX's, with its message, from both tools
# --------------------------------------------------------------------------

def _npz(tmp_path, **arrays):
    path = tmp_path / "calib.npz"
    np.savez(path, **arrays)
    return str(path)


REFUSALS = {
    "int8_without_calib": (
        "pet", ["--mode", "int8"], lambda p: [], "needs --calib"),
    "folded_without_backbone": (
        "pet", ["--mode", "folded"], lambda p: [], "--mode folded"),
    "int8_without_quantizer": (
        "tab", ["--mode", "int8"], lambda p: [], "no quantized path"),
    "calib_without_batched_arrays": (
        "pet", ["--mode", "int8"],
        lambda p: ["--calib", _npz(p, scale=np.float32(1.0))],
        "no batched arrays"),
    "calib_leading_dims_disagree": (
        "pet", ["--mode", "int8"],
        lambda p: ["--calib", _npz(
            p, pet1451=np.zeros((2,) + PET_SHAPE, np.float32),
            tabular=np.zeros((3, 9), np.float32))],
        "disagree on the leading"),
    "calib_fewer_rows_than_batch": (
        "pet", ["--mode", "int8"],
        lambda p: ["--calib", _npz(
            p, pet1451=np.zeros((1,) + PET_SHAPE, np.float32))],
        "1 rows < --batch 2"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_export_refusals_match_jax(tmp_path, case):
    family, mode_args, extra, message = REFUSALS[case]
    if family == "pet":
        jax_dir, port_dir = _pet_pair(tmp_path)
        model = "pet_cnn"
    else:
        tab_hp = {"n_classes": 3, "hidden": [16, 32], "lr": 1e-3}
        jax_dir, port_dir = _pair(
            tmp_path, "tab", JaxTabularMLP.from_hparams(tab_hp),
            TabularMLP.from_hparams(tab_hp), tab_hp,
            {"tabular": np.zeros((1, 9), np.float32)}, 11)
        model = "tabular"
    args = (["--model", model, "--batch", "2", *PET_SHAPE_ARGS]
            + mode_args + extra(tmp_path))
    with pytest.raises(SystemExit, match=message) as port_exit:
        export_artifact.main([port_dir, "--out", str(tmp_path / "x.pt2")]
                             + args, device="cpu")
    with pytest.raises(SystemExit, match=message) as jax_exit:
        jax_export.main([jax_dir, "--out", str(tmp_path / "x.shlo")] + args)
    assert str(port_exit.value) == str(jax_exit.value)
    assert not (tmp_path / "x.pt2").exists()
