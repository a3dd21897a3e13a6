"""``inference/export.py``: serving graphs through ``torch.export`` to bytes
and back, on the CPU.

Each artifact reloads (``load_exported``) to outputs bit for bit equal to the
eager port on the same batch: the exported program runs the same operations,
the port's kernels as the custom ops ``mmalz_port::*`` (here their CPU
kernels, the plain versions), whose fake kernels ``torch.export`` traced
with. Covered: the float model with the min-max preprocess (K1 and K2 as
ops), the BN-folded float32 serve, the int8 serve (K9 as an op), and a
stage-2 fusion with an int8 MRI tower.
"""

import io

import numpy as np
import pytest
import torch

from multimodal_alzheimer_tpu_torch.data.preprocess import (
    make_device_preprocess,
)
from multimodal_alzheimer_tpu_torch.inference import export as E
from multimodal_alzheimer_tpu_torch.inference import quantize as Q
from multimodal_alzheimer_tpu_torch.models.fusion_models.tabular_mri_fusion import (
    TabularMRIFusion,
)
from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN
from multimodal_alzheimer_tpu_torch.utils.seeding import make_generator
from torch_threads import torch_threads  # noqa: F401 (autouse)

SHAPE = (12, 14, 12)
MINMAX = {"per_scan_norm": "min_max"}


def _batch(seed, n=2, tabular=False):
    rng = np.random.default_rng(seed)
    batch = {"mri": rng.normal(900, 400, (n,) + SHAPE).astype(np.float32),
             "mri_mask": (rng.random((n,) + SHAPE) > 0.35).astype(
                 np.float32)}
    if tabular:
        batch["tabular"] = rng.normal(size=(n, 9)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def model():
    m = AnatCNN(n_classes=3, resnet_depth=10,
                generator=make_generator(3)).eval()
    with torch.no_grad():
        m.head.cls.bias.fill_(1.0)  # keeps the trailing ReLU off its floor
    return m


def _ops(blob) -> set:
    program = torch.export.load(io.BytesIO(blob))
    return {str(n.target) for n in program.graph.nodes
            if str(n.target).startswith("mmalz_port.")}


def _assert_equal(got: dict, want: dict):
    assert set(got) <= set(want)
    for key, value in got.items():
        if isinstance(value, dict):
            _assert_equal(value, want[key])
        else:
            assert torch.equal(value, want[key]), key


def test_export_model_float_with_preprocess(model):
    preprocess = make_device_preprocess(normalize_mri=MINMAX, quantile=0.99)
    batch = _batch(0)
    blob = E.export_model(model, batch, preprocess)
    assert isinstance(blob, bytes)
    assert _ops(blob) == {"mmalz_port.order_stats.default",
                          "mmalz_port.minmax_apply.default"}
    got = E.load_exported(blob)(batch)
    assert set(got) == {"logits", "probs"}
    with torch.no_grad():
        logits = model(preprocess(batch))["logits"]
    _assert_equal(got, {"logits": logits,
                        "probs": torch.softmax(logits, dim=-1)})


@pytest.mark.parametrize("kind", ["folded", "int8"])
def test_export_serve_fn_round_trips(model, kind):
    preprocess = make_device_preprocess(normalize_mri=MINMAX, quantile=0.99)
    batch = _batch(1)
    if kind == "folded":
        serve, _ = Q.fold_anat_cnn(model, preprocess, dtype=torch.float32)
    else:
        serve, _ = Q.quantize_anat_cnn(model, [_batch(2)], preprocess)
    blob = E.export_serve_fn(serve, batch)
    ops = _ops(blob)
    assert ("mmalz_port.int8_conv3d.default" in ops) == (kind == "int8")
    got = E.load_exported(blob)(batch)
    assert set(got) == {"logits", "probs", "embeddings"}
    _assert_equal(got, serve(batch))


def test_export_stage2_fusion_with_int8_tower():
    fusion = TabularMRIFusion.from_hparams(
        {"n_classes": 3, "lr": 1e-3, "lr_pretrained": None},
        {"n_classes": 3, "resnet_depth": 10, "linear_out": ()},
        {"n_classes": 3, "hidden": (16, 32)},
        generator=make_generator(4)).eval()
    preprocess = make_device_preprocess(normalize_mri=MINMAX, quantile=0.99)
    batch = _batch(5, tabular=True)
    serve, _ = Q.quantize_mri_fusion(fusion, [_batch(6, tabular=True)],
                                     preprocess)
    blob = E.export_serve_fn(serve, batch)
    assert "mmalz_port.int8_conv3d.default" in _ops(blob)
    _assert_equal(E.load_exported(blob)(batch), serve(batch))
