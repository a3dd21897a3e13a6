"""The frozen yardstick, pinned to the numbers the port's kernel table and
bench.py state; the ResNet-18's convolutions come from its backbone file."""

import json
from pathlib import Path

import pytest

from benchmark.lib import yardstick as y

GRID = (91, 109, 91)
VOXELS = 91 * 109 * 91
BENCH = Path(__file__).resolve().parents[1]
CONFIGS = BENCH / "configs"


def _r18_convs():
    cfg = json.loads((CONFIGS / "anat_r18.json").read_text())
    return y.backbone_convs(cfg, BENCH, GRID)


def test_anat_train_flops_per_volume():
    assert y.train_flops(_r18_convs()) == pytest.approx(444.9e9, rel=1e-4)
    assert y.train_flops(_r18_convs()) == 444904047616.0
    assert y.forward_flops(_r18_convs()) == 150004531712.0


def test_norm_bounds_at_batch_8():
    b = y.norm_bound_s(8, VOXELS)
    assert b["minmax_select"] * 1e3 == pytest.approx(0.0172, abs=5e-5)
    assert b["zscore"] * 1e3 == pytest.approx(0.0259, abs=5e-5)
    assert b["minmax_apply"] == b["zscore"]


def test_k9_forward_bound_at_batch_8_and_32():
    convs = _r18_convs()
    assert y.k9_forward_bound_s(convs, 8) * 1e3 == pytest.approx(0.625,
                                                                 abs=5e-4)
    assert y.k9_forward_bound_s(convs, 32) * 1e3 == pytest.approx(2.500,
                                                                  abs=5e-4)


def test_resnet18_has_20_convs_3_downsamples():
    convs = _r18_convs()
    assert len(convs) == 20
    assert sum(c[0].endswith("downsample") for c in convs) == 3
    assert convs[0][7] == (46, 55, 46)
    assert convs[-1][7] == (12, 14, 12)


def test_bn_bounds_at_the_stem():
    # PR 6's bf16 stem bounds, batch 8: K4 0.0356, K5 0.0711, K6 0.0711,
    # K7 0.1067 ms
    b = y.bn_bound_s((8, 64, 46, 55, 46), 2)
    ms = {k: v * 1e3 for k, v in b.items()}
    assert ms["bn_stats"] == pytest.approx(0.0356, abs=1e-4)
    assert ms["bn_apply"] == pytest.approx(0.0711, abs=1e-4)
    assert ms["bn_grad_sum"] == pytest.approx(0.0711, abs=1e-4)
    assert ms["bn_dx"] == pytest.approx(0.1067, abs=1e-4)


@pytest.mark.parametrize("name", ["anat_r18", "allmod_r18"])
def test_configs_state_the_yardstick_flops(name):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    d = cfg["derived"]
    assert d["conv_flops_per_sample_train"] == y.conv_flops_per_sample(
        cfg, BENCH, True)
    if "conv_flops_per_sample_frozen" in d:
        assert d["conv_flops_per_sample_frozen"] == y.conv_flops_per_sample(
            cfg, BENCH, False)
