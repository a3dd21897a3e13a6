"""A configuration's architecture keys reach the program, the reference and
the yardstick; a value that the reference or the yardstick does not
implement (no backbone file for it, or a file whose keys differ) is refused
before anything is built, never run as another model."""

import json
import shutil

import pytest
import torch

from benchmark.lib import compare, spec, yardstick
from benchmark.tests.cpu import SIZES
from benchmark.traffic import train

MANIFEST = json.loads((spec.BENCH_DIR.parent / "BENCHMARK.json").read_text())
FIXTURES = spec.BENCH_DIR / "tests" / "fixtures" / "backbones"

# A backbone whose blocks the int8 rule does not take.
BOTTLENECK = """KEYS = {"resnet_depth": 18, "dilated": True}
BLOCK = "bottleneck"
LAYERS = [(64, 3, 1, 1), (128, 4, 2, 1), (256, 6, 1, 2), (512, 3, 1, 4)]
"""


def _copy_with(tmp_path, config: str, **changes):
    """A copy of the harness, with the fixtures' backbone files among its
    own, and ``changes`` made to the configuration ``config``."""
    root = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR, root,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__",
                                                  "tests"))
    for f in FIXTURES.glob("*.py"):
        shutil.copy(f, root / "reference" / "backbones" / f.name)
    path = root / "configs" / f"{config}.json"
    cfg = json.loads(path.read_text())
    cfg.update(changes)
    path.write_text(json.dumps(cfg))
    return root, cfg


@pytest.mark.parametrize("key,value,match", [
    ("resnet_depth", 50, "resnet_depth"), ("dilated", False, "dilated"),
    ("linear_out", [64], "linear_out"),
    ("batchnorm_begin", True, "batchnorm_begin"),
    ("trailing_relu", False, "trailing_relu"), ("model", "r50", "r50"),
    # a backbone that has no file
    ("backbone", "medicalnet_r50", "medicalnet_r50"),
    # a backbone file whose KEYS (resnet_depth 10) differ from the
    # configuration's
    ("backbone", "medicalnet_r10_dilated", "resnet_depth=18")])
def test_an_unimplemented_anat_architecture_is_refused(tmp_path, key, value,
                                                        match):
    root, cfg = _copy_with(tmp_path, "anat_r18", **{key: value})
    with pytest.raises(ValueError, match=match):
        spec.Cell("anat_r18.train.b32", root, MANIFEST)


def test_a_serve_cell_of_other_blocks_is_refused(tmp_path):
    """The int8 rule is the basic blocks' rule: a serve cell whose backbone
    has other blocks is refused on load, naming the backbone; its train
    cell loads."""
    root, _ = _copy_with(tmp_path, "anat_r18", backbone="bottleneck_r18")
    (root / "reference" / "backbones" / "bottleneck_r18.py").write_text(
        BOTTLENECK)
    with pytest.raises(ValueError, match="bottleneck_r18"):
        spec.Cell("anat_r18.serve_int8.c64", root, MANIFEST)
    assert spec.Cell("anat_r18.train.b32", root, MANIFEST).backbone.BLOCK \
        == "bottleneck"


@pytest.mark.parametrize("change", [
    {"towers": {"mri": 1, "pet": 2, "tab": 2}},
    {"frozen_towers_shared": False},
    {"pet_tower_simple_dim_red": False},
    {"pet": {"conv_out": [8, 16, 32, 64], "filter_size": [5, 5, 3, 3],
             "batchnorm": True, "linear_out": 64}},
    {"pet": {"conv_out": [8, 16, 32, 64], "filter_size": [4, 4, 3, 3],
             "batchnorm": False, "linear_out": 64}},
    {"tabular": {"hidden": [256, 1024], "features": 9, "dropout_p": 0.2}},
], ids=["towers", "unshared", "dim_red", "pet_bn", "pet_even", "dropout"])
def test_an_unimplemented_fusion_architecture_is_refused(tmp_path, change):
    root, _ = _copy_with(tmp_path, "allmod_r18", **change)
    with pytest.raises(ValueError):
        spec.Cell("allmod_r18.train.b32", root, MANIFEST)


def test_the_yardstick_counts_no_other_backbone():
    cfg = json.loads((spec.BENCH_DIR / "configs" / "anat_r18.json")
                     .read_text())
    with pytest.raises(ValueError):
        yardstick.conv_flops_per_sample(dict(cfg, resnet_depth=50),
                                        spec.BENCH_DIR)
    with pytest.raises(ValueError):
        yardstick.conv_flops_per_sample(dict(cfg, backbone="medicalnet_r50"),
                                        spec.BENCH_DIR)


def test_tower_widths_reach_program_reference_and_yardstick(tmp_path):
    pet = {"conv_out": [4, 8, 16, 32], "filter_size": [3, 3, 3, 3],
           "batchnorm": False, "linear_out": 32}
    tab = {"hidden": [32, 64], "features": 9, "dropout_p": 0.0}
    root, cfg = _copy_with(tmp_path, "allmod_r18", pet=pet, tabular=tab)
    cell = spec.Cell("allmod_r18.train.b32", root, MANIFEST)
    session = train.Session(cell, 21, torch.device("cpu"),
                            dict(SIZES[cell.name], dtype="float32"))
    shapes = {k: tuple(v.shape) for k, v in session.template.items()}
    session.close()
    pre = "model_anat_pet.pet_model."
    assert [shapes[f"{pre}convs.block_{i}.conv.weight"][:3]
            for i in range(4)] == [(4, 1, 3), (8, 4, 3), (16, 8, 3),
                                   (32, 16, 3)]
    assert shapes[f"{pre}hidden.weight"] == (32, 32)
    assert shapes["model_pet_tab.tab_model.dense_1.weight"] == (64, 32)
    numbers = compare.train_numbers(session.readings,
                                    train.reference(session))
    assert numbers["loss1_gap"] < 1e-5
    assert numbers["grad_gap"] < 0.01
    default = json.loads((spec.BENCH_DIR / "configs" / "allmod_r18.json")
                         .read_text())
    assert yardstick.conv_flops_per_sample(cfg, root) < \
        yardstick.conv_flops_per_sample(default, spec.BENCH_DIR)
