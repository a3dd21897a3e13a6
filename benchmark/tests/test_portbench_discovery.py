"""A configuration, a cell, a traffic mix, a metric and a backbone added as
files are found by name and run, with no edit to the harness."""

import json
import shutil

import pytest

from benchmark.lib import spec, yardstick
from benchmark.tests.cpu import run_cpu

R10 = spec.BENCH_DIR / "tests" / "fixtures" / "backbones" / \
    "medicalnet_r10_dilated.py"

# The ResNet-10's convolutions at (12, 14, 12), written out: (taps, C_in,
# F, output voxels), the stem (its output 6 x 7 x 6) first; layer 1 at 3 x
# 4 x 3 after the pool, layers 2-4 at 2 x 2 x 2, each with a 1^3 shortcut.
R10_CONVS_12_14_12 = [
    (343, 1, 64, 252),
    (27, 64, 64, 36), (27, 64, 64, 36),
    (27, 64, 128, 8), (27, 128, 128, 8), (1, 64, 128, 8),
    (27, 128, 256, 8), (27, 256, 256, 8), (1, 128, 256, 8),
    (27, 256, 512, 8), (27, 512, 512, 8), (1, 256, 512, 8)]
# forward and both gradients of each, no input gradient of the stem
R10_TRAIN_FLOPS = sum((2 if i == 0 else 3) * 2 * t * c * f * v
                      for i, (t, c, f, v) in enumerate(R10_CONVS_12_14_12))


def _checkout(tmp_path):
    """A copy of the benchmark's files, as a checkout holds them, without
    its tests, and the manifest to add to."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__",
                                                  "tests"))
    manifest = json.loads((spec.BENCH_DIR.parent / "BENCHMARK.json")
                          .read_text())
    return root, manifest

READER = '''"""Steps in the traced stretch."""


def read(ctx):
    return ctx.get("traced_steps")
'''


def test_added_files_are_listed_and_run(tmp_path):
    bench = spec.BENCH_DIR
    root, manifest = _checkout(tmp_path)
    cfg = json.loads((bench / "configs" / "anat_r18.json").read_text())
    cfg["name"] = "anat_r18_copy"
    (root / "benchmark" / "configs" / "anat_r18_copy.json").write_text(
        json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "train.b32.json").read_text())
    mix["trace_steps"] = 1
    (root / "benchmark" / "traffic" / "train_short.b32.json").write_text(
        json.dumps(mix))
    cell = "anat_r18_copy.train_short.b32"
    (root / "benchmark" / "workloads" / f"{cell}.json").write_text(json.dumps(
        {"config": "anat_r18_copy", "traffic": "train_short.b32",
         "why": "a copy", "limits": {"loss_gap": 1.0, "grad_gap": 1.0,
                                     "update_gap": 1.0}}))
    (root / "benchmark" / "metrics" / "traced_steps.train.py").write_text(
        READER)
    manifest["workloads"].append({"name": cell, "config": "anat_r18_copy",
                                  "traffic": "train_short.b32", "chips": 1,
                                  "why": "a copy"})
    for m in manifest["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append(cell)
    manifest["per_layer"].append({
        "name": "traced_steps.train", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "train step",
        "moves": "train_samples_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    assert cell in spec.all_cells(root / "benchmark")
    loaded = spec.Cell(cell, root / "benchmark")
    assert "traced_steps.train" in [m["name"] for m in loaded.per_layer]
    assert "train_samples_per_s" in [m["name"] for m in loaded.end_to_end]
    assert "serve_p95_ms" not in [m["name"] for m in loaded.end_to_end]

    result = run_cpu(cell, trace=True, bench_dir=root / "benchmark",
                     dtype="float32", grid=(12, 14, 12), batch=4, pool=12,
                     warmup_steps=3)
    assert result["metrics"]["traced_steps.train"]["value"] == 1
    assert result["correct"] is True


def test_a_backbone_added_as_one_file_is_run(tmp_path):
    """The ResNet-10 enters as its backbone file, a configuration, a cell
    and the manifest's entries: it loads, runs on the CPU, comes out
    correct, and the yardstick and the readers count it from its file."""
    root, manifest = _checkout(tmp_path)
    bench = root / "benchmark"
    shutil.copy(R10, bench / "reference" / "backbones" / R10.name)
    cfg = json.loads((spec.BENCH_DIR / "configs" / "anat_r18.json")
                     .read_text())
    cfg.update(name="anat_r10", backbone="medicalnet_r10_dilated",
               resnet_depth=10)
    del cfg["derived"]
    (bench / "configs" / "anat_r10.json").write_text(json.dumps(cfg))
    cell = "anat_r10.train.b32"
    flagship = json.loads((spec.BENCH_DIR / "workloads" /
                           "anat_r18.train.b32.json").read_text())
    (bench / "workloads" / f"{cell}.json").write_text(json.dumps(
        dict(flagship, config="anat_r10", why="the ResNet-10")))
    manifest["workloads"].append({"name": cell, "config": "anat_r10",
                                  "traffic": "train.b32", "chips": 1,
                                  "why": "the ResNet-10"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "anat_r18.train.b32" in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    loaded = spec.Cell(cell, bench)
    assert loaded.backbone.KEYS == {"resnet_depth": 10, "dilated": True}
    assert yardstick.conv_flops_per_sample(
        dict(cfg, grid=[12, 14, 12]), bench) == R10_TRAIN_FLOPS
    result = run_cpu(cell, trace=True, bench_dir=bench, dtype="float32",
                     grid=(12, 14, 12), batch=4, pool=12, warmup_steps=3)
    assert result["correct"] is True
    # read through the copy's backbone file, which the live tree lacks
    assert result["metrics"]["mfu.train"]["value"] > 0


def test_the_manifest_holds_together():
    """Every cell of BENCHMARK.json has its files, reports set-up, another
    end-to-end metric and a per-layer one; every per-layer metric has its
    reader and is read only in cells that report the metric it moves."""
    manifest = json.loads((spec.BENCH_DIR.parent / "BENCHMARK.json")
                          .read_text())
    cells = [w["name"] for w in manifest["workloads"]]
    assert set(cells) <= set(spec.all_cells())
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert (spec.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]]
    for cell in cells:
        loaded = spec.Cell(cell, manifest=manifest)
        names = [m["name"] for m in loaded.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert loaded.per_layer


@pytest.mark.parametrize("cell", [
    w["name"] for w in json.loads((spec.BENCH_DIR.parent / "BENCHMARK.json")
                                  .read_text())["workloads"]])
def test_a_run_reports_every_end_to_end_metric_of_its_cell(cell):
    result = run_cpu(cell, dtype="float32")
    assert result["correct"] is True
    assert set(result["metrics"]) == {
        m["name"] for m in spec.Cell(cell).end_to_end}
    assert all(m["value"] > 0 for m in result["metrics"].values())
