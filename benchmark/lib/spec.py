"""Finding a cell's pieces by name: the cell's file, its configuration, its
traffic mix and the traffic kind that runs it, the backbone file its
configuration names, and the metrics that ``BENCHMARK.json`` asks of it. A
configuration whose architecture the reference does not implement, or that
its traffic kind does not admit, is refused when its cell is loaded.

A cell ``<cell>`` is ``workloads/<cell>.json`` ({"config", "traffic",
"why"}); its configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json`` (parameters only, with a ``kind``), the kind's
generator ``traffic/<kind>.py`` (with an optional ``admit(cell)`` that
refuses a cell it cannot run), its backbone ``reference/backbones/
<backbone>.py``, and a per-layer metric ``<metric>`` the reader
``metrics/<metric>.py``. Adding any of them is adding a file.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

from benchmark.reference import nets

BENCH_DIR = Path(__file__).resolve().parents[1]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload: its name, configuration, backbone module, traffic mix,
    and the end-to-end and per-layer metrics it reports."""

    def __init__(self, name: str, bench_dir: Path = BENCH_DIR,
                 manifest: dict | None = None):
        self.name = name
        self.dir = bench_dir
        self.spec = _load_json(bench_dir / "workloads" / f"{name}.json")
        self.config = _load_json(
            bench_dir / "configs" / f"{self.spec['config']}.json")
        self.backbone = nets.check_architecture(self.config, bench_dir)
        self.traffic = _load_json(
            bench_dir / "traffic" / f"{self.spec['traffic']}.json")
        self._kind = None
        admit = getattr(self.kind(), "admit", None)
        if admit is not None:
            admit(self)
        if manifest is None:
            manifest = _load_json(bench_dir.parent / "BENCHMARK.json")
        self.end_to_end = _reported(manifest["end_to_end"], name)
        self.per_layer = _reported(manifest["per_layer"], name)

    def kind(self):
        """The traffic kind's module (``run(cell, env) -> dict``)."""
        if self._kind is None:
            kind = self.traffic["kind"]
            self._kind = _module(self.dir / "traffic" / f"{kind}.py",
                                 f"_portbench_traffic_{kind}")
        return self._kind

    def reader(self, metric: str):
        """The per-layer metric's reader module (``read(ctx)``)."""
        return _module(self.dir / "metrics" / f"{metric}.py",
                       f"_portbench_metric_{metric.replace('.', '_')}")


def _reported(metrics: list, cell: str) -> list:
    """The metrics of ``metrics`` that ``cell`` reports: those without a
    ``workloads`` list, and those whose list names it."""
    return [m for m in metrics
            if "workloads" not in m or cell in m["workloads"]]


def all_cells(bench_dir: Path = BENCH_DIR) -> list:
    return sorted(p.stem for p in (bench_dir / "workloads").glob("*.json"))
