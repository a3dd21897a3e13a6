"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared with
the reference beside its limit, which also end standard error.
"""

from __future__ import annotations

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Every build and kernel cache inside the checkout, at fixed paths: the
# port's CUDA build lands in its own _build/; these cover torch's.
CACHE = BENCH_DIR / "_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_alzheimer_tpu")


class Env:
    """What a traffic kind is given: the run's arguments, its device and
    the process's start; ``overrides`` resize a run for the CPU tests."""

    def __init__(self, seed: int, seconds: float, trace: bool, device,
                 started: float = STARTED, overrides: dict | None = None):
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.started = device, started
        self.overrides = overrides or {}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def end_to_end_value(measured: dict, name: str):
    """The quantity a run measured under an end-to-end metric's name: its
    own, or, for a metric split by the cells whose noise it shares, the
    quantity its name ends in (``fusion_train_samples_per_s`` reads
    ``train_samples_per_s``); None where the run measured neither."""
    if name in measured:
        return measured[name]
    return next((v for k, v in measured.items() if name.endswith("_" + k)),
                None)


def device_info(device, count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count}


def execute(cell_name: str, env: Env, bench_dir: Path = BENCH_DIR) -> dict:
    """Run the cell; the result's dict (without printing it)."""
    from benchmark.lib import compare, spec
    from benchmark.lib.trace import breakdown, busy_idle

    cell = spec.Cell(cell_name, bench_dir)
    out = cell.kind().run(cell, env)
    host = out["ctx"].get("window_host", {})
    correct, checks = compare.judge(out["numbers"], cell.spec["limits"])
    correct = correct and out["failed"] == 0
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": {}}
    if env.trace:
        ctx = dict(out["ctx"], trace=out["trace"], cell=cell.name,
                   bench_dir=cell.dir)
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = (out["setup_s"] if m["name"] == "setup_s"
                     else end_to_end_value(out["end_to_end"], m["name"]))
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
    device = {"memory_peak_bytes": out["memory_peak_bytes"]}
    if env.device.type == "cuda":
        device = dict(device_info(env.device, 1), **device)
    if env.trace:
        busy, span = busy_idle(out["trace"])
        device.update(busy_s=busy, window_s=span)
        result["breakdown"] = breakdown(out["trace"])
    result["device"] = device
    result["window_host"] = host
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    chips = json.loads((ROOT / "BENCHMARK.json").read_text())
    need = {w["name"]: w["chips"] for w in chips["workloads"]}.get(
        args.workload)
    if need is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    env = Env(args.seed, args.seconds, bool(args.trace), device)
    result = execute(args.workload, env)
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 4
    if not args.trace:
        print(f"setup_s: {result['metrics']['setup_s']['value']!r}",
              file=sys.stderr)
    print(f"window: {json.dumps(result.pop('window_host'))}", file=sys.stderr)
    for c in result["checks"].values():  # a number that never came: null
        if not math.isfinite(c["value"]):
            c["value"] = None
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
