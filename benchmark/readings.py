"""Readings that set a cell's limits: the program's numbers over many seeds,
and on some of them the control's and the planted faults', in one process.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 [--out FILE]

Train cells: the program's first three steps against the reference; the
control is the reference computed in float8 (``nets.Numerics("fp8")``) put
in the program's place; the fault ``half_batch`` is the reference that
takes its loss's mean over the first half of each batch's rows, the logits
still of the whole batch. (A state left unchanged reads ``update_gap`` and
``grad1_diff`` 1, and a gradient of the other sign ``grad1_diff`` 2, by
construction: they need no run.) Serve cells: the answers of a short burst of
the clients against the reference; the control is the reference's rule in
4-bit integers; the faults ``swapped`` (each checked answer given to
another request) and ``half_batch`` (the second half of the checked answers
replaced by the first half's). One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def worst(prog: dict, ref: dict, key: str, top: int = 3) -> list:
    """The leaves that read the largest gaps of ``key``."""
    med = statistics.median(ref[key].values())
    gm = statistics.median(ref["grad"].values())
    rows = sorted(((abs(prog[key][k] - ref[key][k]) / max(ref[key][k], med),
                    k, ref["grad"][k] / gm) for k in ref[key]), reverse=True)
    return [[k, g, r] for g, k, r in rows[:top]]


def train_seed(cell, seed, device, control: bool) -> dict:
    from benchmark.lib import compare
    from benchmark.traffic import train

    session = train.Session(cell, seed, device, {})
    prog = session.readings
    session.close()
    ref = train.reference(session)
    out = {"seed": seed, "program": compare.train_numbers(prog, ref),
           "loss_gaps": [abs(p - r) / abs(r) for p, r in
                         zip(prog["loss"], ref["loss"])],
           "worst_grad": worst(prog, ref, "grad"),
           "worst_update": worst(prog, ref, "update")}
    if control:
        for name, kw in (("control", {"numerics": "fp8"}),
                         ("half_batch", {"loss_rows": session.batch // 2})):
            other = train.reference(session, **kw)
            out[name] = compare.train_numbers(other, ref)
            out[name + "_loss_gaps"] = [abs(p - r) / abs(r) for p, r in
                                        zip(other["loss"], ref["loss"])]
    return out


def serve_seed(cell, seed, device, control: bool, seconds: float) -> dict:
    import numpy as np
    import torch

    from benchmark.lib import compare, inputs
    from benchmark.traffic import serve_closed as serve

    session = serve.Session(cell, seed, device, {})
    clients = session.burst(seconds)
    records = [r for r in clients.records if not isinstance(r[4],
                                                             Exception)]
    session.close()
    numbers, checked = serve.check(session, records,
                                   cell.traffic["check_requests"])
    out = {"seed": seed, "program": numbers, "checked": checked}
    if control:
        rng = np.random.default_rng(inputs.stream_seed(seed, "check"))
        pick = rng.choice(len(records), size=min(
            cell.traffic["check_requests"], len(records)), replace=False)
        idx = [records[i][0] for i in sorted(pick)]
        ref = serve.reference(session, idx)
        low = serve.reference(session, idx, bits=4)
        out["control"] = compare.serve_numbers(low, ref)
        swapped = {k: torch.roll(v, 1, 0) for k, v in ref.items()}
        out["swapped"] = compare.serve_numbers(swapped, ref)
        half = len(idx) // 2
        halved = {k: torch.cat([v[:half], v[:len(idx) - half]])
                  for k, v in ref.items()}
        out["half_batch"] = compare.serve_numbers(halved, ref)
        out["logit_spread"] = float(ref["logits"].std(0).max())
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--burst-seconds", type=float, default=2.0)
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    import torch

    from benchmark.lib import spec

    if not torch.cuda.is_available():
        print("readings are taken on the card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = spec.Cell(args.workload)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else sys.stdout
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        if cell.traffic["kind"] == "train":
            row = train_seed(cell, seed, device, seed in control)
        else:
            row = serve_seed(cell, seed, device, seed in control,
                             args.burst_seconds)
        row["cell"], row["seconds"] = args.workload, time.time() - t
        print(json.dumps(row), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
