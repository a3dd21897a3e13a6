"""Running a cell on the CPU at a size a test can hold: the run's path
with the port's plain versions of its kernels."""

import torch

from benchmark import run

SIZES = {
    "anat_r18.train.b32": {"grid": (12, 14, 12), "batch": 4, "pool": 12,
                           "warmup_steps": 3},
    "allmod_r18.train.b32": {"grid": (16, 18, 16), "batch": 4, "pool": 12,
                             "warmup_steps": 3},
    "allmod_r18.train_frozen.b32": {"grid": (16, 18, 16), "batch": 4,
                                    "pool": 12, "warmup_steps": 3},
    "anat_r18.serve_int8.c64": {"grid": (12, 14, 12), "pool": 12, "batch": 8,
                                "ladder": [4], "warm_seconds": 0.3},
}


def run_cpu(cell: str, seed: int = 11, seconds: float = 0.5,
            trace: bool = False, bench_dir=run.BENCH_DIR, **overrides):
    sizes = dict(SIZES.get(cell, {}), **overrides)
    env = run.Env(seed, seconds, trace, torch.device("cpu"),
                  overrides=sizes)
    return run.execute(cell, env, bench_dir)
