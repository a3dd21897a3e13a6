"""Run a function on several local ranks, one spawned process each.

``run_ranks(fn, world_size, backend, *args)`` starts ``world_size``
processes with the ``spawn`` method, initialises a process group of the
named backend in each (through a file in a temporary directory, so that no
TCP port is taken), calls ``fn(mesh, *args)`` with the rank's
``parallel.Mesh`` and returns the ranks' results in rank order. ``fn`` must
be importable (a module-level function): a spawned child imports the
module that defines it. The wait has a deadline: a rank that hangs in a
collective fails the call with ``TimeoutError`` and every child is killed.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from multimodal_alzheimer_tpu_torch.parallel.mesh import make_mesh


def _rank_main(rank, fn, world_size, backend, device, tmp, timeout, args):
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'init')}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        mesh = make_mesh(device=device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        result = fn(mesh, *args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, backend: str, *args, device="cuda",
              timeout: float = 300.0, group_timeout: float = 60.0) -> list:
    """``[fn(mesh, *args) on rank r for r in range(world_size)]``, each rank
    in its own process, its mesh on ``device`` (the card unless the caller
    asks for the CPU). A rank's exception is raised here; ``timeout``
    seconds bound the whole run and ``group_timeout`` each collective."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, backend, device, tmp,
                              group_timeout, args),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{world_size} ranks of {fn.__name__} still running "
                        f"after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]
