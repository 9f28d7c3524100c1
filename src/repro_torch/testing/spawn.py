"""Run a function on P spawned processes that form one process group — the
port's stand-in for a JAX mesh of P host devices.

    from repro_torch.testing.spawn import spawn_ranks

    results = spawn_ranks(work, 4, A)  # work(A) on ranks 0..3, in rank order

Each rank is a fresh ``spawn`` process (``fn`` is pickled by its import path,
so it must be a module-level function) that joins the group through a file
store in a temporary directory — no TCP port, so concurrent runs on one host
do not collide — runs ``fn(*args)``, and writes its return value to a file
the parent reads back.  A rank that raises makes ``spawn_ranks`` raise (the
others are stopped).  ``fn`` picks its own device; with the ``gloo`` backend
several ranks may share one card.
"""
from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["spawn_ranks"]


def _rank_main(rank: int, world: int, tmp: str, backend: str, timeout_s: float,
               fn, args) -> None:
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(*args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, *args, backend: str = "gloo",
                timeout_s: float = 600.0) -> list:
    """``[fn(*args) on rank r for r in range(world_size)]``, each rank a
    spawned process in one ``backend`` process group; ``timeout_s`` bounds
    each collective."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(world_size, tmp, backend, timeout_s,
                                             fn, args),
                           nprocs=world_size, join=True, start_method="spawn")
        # files this function's own ranks wrote
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
