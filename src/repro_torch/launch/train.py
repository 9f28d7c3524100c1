"""Training launcher: one device, or a (data, model) mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --steps 20 \\
        --optimizer orthant                                   # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \\
        --device cpu --steps 3 --seq-len 16 --global-batch 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \\
        --mesh 2x2 --steps 3                                  # 4 ranks
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --mesh 2x2 --steps 3                          # the same, 4 ranks torchrun started

The JAX package's ``launch/train.py`` flags, plus ``--device`` (default: the
card; with no CUDA device the default exits non-zero).  ``--mesh 1x1`` (the
default) trains on one device.  ``--mesh DxM`` trains ``Trainer(mesh=...)``
on a (data, model) mesh of D·M ranks, one process each: under ``torchrun``
the launcher joins the group it started (its world size must be D·M);
alone it starts the D·M ranks on this host itself (a file store, as
``testing.spawn``), at most one a CPU core the host grants it.  Rank r runs on
``cuda:{r % cards}``, with NCCL when every rank has a card of its own and gloo
when ranks share one; the first line printed names the backend.  Where the
ranks cannot be formed (``prod`` = 16x16 and ``prod2`` = 2x16x16 span many
hosts) the launcher exits non-zero naming the ranks it needs: it never
trains on fewer devices than the mesh asks for (the reference drops to one
device there).  The first step is a warm-up; rank 0 prints the time a step and
tokens a second over the steps after it, on the card the peak memory
allocated, then the reference's ``done: N steps, final loss X`` line.
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import time

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_mesh
from repro_torch.serve.dispatch import resolve_device
from repro_torch.train import Trainer
from repro_torch.train.trainer import refuse_grad_compression

_PROG = "repro_torch.launch.train"


def _mesh_arg(text: str):
    """(shape, axis names) of ``--mesh``: ``prod``, ``prod2`` or ``DxM``."""
    if text in ("prod", "prod2"):
        return PRODUCTION_SHAPES[text == "prod2"]
    try:
        d, m = (int(x) for x in text.split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(f"--mesh {text!r}: 'DxM', 'prod' or 'prod2'") from None
    if d < 1 or m < 1:
        raise argparse.ArgumentTypeError(f"--mesh {text!r}: D and M must be positive")
    return (d, m), ("data", "model")


def _under_torchrun() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))


def _backend(device: torch.device, ranks: int) -> tuple:
    """(backend, the sentence the first line of output says it with)."""
    if device.type != "cuda":
        return "gloo", "gloo on the CPU"
    cards = torch.cuda.device_count()
    if cards >= ranks:
        return "nccl", f"nccl, one card each of {cards}"
    return "gloo", f"gloo, {ranks} ranks sharing {cards} card{'s' if cards > 1 else ''}"


def _train(args, tr: Trainer, device: torch.device, say) -> None:
    """The warm-up step, the timed steps, and their report (``say``)."""
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    losses = tr.run(min(args.steps, tr.step_num + 1))  # the warm-up step
    t0 = time.perf_counter()
    first = tr.step_num
    losses += tr.run(args.steps)
    dt = time.perf_counter() - t0
    n = tr.step_num - first
    name = torch.cuda.get_device_name(device) if on_card else "CPU"
    if n:
        say(f"{args.arch}: {dt / n:.4f} s/step, "
            f"{n * args.global_batch * args.seq_len / dt:.1f} tok/s "
            f"(batch {args.global_batch} x {args.seq_len}, {args.optimizer}, {name})")
    if on_card:
        say(f"{args.arch}: peak memory allocated "
            f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    say(f"done: {args.steps} steps, final loss {losses[-1]:.4f}")


def _trainer(args, device, mesh=None) -> Trainer:
    cfg = get_config(args.arch, smoke=args.smoke)
    return Trainer(cfg, mesh=mesh, optimizer=args.optimizer, lr=args.lr,
                   seq_len=args.seq_len, global_batch=args.global_batch, accum=args.accum,
                   ckpt_dir=args.ckpt_dir, grad_compression=args.grad_compression,
                   device=device)


def _rank_main(args, shape, axes, device_type: str, said: str) -> None:
    """One rank of a mesh run, in a process group already joined."""
    import torch.distributed as dist

    rank = dist.get_rank()
    if device_type == "cuda":  # torchrun numbers a host's ranks LOCAL_RANK
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    else:  # the host's cores shared out among its ranks
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // dist.get_world_size()))
    mesh = make_mesh(shape, axes, device_type)
    if rank == 0:
        print(f"mesh {'x'.join(map(str, shape))} {axes}: {math.prod(shape)} ranks, {said}",
              flush=True)
    tr = _trainer(args, None, mesh)
    _train(args, tr, tr.device, (lambda line: print(line, flush=True)) if rank == 0
           else (lambda line: None))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "orthant"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="1x1", type=_mesh_arg,
                    help="'DxM' (data x model ranks; 1x1: one device), 'prod' (16x16) "
                         "or 'prod2' (2x16x16)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compression", default=None, choices=[None, "int8_ef"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="training device (default: the card)")
    args = ap.parse_args(argv)
    if args.steps < 2:
        ap.error("--steps must be at least 2 (the first step is a warm-up)")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"{_PROG}: {e}")
    try:
        refuse_grad_compression(args.grad_compression)
    except NotImplementedError as e:
        sys.exit(f"{_PROG}: {e}")
    shape, axes = args.mesh
    ranks = math.prod(shape)
    name = "x".join(map(str, shape))
    if ranks == 1:
        _train(args, _trainer(args, device), device, print)
        return
    backend, said = _backend(device, ranks)
    if _under_torchrun():
        import torch.distributed as dist

        world = int(os.environ["WORLD_SIZE"])
        if world != ranks:
            sys.exit(f"{_PROG}: --mesh {name} needs {ranks} ranks; torchrun started {world}")
        dist.init_process_group(backend)
        try:
            _rank_main(args, shape, axes, device.type, said)
        finally:
            dist.destroy_process_group()
        return
    cores = len(os.sched_getaffinity(0))
    if ranks > cores:
        sys.exit(f"{_PROG}: --mesh {name} needs {ranks} ranks, one process each, and this "
                 f"host forms at most {cores} (one a CPU core it grants); the {ranks - cores} "
                 f"ranks beyond them cannot be formed here: start a {name} mesh's ranks on "
                 "the hosts that hold them (torchrun on each)")
    from repro_torch.testing.spawn import spawn_ranks

    try:
        spawn_ranks(_rank_main, ranks, args, shape, axes, device.type, said, backend=backend)
    except Exception as e:  # a rank failed: exit non-zero with its error
        sys.exit(f"{_PROG}: --mesh {name}: {type(e).__name__}: {str(e).strip()[-2000:]}")

if __name__ == "__main__":
    main()
