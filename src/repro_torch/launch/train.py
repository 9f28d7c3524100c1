"""Training launcher, one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --steps 20 \\
        --optimizer orthant                                   # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \\
        --device cpu --steps 3 --seq-len 16 --global-batch 2

The JAX package's ``launch/train.py`` flags, plus ``--device`` (default: the
card; with no CUDA device the default exits non-zero).  ``--mesh 1x1`` (the
default) is one device; any other mesh, ``prod`` and ``prod2`` need the mesh
half of the training stack, which is not ported (ROADMAP A9), and exit
non-zero.  The first step is a warm-up; prints the time a step and tokens a
second over the steps after it, on the card the peak memory allocated, then
the reference's ``done: N steps, final loss X`` line.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.serve.dispatch import resolve_device
from repro_torch.train import Trainer


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
    ap.add_argument("--mesh", default="1x1",
                    help="'1x1' (one device); other meshes are not ported (ROADMAP A9)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compression", default=None, choices=[None, "int8_ef"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="training device (default: the card)")
    args = ap.parse_args(argv)
    if args.steps < 2:
        ap.error("--steps must be at least 2 (the first step is a warm-up)")
    if args.mesh != "1x1":
        sys.exit(f"repro_torch.launch.train: --mesh {args.mesh} needs the mesh half of "
                 "the training stack, which is not ported yet (ROADMAP A9); "
                 "--mesh 1x1 trains on one device")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"repro_torch.launch.train: {e}")
    on_card = device.type == "cuda"

    cfg = get_config(args.arch, smoke=args.smoke)
    try:
        tr = Trainer(cfg, optimizer=args.optimizer, lr=args.lr, seq_len=args.seq_len,
                     global_batch=args.global_batch, accum=args.accum,
                     ckpt_dir=args.ckpt_dir, grad_compression=args.grad_compression,
                     device=device)
    except NotImplementedError as e:
        sys.exit(f"repro_torch.launch.train: {e}")
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
        print(f"{args.arch}: {dt / n:.4f} s/step, "
              f"{n * args.global_batch * args.seq_len / dt:.1f} tok/s "
              f"(batch {args.global_batch} x {args.seq_len}, {args.optimizer}, {name})")
    if on_card:
        print(f"{args.arch}: peak memory allocated "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    print(f"done: {args.steps} steps, final loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
