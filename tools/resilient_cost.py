#!/usr/bin/env python3
"""What the fault-tolerant dispatcher costs a fault-free serving flush, on
the card.

    python3 tools/resilient_cost.py [--pairs 12] [--operands numpy|card]

Serves ``chip_smoke.py``'s 8192-request mix (``make_workload(num=8192, n=32,
rows=8, nrhs=1)``, ``max_batch=8192``) through a plain and a resilient
server in alternating pairs (plain, resilient, resilient, plain, ...) after
one warm-up flush each, and prints each flush's req/s, each server's median
and their ratio.  ``--operands numpy`` submits
the mix as ``make_workload`` returns it (numpy operands, copied to the card
at submit, as ``chip_smoke.py`` phase 4); ``card`` submits tensors already
on the card (phase 7).  Then one traced flush of the plain and of the
resilient server: wall time, the device's busy time and its share; and, in
one untraced resilient flush, the host's time in the layer's own steps (the
pre-check, each attempt with its synchronization, the post-check).  The card's name and power limit are
printed first.  Imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=12,
                    help="alternating pairs of the two servers (default 12)")
    ap.add_argument("--operands", choices=["numpy", "card"], default="numpy")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("resilient_cost.py: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card.splitlines()[0])

    from repro_torch.convert import from_numpy
    from repro_torch.launch.serve_qr import QRServer, _submit_all, make_workload
    from repro_torch.serve import resilience

    reqs = make_workload(num=8192, n=32, rows=8, k=1, device="cuda")
    if args.operands == "card":
        reqs = from_numpy(reqs, "cuda")
    servers = {"plain": QRServer(device="cuda", max_batch=8192),
               "resilient": QRServer(device="cuda", max_batch=8192, resilient=True)}

    def flush(name: str) -> float:
        srv = servers[name]
        _submit_all(srv, reqs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = srv.flush()
        srv.drain()
        return served / (time.perf_counter() - t0)

    for name in servers:  # warm-up
        flush(name)
    names = list(servers)
    rates = {name: [] for name in names}
    for turn in range(args.pairs):
        order = names if turn % 2 == 0 else names[::-1]
        for name in order:
            rates[name].append(flush(name))
    print(f"operands: {args.operands}; {args.pairs} pairs, order alternating")
    med = {name: float(np.median(rates[name])) for name in names}
    for name in names:
        print(f"  {name}: median {med[name]:.1f} req/s "
              f"({', '.join(f'{r:.1f}' for r in rates[name])})")
    print(f"  resilient / plain medians: {med['resilient'] / med['plain']:.3f}")

    # one traced flush each: the device's busy share
    for name in ("plain", "resilient"):
        srv = servers[name]
        _submit_all(srv, reqs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            srv.flush()
            srv.drain()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if "CUDA" in str(e.device_type) and e.self_device_time_total > 0)
        print(f"  trace of one {name} flush: wall {wall_us / 1e3:.2f} ms, device busy "
              f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%)")
    # the layer's own steps in one untraced resilient flush, host clock: the
    # pre-check (its stacks and its one read), an attempt (the executor and
    # the synchronization), the post-check (its one read)
    targets = [(resilience, "_nonfinite_operands"),
               (resilience.ResilientDispatcher, "_execute"),
               (resilience.ResilientDispatcher, "_bad_lanes")]
    spent = {fn: [] for _, fn in targets}
    real = {fn: getattr(owner, fn) for owner, fn in targets}
    for owner, fn in targets:
        def timed(*a, _real=real[fn], _spent=spent[fn], **k):
            t0 = time.perf_counter()
            out = _real(*a, **k)
            _spent.append(time.perf_counter() - t0)
            return out

        setattr(owner, fn, timed)
    try:
        rate = flush("resilient")
    finally:
        for owner, fn in targets:
            setattr(owner, fn, real[fn])
    print(f"  one resilient flush, {rate:.1f} req/s: " + ", ".join(
        f"{fn} {sum(t) * 1e3:.2f} ms over {len(t)} calls" for fn, t in spent.items()))
    print(card.splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
