#!/usr/bin/env python3
"""The gram residual of the blocked QR at bf16 / f16 tiles (f32 sums) under
the fused and the tree schedule, through the CUDA kernels and through their
plain versions, on the card.

    python3 tools/mixed_gram.py [--sizes 1024,2048,4096] [--plain-max 4096]

For each size n it factors the leading n x n block of phase 5's matrix of
``chip_smoke.py`` (f32 Gaussian, drawn as phase 5 draws it) with
``ggr_qr_blocked(precision="bf16" / "mixed_f16")`` under each schedule, and
prints ``||A^T A - R^T R||_F / ||A^T A||_F`` (in f64).  Then, up to
``--plain-max``, the same factorization with the four kernels swapped for
their plain PyTorch versions at the same (tile, f32) pair, on the same card
tensors: the plain versions round where the JAX kernels round, so a gap
between the schedules that they show too is the algorithm's, not the
kernels'.  The card's name and power limit are printed first.  Imports
nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


@contextlib.contextmanager
def plain_kernels():
    """The blocked schedules' four kernel calls routed to the plain versions
    at f32 accumulation."""
    from repro_torch.core import blocked
    from repro_torch.kernels import ggr_apply, ggr_panel, ggr_update

    acc = "float32"

    def geqrt(tiles, n_pivots, **_):
        return ggr_panel.batched_geqrt_plain(tiles, n_pivots, acc)

    def update(stacked, n_pivots, **_):
        return ggr_update.batched_update_plain(stacked, n_pivots, acc)

    def panel(p, pivot0=0, **_):
        return ggr_panel.panel_factor_plain(p, pivot0, acc)

    def apply(V, T, C, pivot0=0, out=None, **_):
        res = ggr_apply.apply_factors_plain(V, T, C, pivot0, acc)
        if out is not None:
            out.copy_(res)
            return out
        return res

    saved = (blocked.batched_geqrt, blocked.batched_update, blocked.panel_factor,
             blocked.apply_factors)
    blocked.batched_geqrt, blocked.batched_update = geqrt, update
    blocked.panel_factor, blocked.apply_factors = panel, apply
    try:
        yield
    finally:
        (blocked.batched_geqrt, blocked.batched_update, blocked.panel_factor,
         blocked.apply_factors) = saved


def gram(A64, R) -> float:
    import torch

    R64 = torch.triu(R.double())
    AtA = A64.T @ A64
    return float(torch.linalg.norm(AtA - R64.T @ R64) / torch.linalg.norm(AtA))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="1024,2048,4096")
    ap.add_argument("--plain-max", type=int, default=4096)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("mixed_gram.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import ggr_qr_blocked

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)  # phase 5: A, b, then M
    for shape in ((8192, 1024), (8192, 4)):
        torch.randn(shape, generator=g, device="cuda")
    M = torch.randn((4096, 4096), generator=g, device="cuda")
    for n in (int(v) for v in args.sizes.split(",")):
        A = M[:n, :n].contiguous()
        A64 = A.double()
        for pol in ("bf16", "mixed_f16"):
            for route in ("kernels", "plain"):
                if route == "plain" and n > args.plain_max:
                    continue
                ctx = plain_kernels() if route == "plain" else contextlib.nullcontext()
                with ctx:
                    res = {s: gram(A64, ggr_qr_blocked(A, schedule=s, precision=pol))
                           for s in ("fused", "tree")}
                print(f"  {n}x{n} precision={pol!r} {route}: gram residual fused "
                      f"{res['fused']:.3e}, tree {res['tree']:.3e} (tree / fused "
                      f"{res['tree'] / res['fused']:.2f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
