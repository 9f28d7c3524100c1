#!/usr/bin/env python3
"""The gram residual of the blocked QR at bf16 / f16 tiles (f32 sums) under
the fused and the tree schedule, through the CUDA kernels and through their
plain versions, on the card.

    python3 tools/mixed_gram.py [--sizes 1024,2048,4096] [--plain-max 4096] [--accum tile]

For each size n it factors the leading n x n block of phase 5's matrix of
``chip_smoke.py`` (f32 Gaussian, drawn as phase 5 draws it) with
``ggr_qr_blocked(precision="bf16" / "mixed_f16")`` under each schedule, and
prints ``||A^T A - R^T R||_F / ||A^T A||_F`` (in f64).  Then, up to
``--plain-max``, the same factorization with the four kernels swapped for
their plain PyTorch versions at the same (tile, f32) pair, on the same card
tensors: the plain versions round where the JAX kernels round, so a gap
between the schedules that they show too is the algorithm's, not the
kernels'.  ``--accum tile`` reads the tree schedule alone (the fused one
does not take the pair on the card) at ``Precision(t, t, t)``, the tile
summed at its own width, beside ``Precision(t, "float32", t)``, and prints
their ratio: the reference's ``test_mixed_accumulation_beats_all_bf16``
asks 1.5x of it.  The card's name and power limit are printed first.
Imports nothing of the JAX package.
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
def plain_kernels(acc: str = "float32"):
    """The blocked schedules' four kernel calls routed to the plain versions
    at accumulation ``acc``."""
    from repro_torch.core import blocked
    from repro_torch.kernels import ggr_apply, ggr_panel, ggr_update

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
    ap.add_argument("--accum", choices=("float32", "tile"), default="float32",
                    help="tile: the tree QR summed at the tile's width beside f32 sums")
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
        if args.accum == "tile":
            narrow(A, A64, n <= args.plain_max)
            continue
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


def narrow(A, A64, plain: bool) -> None:
    """``--accum tile`` at one size: the tree QR's gram residual at (t, t)
    over (t, float32), t = bf16 and f16, through the kernels and, if
    ``plain``, through the plain versions."""
    from repro_torch.core import ggr_qr_blocked
    from repro_torch.kernels import Precision

    n = A.shape[0]
    for t in ("bfloat16", "float16"):
        for route in ("kernels", "plain") if plain else ("kernels",):
            res = {}
            for acc in (t, "float32"):
                ctx = plain_kernels(acc) if route == "plain" else contextlib.nullcontext()
                with ctx:
                    res[acc] = gram(A64, ggr_qr_blocked(A, schedule="tree",
                                                        precision=Precision(t, acc, t)))
            print(f"  {n}x{n} tree ({t}, {t}) {route}: gram residual {res[t]:.4e}, ({t}, "
                  f"float32) {res['float32']:.4e}, ratio {res[t] / res['float32']:.3f}",
                  flush=True)


if __name__ == "__main__":
    sys.exit(main())
