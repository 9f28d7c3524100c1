#!/usr/bin/env python3
"""Time the tile GEQRT kernel (B2, ``batched_geqrt``) under each thread
layout at the main path's shapes, on the card.

    python3 tools/geqrt_sweep.py          # from the root of a checkout
    python3 tools/geqrt_sweep.py --public [--src DIR]

A layout is (G, ws): G threads a tile (one block), each walking whole
columns, and the row stride in shared memory (``ggr_panel._geqrt_layout``).
For each shape the sweep launches the kernel through its C entry point at
every G in 32, 64, 128, 256, 512, with the rule's ws.  Each layout is held
against the plain version (max|err| / rms(out) within
``kernel_check.rel_bound``) and timed with CUDA events (mean of 10 launches
after 2); each line names the layout, marks the rule's, and gives its time.
The shapes are the tree QR's level-0 launches on random tiles and on the
tree's own tiles (``chip_smoke.tree_tiles``: [pan | I], half of them
[0 | I]).  The card's name and power limit are printed first.  Imports
nothing of the JAX package.

``--public`` times only ``batched_geqrt`` as it stands (its own layout) at
the same shapes, and ``--src DIR`` imports ``repro_torch`` from another
checkout's ``src``: so one call can time two commits at shapes the older
one's ``chip_smoke.py`` does not run.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = [  # (B, t, w, n_piv, dtype name, data)
    (128, 64, 128, 64, "float32", "random"), (128, 64, 128, 64, "float64", "random"),
    (64, 64, 128, 64, "float32", "tree"), (2, 64, 128, 64, "float32", "tree"),
    (64, 64, 128, 64, "float64", "tree"),
]
THREADS = (32, 64, 128, 256, 512)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--public", action="store_true",
                    help="time batched_geqrt as it stands, no layout sweep")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory to import repro_torch from")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("geqrt_sweep.py: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import cuda_ms, tree_tiles
    from repro_torch.testing.kernel_check import rel_bound
    from repro_torch.kernels import _cuda, ggr_panel

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = 0
    for B, t, w, n_piv, dname, data in SHAPES:
        dtype = getattr(torch, dname)
        if data == "tree":
            x = tree_tiles(B, t, gen, dtype)
        else:
            x = torch.randn((B, t, w), generator=gen, device="cuda", dtype=dtype)
        ref = ggr_panel.batched_geqrt_plain(x, n_piv)
        rms = float(ref.double().square().mean().sqrt())
        bound = rel_bound("batched_geqrt", t, w, dname)
        label = f"({B}, {t}, {w}) n_piv {n_piv} {dname} {data}"
        if args.public:
            def run():
                return ggr_panel.batched_geqrt(x, n_piv)

            rel = float((run() - ref).abs().max()) / rms
            failed += not rel <= bound
            ms = cuda_ms(run, reps=10, warmup=2)
            print(f"  {label}: batched_geqrt {ms:.4f} ms, rel err {rel:.2e} "
                  f"({args.src})", flush=True)
            continue
        rule = ggr_panel._geqrt_layout(t, w, x.element_size())
        for G in THREADS:
            lay = (G, rule[1])
            out = torch.empty_like(x)

            def run(lay=lay, out=out):
                _cuda.launch("ggr_panel", "ggr_batched_geqrt", [x, out],
                             B, t, w, n_piv, *lay)
                return out

            rel = float((run() - ref).abs().max()) / rms
            ok = rel <= bound
            failed += not ok
            ms = cuda_ms(run, reps=10, warmup=2)
            mark = " (the rule's)" if lay == rule else ""
            print(f"  {label}: layout {lay}{mark} {ms:.4f} ms, rel err "
                  f"{rel:.2e}{'' if ok else ' FAIL'}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
