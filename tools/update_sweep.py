#!/usr/bin/env python3
"""Time the row-append kernel (B1, ``batched_update``) under each thread
layout at the main path's shapes, on the card.

    python3 tools/update_sweep.py          # from the root of a checkout
    python3 tools/update_sweep.py --public [--src DIR]

A layout is (G, PB, ws, nbuf): G threads per problem, PB problems per block,
the row stride and the pivot buffers (``ggr_update._update_layout``).  For
each shape the sweep launches the kernel through its C entry point at every
G in 32, 64, 128, 192, 256, 512 and every PB in 1, 2, 4, 8, 16 that the
kernel takes and that fits shared memory, with the rule's ws and nbuf.  Each
layout is held against the plain version (max|err| / rms(out) within
``kernel_check.rel_bound``) and timed with CUDA events (mean of 10 launches
after 2); each line names the layout, marks the rule's, and gives its time.
The card's name and power limit are printed first.  Imports nothing of the
JAX package.

``--public`` times only ``batched_update`` as it stands (its own layout) at
the same shapes and on the tree's coupling data (``COUPLING``), and ``--src
DIR`` imports ``repro_torch`` from another checkout's ``src``: so one call
can time two commits at shapes the older one's ``chip_smoke.py`` does not
run.

``--mixed-nbuf`` times the bf16 / f16 instances (f32 sums) at the main
path's three shapes under the rule's layout, whose two pivot buffers fill
the next pivot row through registers, and under the layout the rule gives
with one buffer (each pivot row loaded at the start of its step), in the
order rule, one, one, rule, three times over; each layout held against the
plain version as above, on ``kernel_check.condition_``-ed data.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = [  # (B, m, w, n_piv, dtype name): serving append, kalman, tree rounds
    (8192, 40, 33, 32, "float32"), (8192, 104, 65, 64, "float32"),
    (64, 128, 192, 64, "float32"), (32, 128, 192, 64, "float32"),
    (1, 128, 192, 64, "float32"), (64, 128, 192, 64, "float64"),
]
# --public also times the tree's coupling data at its first and last rounds:
# [R_a | I | 0; R_b | 0 | I] of R factors of random 64 x 64 tiles, whose
# columns are zero below each R's diagonal (random data has no zeros)
COUPLING = [(32, 128, 192, 64, "float32"), (1, 128, 192, 64, "float32")]
# --mixed-nbuf: the serving append and kalman shapes and the tree coupling
MIXED_NBUF = [(8192, 40, 33, 32), (8192, 104, 65, 64), (64, 128, 192, 64)]
GROUP_THREADS = (32, 64, 128, 192, 256, 512)
PROBLEMS_PER_BLOCK = (1, 2, 4, 8, 16)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--public", action="store_true",
                    help="time batched_update as it stands, no layout sweep")
    ap.add_argument("--mixed-nbuf", action="store_true",
                    help="time the bf16 / f16 instances with two pivot buffers and one")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory to import repro_torch from")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("update_sweep.py: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import cuda_ms
    from repro_torch.testing.kernel_check import rel_bound
    from repro_torch.kernels import _cuda, ggr_update

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.mixed_nbuf:
        return mixed_nbuf(gen)
    failed = 0
    cases = [(*s, False) for s in SHAPES]
    if args.public:
        cases += [(*s, True) for s in COUPLING]
    for B, m, w, n_piv, dname, coupling in cases:
        dtype = getattr(torch, dname)
        if coupling:
            b = n_piv
            R = torch.linalg.qr(torch.randn((2 * B, b, b), generator=gen,
                                            device="cuda", dtype=dtype)).R
            E = torch.eye(b, device="cuda", dtype=dtype).expand(B, b, b)
            Z = torch.zeros_like(E)
            x = torch.cat([torch.cat([R[:B], E, Z], 2),
                           torch.cat([R[B:], Z, E], 2)], 1).contiguous()
        else:
            x = torch.randn((B, m, w), generator=gen, device="cuda", dtype=dtype)
            x[:, :n_piv, :n_piv] = torch.triu(x[:, :n_piv, :n_piv])
        ref = ggr_update.batched_update_plain(x, n_piv)
        rms = float(ref.double().square().mean().sqrt())
        bound = rel_bound("batched_update", m, w, dname)
        if args.public:
            def run():
                return ggr_update.batched_update(x, n_piv)

            rel = float((run() - ref).abs().max()) / rms
            failed += not rel <= bound
            ms = cuda_ms(run, reps=10, warmup=2)
            data = " coupling data" if coupling else ""
            print(f"  ({B}, {m}, {w}) n_piv {n_piv} {dname}{data}: batched_update "
                  f"{ms:.4f} ms, rel err {rel:.2e} ({args.src})", flush=True)
            continue
        rule = ggr_update._update_layout(m, w, n_piv, x.element_size())
        _, _, ws, nbuf = rule
        group = ggr_update._smem_elems(m - n_piv + 1, ws, nbuf) * x.element_size()
        for G in GROUP_THREADS:
            for PB in PROBLEMS_PER_BLOCK:
                if (G * PB > ggr_update._KERNEL_THREADS or PB * group > _cuda.MAX_SMEM_BYTES
                        or PB > (32 if G == 32 else ggr_update._NAMED_BARRIERS)):
                    continue
                lay = (G, PB, ws, nbuf)
                out = torch.empty_like(x)

                def run(lay=lay, out=out):
                    _cuda.launch("ggr_update", "ggr_batched_update", [x, out],
                                 B, m, w, n_piv, *lay)
                    return out

                rel = float((run() - ref).abs().max()) / rms
                ok = rel <= bound
                failed += not ok
                ms = cuda_ms(run, reps=10, warmup=2)
                mark = " (the rule's)" if lay == rule else ""
                print(f"  ({B}, {m}, {w}) n_piv {n_piv} {dname}: layout {lay}{mark} "
                      f"{ms:.4f} ms, rel err {rel:.2e}{'' if ok else ' FAIL'}",
                      flush=True)
    return 1 if failed else 0


def mixed_nbuf(gen) -> int:
    """``--mixed-nbuf``: the rule's layout against its one-buffer twin."""
    import torch

    from chip_smoke import cuda_ms
    from repro_torch.kernels import _cuda, ggr_update
    from repro_torch.testing.kernel_check import condition_, rel_bound

    failed = 0
    for dname in ("bfloat16", "float16"):
        for B, m, w, n_piv in MIXED_NBUF:
            x = condition_(torch.randn((B, m, w), generator=gen, device="cuda",
                                       dtype=getattr(torch, dname)), "batched_update", n_piv)
            ref = ggr_update.batched_update_plain(x, n_piv, "float32")
            rms = float(ref.double().square().mean().sqrt())
            rule = ggr_update._update_layout(m, w, n_piv, 4)  # shared memory holds f32
            G = rule[0]
            elems = ggr_update._smem_elems(m - n_piv + 1, w, 1) * 4
            one = (G, min(max(1, ggr_update._BLOCK_THREADS // G), _cuda.MAX_SMEM_BYTES // elems,
                          32 if G == 32 else ggr_update._NAMED_BARRIERS), w, 1)
            times = {rule: [], one: []}
            for _ in range(3):
                for lay in (rule, one, one, rule):
                    out = torch.empty_like(x)

                    def run(lay=lay, out=out):
                        _cuda.launch("ggr_update", "ggr_batched_update", [x, out],
                                     B, m, w, n_piv, *lay, accum="float32")
                        return out

                    rel = float((run().double() - ref.double()).abs().max()) / rms
                    failed += not rel <= rel_bound("batched_update", m, w, dname)
                    times[lay].append(cuda_ms(run, reps=20, warmup=2))
            print(f"  ({B}, {m}, {w}) n_piv {n_piv} {dname}/float32: "
                  + "; ".join(f"layout {lay}{' (the rule)' if lay == rule else ''} "
                              + ", ".join(f"{t:.4f}" for t in ts) + " ms"
                              for lay, ts in times.items()), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
