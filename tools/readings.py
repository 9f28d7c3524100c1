#!/usr/bin/env python3
"""How far each CUDA kernel lands from its plain version over many random
inputs, on the card: the readings behind ``chip_smoke.rel_bound``.

    python3 tools/readings.py [--draws N]      # from the root of a checkout
    python3 tools/readings.py --case panel_factor:8x256x64 --draws 300

For every phase-3 case of ``chip_smoke.py`` (kernel, shape, dtype) it draws
N fresh inputs (generator seeds 1..N) and prints the worst and the median of
max|err| / rms(out) over the draws, beside the case's bound.  For
batched_update and batched_geqrt in f32 it also prints how far the kernel
and the f32 plain version each land from the plain version run in f64 on
the same inputs (whether a reading is the kernel's rounding or both's), and
for batched_geqrt the tile it lands farthest from f64 on: its draw and
index, the condition number of its pivot columns, its smallest pivot that
sets a rotation (|R[c, c]| over the 2-norm of the pivot columns, c before
the last row), both f32 readings on that tile, and how far the f64 result
moves when that tile moves by f32's rounding (2^-24 relative, worst of 3).
``--case NAME:BxMxW[:PARAM]`` reads one f32 case instead (PARAM: the
pivot count, pivot0, or b,pivot0 for apply_factors; default 0): over N
draws, each output's max|err| / rms against the plain version run in f64,
for the kernel and for the f32 plain version, as median / 90th percentile /
worst and the draws over the case's bound — the distributions
``KernelCase.against_draws`` compares.  Imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def tile_note(tile, n_piv: int, plain, rms64: float) -> str:
    """What sets the f32 error on one (t, w) tile: its conditioning."""
    import torch

    x = tile.double()[None]
    ref = plain(x, n_piv)
    A = x[0, :, :n_piv]
    steps = min(n_piv, A.shape[0])
    pivots = ref[0].diagonal()[:steps - 1].abs() / torch.linalg.matrix_norm(A, ord=2)
    c = int(pivots.argmin()) if steps > 1 else 0
    gen = torch.Generator(device=x.device).manual_seed(0)
    moved = max(float((plain(x * (1 + 2.0 ** -24 * torch.randn(
        x.shape, generator=gen, device=x.device, dtype=x.dtype)), n_piv) - ref).abs().max())
        for _ in range(3)) / rms64
    small = f"{float(pivots[c]):.2e} at c = {c}" if steps > 1 else "none"
    return (f"cond {float(torch.linalg.cond(A)):.2e}, smallest rotating pivot "
            f"{small}, f64 result moves {moved:.2e} under a 2^-24 input move")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=8)
    ap.add_argument("--case", default=None, help="NAME:BxMxW[:PARAM], one f32 case")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("readings.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import ggr_panel, ggr_update

    plain = {"batched_update": ggr_update.batched_update_plain,
             "batched_geqrt": ggr_panel.batched_geqrt_plain}

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    if args.case:
        return read_case(args.case, args.draws)
    for name, shape, param, dname, *data in chip_smoke.PHASE3:
        dtype = getattr(torch, dname)
        rels, own, own_plain, worst = [], [], [], None
        for seed in range(1, args.draws + 1):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            case = chip_smoke.KernelCase(name, shape, param, dtype, gen, *data)
            case.compare(quiet=True)
            rels.append(case.rel)
            if name in plain and dtype == torch.float32:
                ref64 = plain[name](case.x.double(), param)
                rms64 = float(ref64.square().mean().sqrt())
                err = (case.kernel().double() - ref64).abs()
                err_plain = (case.plain().double() - ref64).abs()
                own.append(float(err.max()) / rms64)
                own_plain.append(float(err_plain.max()) / rms64)
                i = int(err.amax((1, 2)).argmax())
                if name == "batched_geqrt" and (worst is None or own[-1] > worst[0]):
                    worst = (own[-1], float(err_plain[i].max()) / rms64, seed, i,
                             case.x[i].clone(), rms64)
        f64 = (f"; vs f64: kernel worst {max(own):.2e}, plain f32 worst "
               f"{max(own_plain):.2e}" if own else "")
        print(f"  {case.label()}: max|err| / rms(out) worst {max(rels):.2e}, median "
              f"{statistics.median(rels):.2e} over {args.draws} draws; bound "
              f"{case.rel_tol:.1e}{f64}", flush=True)
        if worst:
            kern, pl, seed, i, tile, rms64 = worst
            print(f"    farthest tile from f64: draw {seed}, tile {i} (kernel "
                  f"{kern:.2e}, plain f32 {pl:.2e}): "
                  f"{tile_note(tile, param, plain[name], rms64)}", flush=True)
    chip_smoke.FAILURES.clear()  # a reading over its bound is printed, not failed
    return 0


def read_case(spec: str, draws: int) -> int:
    """``--case``: one f32 case's kernel and f32 plain readings against f64."""
    import torch

    import chip_smoke

    name, dims, *rest = spec.split(":")
    shape = tuple(int(v) for v in dims.split("x"))
    param = tuple(int(v) for v in rest[0].split(",")) if rest else 0
    param = param[0] if isinstance(param, tuple) and len(param) == 1 else param
    if name == "apply_factors" and not rest:
        param = (64, 0)
    kern, plain = [], []
    for seed in range(1, draws + 1):
        case = chip_smoke.KernelCase(name, shape, param, torch.float32,
                                     torch.Generator(device="cuda").manual_seed(seed))
        outs, refs, ref64 = (chip_smoke._as_outputs(f()) for f in (case.kernel, case.plain,
                                                                   case.plain64))
        rms = [float(r.square().mean().sqrt()) or 1.0 for r in ref64]
        kern.append([float((o.double() - r).abs().max()) / m for o, r, m in zip(outs, ref64, rms)])
        plain.append([float((o.double() - r).abs().max()) / m for o, r, m in zip(refs, ref64, rms)])
    kern, plain = torch.tensor(kern).double(), torch.tensor(plain).double()
    qs = torch.tensor([0.5, 0.9, 1.0], dtype=torch.float64)
    print(f"  {case.label()} over {draws} draws, against the f64 plain version; bound "
          f"{case.rel_tol:.1e}")
    for j in range(kern.shape[1]):
        for who, t in (("kernel", kern[:, j]), ("f32 plain", plain[:, j])):
            q = torch.quantile(t, qs)
            print(f"    output {j} {who}: median {q[0]:.2e}, q90 {q[1]:.2e}, worst {q[2]:.2e}; "
                  f"{int((t > case.rel_tol).sum())} of {draws} draws over the bound")
    ok, note = case.against_draws()
    print(f"    against_draws: {'holds' if ok else 'fails'}{note}")
    chip_smoke.FAILURES.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
