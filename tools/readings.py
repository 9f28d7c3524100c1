#!/usr/bin/env python3
"""How far each CUDA kernel lands from its plain version over many random
inputs, on the card: the readings behind ``kernel_check.REL`` and
``kernel_check.ROUNDING``.

    python3 tools/readings.py [--draws N] [--dtype bf16|f16|f32|f64]
    python3 tools/readings.py --case panel_factor:8x256x64 --draws 300
    python3 tools/readings.py --phase14 [--draws N]

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
``--dtype`` reads only the cases of one tile dtype (bf16 and f16 run with
f32 accumulation, on ``kernel_check.condition_``-ed data, against the
plain version at the same pair, max|err| / rms over the parts
``kernel_check.determined`` names); for those it also prints, part by part
(``kernel_check.parts``), the kernel's relative Frobenius error from the
exact result (the plain version in f64) over the plain version's, least
and most over the draws, and the same ratio for the f32 plain version
rounded once to the tile dtype (the control): its most over the draws
part by part, and over the draws the most of its least over the parts,
which ``ROUNDING``'s lower end must stay above; then the control's
max|err| / rms from the plain version, least over the draws, and the
draws in which the control passes ``KernelCase.compare`` (it must pass in
none).  ``--phase14`` records every (shape, pair) that phase 14 (a) and
(c) of ``chip_smoke.py`` launch (the serving mix stored in bf16 / f16,
the 4096^2 QR at both policies and schedules) and reads each as
``--dtype`` does over N draws: per kernel and tile dtype, the worst
max|err| / rms over its bound and the least and most error ratio.
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


DTYPES = {"bf16": "bfloat16", "f16": "float16", "f32": "float32", "f64": "float64"}


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
    ap.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                    help="read only the phase-3 cases of this tile dtype")
    ap.add_argument("--phase14", action="store_true",
                    help="read every (shape, pair) phase 14 launches")
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
    if args.phase14:
        return read_phase14(args.draws)
    for name, shape, param, dname, *data in chip_smoke.PHASE3:
        if args.dtype and dname != DTYPES[args.dtype]:
            continue
        dtype = getattr(torch, dname)
        rels, own, own_plain, worst, mixed = [], [], [], None, []
        for seed in range(1, args.draws + 1):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            case = chip_smoke.KernelCase(name, shape, param, dtype, gen, *data)
            case.compare(quiet=True)
            rels.append(case.rel)
            if case.mixed:
                mixed.append(mixed_reading(case))
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
        if mixed:
            print_mixed(mixed)
        if worst:
            kern, pl, seed, i, tile, rms64 = worst
            print(f"    farthest tile from f64: draw {seed}, tile {i} (kernel "
                  f"{kern:.2e}, plain f32 {pl:.2e}): "
                  f"{tile_note(tile, param, plain[name], rms64)}", flush=True)
    chip_smoke.FAILURES.clear()  # a reading over its bound is printed, not failed
    return 0


def mixed_reading(case) -> dict:
    """One draw of a mixed case: the kernel's and the control's error
    ratios, part by part, the control's max|err| / rms from the plain
    version and whether the control passed the comparison."""
    import chip_smoke
    from repro_torch.testing import kernel_check as kc

    plain = chip_smoke._as_outputs(case.plain())
    parts = lambda r: kc.parts(case.name, case.param, chip_smoke._as_outputs(r))  # noqa: E731
    refs, exact = parts(plain), parts(case.plain64())
    once = case.once()
    _, kern = kc.per_step(parts(case.kernel()), refs, exact)
    stepped, ctrl = kc.per_step(parts(once), refs, exact)
    once_rel = max(kc.rel_err(o, r) for o, r in zip(
        kc.determined(case.name, case.param, once), kc.determined(case.name, case.param, plain)))
    return {"kern": kern, "ctrl": ctrl, "once_rel": once_rel,
            "fooled": bool(ctrl) and stepped and once_rel <= case.rel_tol}


def print_mixed(readings: list) -> None:
    kern = [r["kern"] for r in readings]
    ctrl = [r["ctrl"] for r in readings]
    n = len(kern[0])
    if not n:
        print("    no part has enough entries to read its error ratio", flush=True)
        return
    fmt = lambda vs: ", ".join(f"{v:.3f}" for v in vs)  # noqa: E731
    print(f"    error ratio, kernel, part by part: least {fmt(min(k[j] for k in kern) for j in range(n))}"
          f", most {fmt(max(k[j] for k in kern) for j in range(n))}; control: most "
          f"{fmt(max(c[j] for c in ctrl) for j in range(n))}, the most over the draws of "
          f"its least part {max(min(c) for c in ctrl):.3f}; control max|err| / rms "
          f"least {min(r['once_rel'] for r in readings):.2e}; the control passes in "
          f"{sum(r['fooled'] for r in readings)} of {len(readings)} draws", flush=True)


def read_phase14(draws: int) -> int:
    """``--phase14``: every (shape, pair) phase 14 (a) and (c) launch."""
    import torch

    import chip_smoke
    from repro_torch.core import ggr_qr_blocked
    from repro_torch.launch.serve_qr import QRServer, _submit_all, make_workload
    from repro_torch.testing import kernel_check as kc

    kernels = chip_smoke._kernel_fns()
    chip_smoke._zero_counts(kernels)
    reqs = make_workload(num=8192, n=32, rows=8, k=1, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)  # phase 5's M
    for shape in ((8192, 1024), (8192, 4)):
        torch.randn(shape, generator=g, device="cuda")
    M = torch.randn((4096, 4096), generator=g, device="cuda")
    for dname, pol in chip_smoke.MIXED_POLICY.items():
        srv = QRServer(device="cuda", max_batch=chip_smoke.SERVE_MAX_BATCH, precision=pol)
        _submit_all(srv, chip_smoke.stored_mix(reqs, getattr(torch, dname)))
        srv.flush()
        srv.drain()
        for sched in ("fused", "tree"):
            ggr_qr_blocked(M, schedule=sched, precision=kc.POLICY[dname])
    _, shapes = chip_smoke._counts(kernels)
    for name, recs in shapes.items():
        for dname in chip_smoke.MIXED:
            worst_rel, lo, hi, n_read, n_all = 0.0, float("inf"), 0.0, 0, 0
            for shape, param, dtype, accum in sorted(recs, key=str):
                if str(dtype) != f"torch.{dname}":
                    continue
                n_all += 1
                for seed in range(1, draws + 1):
                    case = chip_smoke.KernelCase(
                        name, shape, param, dtype,
                        torch.Generator(device="cuda").manual_seed(seed), accum=accum)
                    case.compare(quiet=True)
                    worst_rel = max(worst_rel, case.rel / case.rel_tol)
                    if case.ratios:
                        n_read += 1
                        lo, hi = min(lo, *case.ratios), max(hi, *case.ratios)
            print(f"  {name} {dname}: {n_all} shapes x {draws} draws; worst max|err| / rms "
                  f"{worst_rel:.2f} of its bound; error ratios over the {n_read} draws "
                  f"with a part to read: least {lo:.3f}, most {hi:.3f}", flush=True)
    chip_smoke.FAILURES.clear()
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
