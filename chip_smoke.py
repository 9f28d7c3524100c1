#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``), one H100.

    python3 chip_smoke.py          # from the root of a checkout

Drives the port's main path on the card and checks it, phase by phase:

1. card check — a CUDA device is present; prints the card's name and power
   limit (``nvidia-smi``); float32 matmuls must not run in TF32;
2. build — compiles every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together) into ``build/kernels`` and
   prints each one's ``-Xptxas -v`` report;
3. kernels — each of the four kernels (batched_update, batched_geqrt,
   panel_factor, apply_factors) against its plain PyTorch version on the card
   at the main path's shapes, each output (panel_factor: each of R, V and T)
   within rel_bound() of its rms, plus an all-zero batch that must come
   back bitwise zero; batched_geqrt also on the tree schedule's own
   [pan | I] tiles, whose [0 | I] tiles must come back bitwise as they were;
   prints the layout of batched_update and batched_geqrt; times kernel,
   plain version and the library call that computes the same function (for
   apply_factors ``torch.ormqr`` with ``torch.geqrf``'s factors of the same
   panel: the same work in Householder's basis, timed only); panel_factor
   and apply_factors also run at a 65536-row frame;
4. serving — ``QRServer(device="cuda")`` serves an 8192-request mix of all
   four kinds: a warm-up flush, then a timed one (req/s), cross-checked on a
   sample against the plain ``"reference"`` backend;
5. dense — ``ggr_lstsq`` on an (8192, 1024) f32 system against
   ``torch.linalg.lstsq`` in f64, through the blocked tree schedule (under
   ``degraded_mode(schedule="tree")``) and through ``"auto"``, which is the
   fused schedule on the card; ``ggr_qr_blocked`` of a 4096 x 4096 f32
   matrix with each schedule named, with ``"auto"`` and through
   ``ggr_qr_pallas`` (panel 32) against ``torch.linalg.qr``; traces of both
   schedules' QR and of the tree lstsq, and the times of every route beside
   the library calls;
6. every (shape, dtype) the kernels were launched at by phases 4-5 is held
   against the plain version once more;
7. a JSON line of per-kernel numbers, then the last line
   ``{"ok": true, "device": {...}}``.

Launch counts are set to 0 just before the serving run and the dense run and
read just after; a route that does not launch its kernels fails the run.  Any
failed check exits non-zero without printing the last line.  The script
imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 3.35 TB/s,
# 67 TFLOP/s f32 and 34 TFLOP/s f64 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# kernel vs plain version, each output on its own: its worst error over its
# rms (so that one wrong row of a tall output shows) within rel_bound(), a
# per-kernel, per-dtype constant (f32, f64) a few times the worst reading over
# random inputs (tools/readings.py; PERF.md §6), grown where rounding grows
# with the shape: the rows of a problem (B1, B2), the column steps an entry
# sees (B3) or the square root of the rows a suffix dot runs over (B4)
REL = {"batched_update": (7.5e-4, 1e-12), "batched_geqrt": (1e-3, 3e-12),
       "panel_factor": (3e-4, 3e-12), "apply_factors": (2e-4, 3e-13)}


def rel_bound(name: str, shape, dtype_name: str) -> float:
    _, m, w = shape
    grow = {"batched_update": m / 64, "batched_geqrt": m / 64,
            "panel_factor": w / 64, "apply_factors": (m / 4096) ** 0.5}[name]
    return REL[name][dtype_name == "float64"] * max(1.0, grow)


# the rule B1, B2 and B4 were held to before: 5e-5 f32 / 1e-11 f64 x
# max(1, rows // 16) x max(1, max|out|), printed beside the new one
OLD_TOL = {"float32": 5e-5, "float64": 1e-11}
# phase 3: (kernel, shape, param, dtype[, data]) at the main path's shapes;
# data is "random" (randn) unless named: "tree" is batched_geqrt's tiles as
# the tree schedule builds them (tree_tiles)
PHASE3 = [
    ("batched_update", (8192, 40, 33), 32, "float32"),    # serving append
    ("batched_update", (8192, 104, 65), 64, "float32"),   # serving kalman
    ("batched_update", (64, 128, 192), 64, "float32"),    # tree coupling
    ("batched_update", (64, 128, 192), 64, "float64"),
    # the first and last coupling rounds of the tree's 4096^2 QR
    ("batched_update", (32, 128, 192), 64, "float32"),
    ("batched_update", (1, 128, 192), 64, "float32"),
    ("batched_geqrt", (128, 64, 128), 64, "float32"),     # tree level 0
    ("batched_geqrt", (128, 64, 128), 64, "float64"),
    # the tree QR's level-0 launches: its first panel (64 tiles) and its last
    # (2 tiles), on random tiles and on the tree's own tiles
    ("batched_geqrt", (64, 64, 128), 64, "float32"),
    ("batched_geqrt", (64, 64, 128), 64, "float32", "tree"),
    ("batched_geqrt", (2, 64, 128), 64, "float32"),
    ("batched_geqrt", (2, 64, 128), 64, "float32", "tree"),
    ("panel_factor", (1, 4096, 64), 0, "float32"),        # fused QR frame
    ("panel_factor", (1, 8192, 64), 0, "float32"),        # fused lstsq frame
    ("panel_factor", (1, 4096, 64), 0, "float64"),
    ("panel_factor", (1, 4096, 32), 1024, "float32"),     # ggr_qr_pallas
    ("panel_factor", (1, 65536, 64), 0, "float32"),       # a 16 MiB frame
    ("apply_factors", (1, 4096, 4032), (64, 0), "float32"),  # fused QR
    ("apply_factors", (1, 8192, 964), (64, 0), "float32"),   # fused lstsq
    ("apply_factors", (1, 4096, 1024), (64, 0), "float64"),
    ("apply_factors", (1, 4096, 2048), (32, 2048), "float32"),  # ggr_qr_pallas
    # a frame too tall for one column of it in shared memory
    ("apply_factors", (1, 65536, 128), (64, 0), "float32"),
]
SERVE_MAX_BATCH = 8192  # each request group of the 8192-request mix is one chunk
FAILURES: list[str] = []


def check(ok: bool, what: str, quiet: bool = False) -> None:
    if not (ok and quiet):
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        FAILURES.append(what)


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ----------------------------------------------------------- kernel models
def _itemsize(dtype_name: str) -> int:
    return 4 if dtype_name == "float32" else 8


def _sweep_flops(rows: int, cols: int) -> int:
    """One column step: the coefficient chain (~8 per active row), the pivot
    row's division (1 per swept column) and the DET2 sweep (5 per active
    element of the swept columns)."""
    return 5 * rows * cols + cols + 8 * rows


def update_flops(shape, n_piv: int) -> float:
    """Operations the row-append sweep needs on these inputs.  Column c has
    p+1 active rows; columns j < c of those rows are already zero and column
    c is written as constants, so only the w-c-1 columns right of it are
    swept."""
    B, m, w = shape
    a = m - n_piv + 1
    return float(B * sum(_sweep_flops(a, w - c - 1) for c in range(n_piv)))


def geqrt_flops(shape, n_piv: int) -> float:
    """Operations the GEQRT sweep needs: column c sweeps its t-c active rows
    over the w-c-1 columns right of it (the rest are zero or constants)."""
    B, t, w = shape
    return float(B * sum(_sweep_flops(t - c, w - c - 1)
                         for c in range(min(n_piv, t))))


def panel_flops(shape, pivot0: int) -> float:
    """Operations the fused panel factorization needs: column c sweeps its
    m - p active rows (p = pivot0 + c) over the b-c-1 columns right of it."""
    B, m, b = shape
    return float(B * sum(_sweep_flops(m - pivot0 - c, b - c - 1)
                         for c in range(b) if pivot0 + c < m))


def apply_flops(shape, b: int, pivot0: int) -> float:
    """Operations the trailing apply needs: step c sweeps the m - p active
    rows of all w columns at ~5 flops per element (the coefficients, ~8 per
    row, are shared by all columns)."""
    B, m, w = shape
    return float(B * sum(5 * (m - pivot0 - c) * w + 8 * (m - pivot0 - c)
                         for c in range(b) if pivot0 + c < m))


def tree_tiles(B: int, b: int, gen, dtype):
    """(B, b, 2b) tiles as the tree schedule hands them to batched_geqrt at
    a panel past its first: [pan | I], the second half [0 | I] (row tiles
    past the matrix, zero in the panel's columns)."""
    import torch

    pan = torch.randn((B, b, b), generator=gen, device="cuda", dtype=dtype)
    pan[B // 2:] = 0
    eye = torch.eye(b, device="cuda", dtype=dtype).expand(B, b, b)
    return torch.cat([pan, eye], 2).contiguous()


def bound(nbytes: float, dtype_name: str, flops: float):
    """(bound_ms, bound_by): the bytes the function must move (each input
    read once, each output written once) over HBM bandwidth, vs the
    operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class KernelCase:
    """One kernel at one shape: inputs, kernel, plain version, library call.

    ``param`` is ``n_piv`` for batched_update / batched_geqrt, ``pivot0`` for
    panel_factor (shape (B, m, b)) and ``(b, pivot0)`` for apply_factors
    (shape of C, (B, m, w))."""

    def __init__(self, name, shape, param, dtype, gen, data="random"):
        import torch

        from repro_torch.kernels import ggr_apply, ggr_panel, ggr_update

        self.name, self.shape, self.param, self.dtype = name, shape, param, dtype
        self.data = data
        self.note = ""
        self.fixed = None  # tiles that must come back bitwise as they were
        self.dname = str(dtype).removeprefix("torch.")
        size = _itemsize(self.dname)
        B, m, w = shape
        x = torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
        if name == "batched_update":
            n_piv = param
            # the kernel's contract: the top n_piv rows are upper triangular
            x[:, :n_piv, :n_piv] = torch.triu(x[:, :n_piv, :n_piv])
            self.fn = lambda z: ggr_update.batched_update(z, n_piv)
            self.plain = lambda: ggr_update.batched_update_plain(x, n_piv)
            # R of the stacked matrix (same top n_piv rows up to signs; at the
            # tree-coupling shape it also triangularizes the riding columns)
            self.library = lambda: torch.linalg.qr(x, mode="r")
            self.flops = update_flops(shape, n_piv)
            self.nbytes = 2.0 * B * m * w * size
            self.note = (", layout (G, PB, ws, nbuf) "
                         f"{ggr_update._update_layout(m, w, n_piv, size)}")
        elif name == "batched_geqrt":
            n_piv = param
            if data == "tree":
                x = tree_tiles(B, m, gen, dtype)
                self.fixed = slice(B // 2, B)
            self.fn = lambda z: ggr_panel.batched_geqrt(z, n_piv)
            self.plain = lambda: ggr_panel.batched_geqrt_plain(x, n_piv)
            # Q and R of the tile's pivot columns: [R | Qt] up to signs
            self.library = lambda: torch.linalg.qr(x[:, :, :n_piv])
            self.flops = geqrt_flops(shape, n_piv)
            self.nbytes = 2.0 * B * m * w * size
            self.note = f", layout (G, ws) {ggr_panel._geqrt_layout(m, w, size)}"
        elif name == "panel_factor":
            pivot0 = param
            self.fn = lambda z: ggr_panel.panel_factor(z, pivot0)
            self.plain = lambda: ggr_panel.panel_factor_plain(x, pivot0)
            # Householder QR of the same panel (Q and R)
            self.library = lambda: torch.linalg.qr(x)
            self.flops = panel_flops(shape, pivot0)
            self.nbytes = 4.0 * B * m * w * size  # panel in; R, V, T out
        else:  # apply_factors
            b, pivot0 = param
            pans = torch.randn((B, m, b), generator=gen, device="cuda", dtype=dtype)
            _, V, T = ggr_panel.panel_factor_plain(pans, pivot0)
            self.fn = lambda z: ggr_apply.apply_factors(V, T, z, pivot0)
            self.plain = lambda: ggr_apply.apply_factors_plain(V, T, x, pivot0)
            # the same work in Householder's basis: Q^T C from geqrf's factors
            a, tau = torch.geqrf(pans)
            self.library = lambda: torch.ormqr(a, tau, x, left=True, transpose=True)
            self.flops = apply_flops(shape, b, pivot0)
            self.nbytes = (2.0 * m * w + 2.0 * m * b) * B * size  # C in/out, V, T
        self.x = x
        self.kernel = lambda: self.fn(x)
        self.rel_tol = rel_bound(name, shape, self.dname)

    def label(self) -> str:
        data = "" if self.data == "random" else f" {self.data} data"
        return f"{self.name} {self.shape} {self.dname} param={self.param}{data}"

    def compare(self, quiet: bool = False) -> float:
        """Kernel vs plain version on the same inputs, each output on its own
        scale; returns the worst absolute error and keeps the worst error
        over rms(out) in ``rel``."""
        import torch

        out, ref = self.kernel(), self.plain()
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        err, ok, rels, olds = 0.0, True, [], []
        for o, r in zip(outs, refs):
            e = float((o - r).abs().max()) if o.numel() else 0.0
            rms = float(r.double().square().mean().sqrt()) if r.numel() else 0.0
            rels.append(e / rms if rms > 0 else (0.0 if e == 0 else float("inf")))
            if rms > 0:  # the old rule's allowance on the same scale
                olds.append(OLD_TOL[self.dname] * max(1, self.shape[1] // 16)
                            * max(1.0, float(r.abs().max())) / rms)
            ok = ok and rels[-1] <= self.rel_tol and bool(o.isfinite().all())
            err = max(err, e)
        self.rel = max(rels)
        self.old = min(olds) if olds else float("inf")
        if self.fixed is not None:
            check(torch.equal(out[self.fixed], self.x[self.fixed]),
                  f"{self.label()}: the [0 | I] tiles come back bitwise as they were",
                  quiet)
        old = f" (old rule {self.old:.1e})" if olds else ""
        check(ok, f"{self.label()}: max_abs_err {err:.3e}, max|err| / rms(out) "
                  f"{', '.join(f'{q:.2e}' for q in rels)}; each within "
                  f"{self.rel_tol:.1e}{old}", quiet)
        return err

    def zero_batch(self) -> None:
        import torch

        from repro_torch.kernels import ggr_apply

        z = torch.zeros((8,) + self.shape[1:], device="cuda", dtype=self.dtype)
        if self.name == "apply_factors":  # a zero panel's factors over zeros
            b, pivot0 = self.param
            VT = torch.zeros((8, self.shape[1], b), device="cuda", dtype=self.dtype)
            out = ggr_apply.apply_factors(VT, VT, z, pivot0)
        else:
            out = self.fn(z)
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        itype = torch.int32 if self.dtype == torch.float32 else torch.int64
        check(all(bool((o.view(itype) == 0).all()) for o in outs),
              f"{self.name} all-zero batch {tuple(z.shape)} {self.dname} "
              "comes back bitwise zero")

    def times(self) -> dict:
        ms = cuda_ms(self.kernel, reps=20, warmup=2)
        plain_ms = cuda_ms(self.plain, reps=3)
        library_ms = cuda_ms(self.library, reps=5)
        bound_ms, bound_by = bound(self.nbytes, self.dname, self.flops)
        print(f"  {self.label()}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
              f"{self.note}", flush=True)
        return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=bound_ms, bound_by=bound_by)


def profile_top(fn, label: str, rows: int = 8) -> None:
    """One traced call of ``fn``: device time by kernel name (self time,
    top ``rows``), the device's busy share of the call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side entries only: an operator's row repeats its kernels' time
    events = [(e.key, e.self_device_time_total, e.count)
              for e in prof.key_averages()
              if "CUDA" in str(e.device_type) and e.self_device_time_total > 0]
    busy = sum(t for _, t, _ in events)
    print(f"  trace of {label}: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}% of wall)")
    for key, t, count in sorted(events, key=lambda e: -e[1])[:rows]:
        print(f"    {100 * t / max(busy, 1e-9):5.1f}%  {t / 1e3:9.3f} ms  "
              f"x{count:<6d} {key[:90]}")


def recheck_shapes(recorded: dict, gen) -> dict:
    """Hold every (shape, param, dtype) a kernel was launched at by the main
    path against the plain version on fresh inputs of that shape (printing
    only failures); returns each kernel's worst error."""
    worst, worst_rel, looser = {}, {}, []
    for name, shapes in recorded.items():
        worst[name] = worst_rel[name] = 0.0
        for shape, param, dtype in sorted(shapes, key=str):
            case = KernelCase(name, shape, param, dtype, gen)
            worst[name] = max(worst[name], case.compare(quiet=True))
            worst_rel[name] = max(worst_rel[name], case.rel)
            if case.rel_tol > case.old:
                looser.append(f"{case.label()} ({case.rel_tol:.1e} > {case.old:.1e})")
    print(f"  worst max|err| / rms(out): {worst_rel}")
    print(f"  shapes where the bound is looser than the old rule: {looser or 'none'}")
    return worst


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run from the root of a checkout (src/repro_torch "
              "not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    # ------------------------------------------------------------ phase 1
    phase("1. card check")
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "float32 matmuls run in full float32 (allow_tf32 is False)")

    from repro_torch.core import ggr_qr_blocked
    from repro_torch.kernels import _cuda, ggr_apply, ggr_panel, ggr_qr_pallas, ggr_update
    from repro_torch.kernels.backend import degraded_mode
    from repro_torch.launch.serve_qr import QRServer, _as_tuple, _submit_all, make_workload
    from repro_torch.serve import KINDS
    from repro_torch.solvers import ggr_lstsq

    kernels = {"batched_update": ggr_update.batched_update,
               "batched_geqrt": ggr_panel.batched_geqrt,
               "panel_factor": ggr_panel.panel_factor,
               "apply_factors": ggr_apply.apply_factors}

    # ------------------------------------------------------------ phase 2
    phase("2. build")
    t0 = time.perf_counter()
    logs = _cuda.build()
    print(f"  built {sorted(logs)} into {_cuda.build_dir()} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        print(f"  --- {name}.cu ptxas:")
        for line in log.strip().splitlines():
            print(f"    {line}")

    # ------------------------------------------------------------ phase 3
    phase("3. kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [KernelCase(name, shape, param, getattr(torch, dname), gen, *data)
             for name, shape, param, dname, *data in PHASE3]
    worst = {name: 0.0 for name in kernels}
    timed = {}
    for case in cases:
        worst[case.name] = max(worst[case.name], case.compare())
        case.zero_batch()
        timed[(case.name, case.shape, case.dname, case.data)] = case.times()

    # ------------------------------------------------------------ phase 4
    phase("4. serving")
    n, rows, nrhs, num = 32, 8, 1, 8192
    server = QRServer(device="cuda", max_batch=SERVE_MAX_BATCH)
    reqs = make_workload(num=num, n=n, rows=rows, k=nrhs, device="cuda")
    _submit_all(server, reqs)  # warm-up flush
    server.flush()
    server.drain()
    tickets = _submit_all(server, reqs)
    for fn in kernels.values():
        fn.launches = 0
        fn.shapes.clear()
    t0 = time.perf_counter()
    served = server.flush()
    server.drain()
    dt = time.perf_counter() - t0
    serve_launches = {name: fn.launches for name, fn in kernels.items()}
    recorded = {name: set(fn.shapes) for name, fn in kernels.items()}
    req_s = served / dt
    print(f"  served {served} requests (n={n}, rows={rows}, nrhs={nrhs}, "
          f"max_batch={SERVE_MAX_BATCH}) in {dt * 1e3:.2f} ms: "
          f"{req_s:.1f} req/s on {card}")
    print(f"  launches in the timed flush: {serve_launches}")
    check(served == num, f"served all {num} requests")
    check(serve_launches["batched_update"] > 0,
          "serving launched batched_update (append + kalman kinds)")

    ref = QRServer(backend="reference", device="cuda", max_batch=SERVE_MAX_BATCH)
    rticks = _submit_all(ref, reqs)
    ref.flush()
    ref.drain()
    errs: dict[str, float] = {}
    # every 7th ticket: the stride is coprime to the mix's period of 8, so
    # the sample covers all four kinds
    for r, tk, rt in list(zip(reqs, tickets, rticks))[::7]:
        a, b = _as_tuple(server.result(tk)), _as_tuple(ref.result(rt))
        scale = max(1.0, max(float(y.abs().max()) for y in b))
        e = max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))
        if not all(bool(x.isfinite().all()) for x in a):
            e = float("inf")
        errs[r[0]] = max(errs.get(r[0], 0.0), e / scale)
    check(sorted(errs) == sorted(KINDS), f"cross-check sampled every kind: {sorted(errs)}")
    for kind, e in sorted(errs.items()):
        check(e <= 2e-4, f"serving {kind} vs reference backend: max error "
                         f"{e:.3e} (relative to max(1, |ref|)) <= 2e-4")
    _submit_all(server, reqs)
    profile_top(lambda: (server.flush(), server.drain()), "one serving flush")
    for kind in KINDS:  # where the flush time goes: each kind flushed alone
        sub = [r for r in reqs if r[0] == kind]
        _submit_all(server, sub)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.flush(kind)
        server.drain()
        print(f"  {kind}: {len(sub)} requests flushed alone in "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms")

    # ------------------------------------------------------------ phase 5
    phase("5. dense")
    g = torch.Generator(device="cuda").manual_seed(1)
    f32 = torch.float32
    A = torch.randn((8192, 1024), generator=g, device="cuda", dtype=f32)
    b = torch.randn((8192, 4), generator=g, device="cuda", dtype=f32)
    M = torch.randn((4096, 4096), generator=g, device="cuda", dtype=f32)

    def tree_lstsq():
        with degraded_mode(schedule="tree"):
            return ggr_lstsq(A, b)

    tree, fused = ("batched_geqrt", "batched_update"), ("panel_factor", "apply_factors")
    routes = {  # name -> (call, kernels it must launch, kernels it must not)
        "tree lstsq": (tree_lstsq, tree, ()),
        "tree qr": (lambda: ggr_qr_blocked(M, schedule="tree"), tree, ()),
        "fused qr": (lambda: ggr_qr_blocked(M, schedule="fused"), fused, ()),
        # "auto" on a CUDA tensor is the fused schedule
        "auto qr": (lambda: ggr_qr_blocked(M), fused, ("batched_geqrt",)),
        "fused lstsq": (lambda: ggr_lstsq(A, b), fused, ("batched_geqrt",)),
        "pallas qr": (lambda: ggr_qr_pallas(M, panel=32), fused, ()),
    }
    for fn in kernels.values():
        fn.launches = 0
    results, route_launches = {}, {}
    torch.cuda.synchronize()
    t_dense = time.perf_counter()
    for name, (call, _, _) in routes.items():
        before = {k: fn.launches for k, fn in kernels.items()}
        t0 = time.perf_counter()
        results[name] = call()
        torch.cuda.synchronize()
        route_launches[name] = {k: fn.launches - before[k] for k, fn in kernels.items()}
        print(f"  {name}: first call {(time.perf_counter() - t0) * 1e3:.1f} ms wall, "
              f"launches {route_launches[name]}")
    dense_wall = time.perf_counter() - t_dense
    dense_launches = {name: fn.launches for name, fn in kernels.items()}
    for name, fn in kernels.items():
        recorded[name] |= fn.shapes
    print(f"  launches in the dense run ({dense_wall * 1e3:.1f} ms wall): "
          f"{dense_launches}")
    for name, (_, needs, avoids) in routes.items():
        check(all(route_launches[name][k] > 0 for k in needs),
              f"{name} launched {' and '.join(needs)}")
        for k in avoids:
            check(route_launches[name][k] == 0, f"{name} launched no {k}")
    check(all(v > 0 for v in dense_launches.values()),
          "the dense run launched every kernel")

    A64, b64 = A.double(), b.double()
    x_ref = torch.linalg.lstsq(A64, b64, driver="gels").solution
    r_ref = torch.linalg.norm(A64 @ x_ref - b64, dim=0)
    for name in ("tree lstsq", "fused lstsq"):
        fit = results[name]
        r_ours = torch.linalg.norm(A64 @ fit.x.double() - b64, dim=0)
        res_gap = float(((r_ours - r_ref) / r_ref).abs().max())
        x_err = float(torch.linalg.norm(fit.x.double() - x_ref)
                      / torch.linalg.norm(x_ref))
        rep_gap = float(((fit.resid.double() - r_ref) / r_ref).abs().max())
        check(res_gap <= 1e-4, f"{name} (8192, 1024) f32: residual within "
                               f"{res_gap:.3e} of torch.linalg.lstsq f64 (<= 1e-4)")
        check(x_err <= 1e-3, f"{name} solution relative error {x_err:.3e} (<= 1e-3)")
        check(rep_gap <= 1e-3, f"{name} reported residual within {rep_gap:.3e} "
                               "of the f64 residual (<= 1e-3)")

    R_lib = torch.linalg.qr(M, mode="r").R
    M64 = M.double()
    for name in ("tree qr", "fused qr", "auto qr", "pallas qr"):
        R = results[name]
        r_gap = float(torch.linalg.norm(R.abs() - R_lib.abs()) / torch.linalg.norm(R_lib))
        check(r_gap <= 1e-3, f"{name} 4096^2 f32: |R| within {r_gap:.3e} of "
                             "torch.linalg.qr's |R| (relative Frobenius, <= 1e-3)")
        R64 = R.double()
        gram = float(torch.linalg.norm(R64.T @ R64 - M64.T @ M64)
                     / torch.linalg.norm(M64) ** 2)
        check(gram <= 1e-5, f"{name} Gram residual ||R^T R - A^T A|| / ||A||^2 "
                            f"= {gram:.3e} (<= 1e-5)")
    del results
    profile_top(lambda: ggr_qr_blocked(M, schedule="tree"),
                "ggr_qr_blocked 4096^2 f32 (tree)")
    profile_top(lambda: ggr_qr_blocked(M, schedule="fused"),
                "ggr_qr_blocked 4096^2 f32 (fused)")
    profile_top(tree_lstsq, "ggr_lstsq (8192, 1024) + 4 rhs f32 (tree)")
    dense_ms = {name: cuda_ms(call, reps=3) for name, (call, _, _) in routes.items()}
    dense_ms["torch.linalg.qr"] = cuda_ms(lambda: torch.linalg.qr(M), reps=3)
    dense_ms["torch.linalg.lstsq"] = cuda_ms(
        lambda: torch.linalg.lstsq(A, b).solution, reps=3)
    for name, ms in dense_ms.items():
        shape = "(8192, 1024) + 4 rhs" if "lstsq" in name else "4096x4096"
        print(f"  {name} {shape} f32: {ms:.2f} ms ({card})")

    # ------------------------------------------------------------ phase 6
    phase("6. kernels vs plain versions at every main-path shape")
    n_shapes = sum(len(s) for s in recorded.values())
    recheck_worst = recheck_shapes(recorded, gen)
    print(f"  {n_shapes} (shape, dtype) launches rechecked; worst errors "
          f"{recheck_worst}")

    # ------------------------------------------------------------ phase 7
    phase("7. summary")
    headline = {"batched_update": ("batched_update", (8192, 40, 33), "float32"),
                "batched_geqrt": ("batched_geqrt", (128, 64, 128), "float32"),
                "panel_factor": ("panel_factor", (1, 4096, 64), "float32"),
                "apply_factors": ("apply_factors", (1, 4096, 4032), "float32")}
    meta = {"batched_update": ("src/repro_torch/kernels/csrc/ggr_update.cu",
                               "src/repro/kernels/ggr_update.py:91"),
            "batched_geqrt": ("src/repro_torch/kernels/csrc/ggr_panel.cu",
                              "src/repro/kernels/ggr_panel.py:211"),
            "panel_factor": ("src/repro_torch/kernels/csrc/ggr_panel_factor.cu",
                             "src/repro/kernels/ggr_panel.py:135"),
            "apply_factors": ("src/repro_torch/kernels/csrc/ggr_apply.cu",
                              "src/repro/kernels/ggr_apply.py:28")}
    rows_out = []
    for name in kernels:
        t = timed[(*headline[name], "random")]
        rows_out.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": serve_launches[name] + dense_launches[name],
            "max_abs_err": max(worst[name], recheck_worst[name]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": list(headline[name][1]), "dtype": headline[name][2],
        })
    for (name, shape, dname, data), t in timed.items():
        print(f"  {name} {shape} {dname} {data}: " + ", ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in t.items()))
    print(f"  serving: {req_s:.1f} req/s; dense ms: " + ", ".join(
        f"{k} {v:.2f}" for k, v in dense_ms.items()) + f"; card {card}")
    if FAILURES:
        print(f"\nchip_smoke.py: {len(FAILURES)} check(s) failed:", file=sys.stderr)
        for f in FAILURES:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows_out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
