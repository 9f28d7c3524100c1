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
6. instrumented path and sketch least squares — (a) the serving flush of
   phase 4 under an ``obs`` collector: its snapshot must hold every family
   of ``REQUIRED_SERVE_FAMILIES``, and the flush's req/s with and without
   the collector are printed; ``python -m repro_torch.launch.serve_qr
   --metrics build/smoke_metrics/serve --check --requests 512`` must exit 0
   with two CSV lines and files ``repro_torch.obs.export --validate``
   accepts; (b) ``sketch_lstsq`` of a (65536, 256) f64 system at cond 1e8
   with b = A x0 + r0, r0 orthogonal to range(A), ||r0|| = 0.1 (the sketch's
   (1024, 256) QR runs the fused schedule's kernels): the residual within
   1e-6 of ||r0|| in at most 50 iterations, R_s the same bits twice, timed
   beside ``torch.linalg.lstsq``; (c) a ``ConditionMonitor`` over 32
   appends to a (256, 256) RLS state, within 2x of ``torch.linalg.cond``; a
   downdate across the rank cliff under ``DowndateGuard`` ("damp": finite
   factor, one ``solvers.downdate_guard_trips``; "refuse": the state bit
   for bit) and ``state_integrity`` with and without ``max_cond``; (d) one
   ``ggr_qr_blocked`` of 4096^2 f32 under a collector: its ``blocked``
   flops (the sweep model) and the GFLOP/s they give (a reading); (e) the
   paper's baseline QRs (``core.baselines``) against ``torch.linalg.qr``;
7. resilient serving — (a) ``QRServer(resilient=True)`` and the plain server
   serve the 8192-request mix: every result bitwise equal, every provenance
   entry native after one attempt, no failure, degradation or quarantine
   counted under a collector, ``batched_update`` launched as often; the
   req/s of both over 5 alternating pairs and their medians; (b) chaos: the
   mix with 1% NaN-poisoned requests (``poison_workload(seed=11)``) at
   ``max_batch=512`` under ``FaultPlan(seed=7, transient_rate=0.2,
   poison_rate=0.05)`` beside a fault-free resilient run of it: every
   poisoned request quarantined in both, >= 99% of the rest served, native
   results bitwise equal to the fault-free run's, degraded ones within 2e-4;
   (c) every rung of ``DEFAULT_LADDER`` drilled on the mix's 4096 appends
   (provenance, ``serve.degraded_dispatches``, within 2e-4 of native,
   ``batched_update`` launches per rung: none on the reference rung) and a
   purge drill; (d) a NaN lane through ``batched_update`` with the pre-check
   off (quarantined, the other appends bitwise unchanged) and the condition
   gate (exactly the 8 ill-conditioned appends quarantined); the snapshot of
   (b)-(d) passes ``obs.export --validate --preset chaos``; (e) a (256, 256)
   ``RecursiveLS`` state on the card through ``StateVault``: restore falls
   back past a corrupted snapshot, bit-equal, and raises ``IntegrityError``
   when every snapshot is corrupted; (f) ``serve_qr --resilient --check
   --requests 512`` exits 0 with two CSV lines, ``--mesh 2`` exits 2;
8. every (shape, dtype) the kernels were launched at by phases 4-7 is held
   against the plain version once more;
9. a JSON line of per-kernel numbers, then the last line
   ``{"ok": true, "device": {...}}``.

Launch counts are set to 0 just before the serving run, the dense run,
phase 6 and phase 7, and read just after each; a route that does not launch
its kernels fails the run.  Any failed check exits non-zero without printing the last
line.  The script imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
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
# phase 6's sketch least squares: the tall system, its spectrum and the oracle
SKETCH_M, SKETCH_N, SKETCH_COND, SKETCH_R0 = 65536, 256, 1e8, 0.1


def check(ok: bool, what: str, quiet: bool = False) -> None:
    if not (ok and quiet):
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        FAILURES.append(what)


_T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"\n== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


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


def profile_top(fn, label: str, rows: int = 8, host_ops: bool = True) -> None:
    """One traced call of ``fn``: device time by kernel name (self time,
    top ``rows``), the device's busy share of the call's wall time.
    ``host_ops=False`` records the device activity only: reading back a
    trace of ~10^5 host-side ops takes the profiler about a minute."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=acts) as prof:
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


def graded_system(m: int, n: int, cond: float, seed: int):
    """(A, b, x0, ||r0||) in f64 numpy: A with singular values geometric from
    1 to 1/cond (orthogonal factors from QR of seeded Gaussians), b = A x0 +
    r0 with r0 orthogonal to range(A) — so x0 solves min ||Ax - b|| and
    ||r0|| is the optimal residual exactly."""
    import numpy as np

    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (U * np.geomspace(1.0, 1.0 / cond, n)) @ V.T
    x0 = rng.standard_normal(n)
    r0 = rng.standard_normal(m)
    r0 -= U @ (U.T @ r0)
    r0 *= SKETCH_R0 / np.linalg.norm(r0)
    return A, A @ x0 + r0, x0, float(np.linalg.norm(r0))


def wall_ms(fn) -> tuple:
    """(result, ms) of one call, synchronized on both ends."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def instrumented_phase(server, reqs, kernels, card: str) -> dict:
    """Phase 6 (a)-(e); returns the launches it made and its numbers."""
    import numpy as np
    import torch

    from repro_torch import obs, ranks, solvers
    from repro_torch.core import baselines, ggr_qr_blocked
    from repro_torch.launch.serve_qr import _submit_all

    for fn in kernels.values():
        fn.launches = 0
        fn.shapes.clear()
    t_phase = time.perf_counter()
    out = {}

    # (a) the serving flush with and without a collector, in turns after
    # one untimed flush
    _submit_all(server, reqs)
    server.flush()
    server.drain()
    rates = {"without": [], "with": []}
    for mode in ("without", "with", "with", "without", "without", "with"):
        _submit_all(server, reqs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "with":
            with obs.collecting() as reg:
                served = server.flush()
                server.drain()
        else:
            served = server.flush()
            server.drain()
        rates[mode].append(served / (time.perf_counter() - t0))
    out["serve_req_s"] = rates
    print(f"  (a) 8192-request flush: without a collector "
          f"{', '.join(f'{r:.1f}' for r in rates['without'])} req/s, with one "
          f"{', '.join(f'{r:.1f}' for r in rates['with'])} req/s (turns: without, "
          f"with, with, without, without, with; {card})")
    snap = obs.snapshot(reg)
    missing = obs.missing_families(snap)
    check(not missing, f"(a) the instrumented flush's snapshot holds every "
                       f"required serving family (missing: {missing or 'none'})")
    flops = sum(m["value"] for m in snap["metrics"] if m["name"] == "serve.flops_total")
    gf = [m for m in snap["metrics"] if m["name"] == "serve.achieved_gflops"]
    print(f"  (a) {len(snap['metrics'])} series; serve.flops_total {flops:.4g}; "
          "achieved GFLOP/s p50 by kind: " + ", ".join(
              f"{m['labels']['kind']} {m['quantiles']['0.5']:.3g}" for m in gf))
    prefix = ROOT / "build" / "smoke_metrics" / "serve"
    prefix.parent.mkdir(parents=True, exist_ok=True)
    for f in (f"{prefix}.jsonl", f"{prefix}.prom"):
        if os.path.exists(f):
            os.remove(f)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve_qr",
                          "--metrics", str(prefix), "--check", "--requests", "512"],
                         capture_output=True, text=True, env=env, timeout=600)
    lines = cli.stdout.strip().splitlines()
    check(cli.returncode == 0 and len(lines) == 2 and len(lines[-1].split(",")) == 3,
          f"(a) serve_qr --metrics --check --requests 512 exits "
          f"{cli.returncode} with {len(lines)} CSV lines: {lines[-1:]}")
    val = subprocess.run([sys.executable, "-m", "repro_torch.obs.export",
                          "--validate", f"{prefix}.jsonl"],
                         capture_output=True, text=True, env=env, timeout=300)
    check(val.returncode == 0 and os.path.exists(f"{prefix}.prom"),
          f"(a) obs.export --validate accepts {prefix}.jsonl: "
          f"{(val.stdout or val.stderr).strip()[:120]}")

    # (b) sketch-preconditioned least squares at full size, f64
    t0 = time.perf_counter()
    A, b, x0, r0 = graded_system(SKETCH_M, SKETCH_N, SKETCH_COND, seed=13)
    print(f"  (b) built A ({SKETCH_M}, {SKETCH_N}) f64, cond {SKETCH_COND:g}, "
          f"in {time.perf_counter() - t0:.1f} s on the host")
    At = torch.as_tensor(A, device="cuda")
    bt = torch.as_tensor(b, device="cuda")
    before = {k: fn.launches for k, fn in kernels.items()}
    fit, ms = wall_ms(lambda: ranks.sketch_lstsq(At, bt, iters=50, tol=1e-12, seed=15))
    sk_launch = {k: fn.launches - before[k] for k, fn in kernels.items()}
    fit2, ms2 = wall_ms(lambda: ranks.sketch_lstsq(At, bt, iters=50, tol=1e-12, seed=15))
    _, lib_ms = wall_ms(lambda: torch.linalg.lstsq(At, bt[:, None]).solution)
    _, lib_ms2 = wall_ms(lambda: torch.linalg.lstsq(At, bt[:, None]).solution)
    resid, iters = float(fit.resid), int(fit.iters)
    x_err = float(np.linalg.norm(fit.x.cpu().numpy() - x0) / np.linalg.norm(x0))
    out["sketch"] = dict(ms=[ms, ms2], lstsq_ms=[lib_ms, lib_ms2], iters=iters,
                         resid_gap=abs(resid - r0) / r0)
    print(f"  (b) sketch_lstsq: {ms:.1f} / {ms2:.1f} ms, {iters} iterations, "
          f"resid {resid:.12g} vs ||r0|| {r0:.12g}, |x - x0| / |x0| {x_err:.2e}; "
          f"torch.linalg.lstsq {lib_ms:.1f} / {lib_ms2:.1f} ms; launches {sk_launch} "
          f"({card})")
    check(abs(resid - r0) <= 1e-6 * r0 and iters <= 50,
          f"(b) residual within {abs(resid - r0) / r0:.2e} of ||r0|| (<= 1e-6) "
          f"in {iters} <= 50 iterations")
    check(x_err <= 1e-2, f"(b) x within {x_err:.2e} of x0 (<= 1e-2, the "
                         "problem's tol x cond amplification)")
    check(torch.equal(fit.R, fit2.R) and torch.equal(fit.x, fit2.x),
          "(b) R_s and x are the same bits on two runs (deterministic sketch)")
    check(sk_launch["panel_factor"] > 0 and sk_launch["apply_factors"] > 0,
          "(b) the sketch QR launched panel_factor and apply_factors")
    profile_top(lambda: ranks.sketch_lstsq(At, bt, iters=50, tol=1e-12, seed=15),
                "sketch_lstsq (65536, 256) f64", rows=5, host_ops=False)
    del At, bt, fit, fit2

    # (c) monitor and guard on a (256, 256) RLS state on the card
    n = 256
    rng = np.random.default_rng(21)
    U, _ = np.linalg.qr(rng.standard_normal((2 * n, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    R0 = np.linalg.qr((U * np.geomspace(1.0, 1e-6, n)) @ V.T, mode="r")
    R0 *= np.sign(np.diag(R0))[:, None]
    f64 = dict(dtype=torch.float64, device="cuda")
    rls = solvers.RecursiveLS(n=n)
    state = solvers.RLSState(R=torch.as_tensor(R0, **f64),
                             d=torch.as_tensor(rng.standard_normal((n, 1)), **f64),
                             count=torch.zeros((), dtype=torch.int32, device="cuda"))
    mon = ranks.ConditionMonitor(layer="rls", iters=4)
    t0 = time.perf_counter()
    with obs.collecting() as reg:
        for _ in range(32):
            state = rls.observe(state, torch.as_tensor(1e-3 * rng.standard_normal((1, n)), **f64),
                                torch.zeros((1, 1), **f64))
            est = mon.observe(state.R)
    truth = float(torch.linalg.cond(state.R.cpu().double()))
    print(f"  (c) ConditionMonitor over 32 appends: {est:.6g} vs torch.linalg.cond "
          f"{truth:.6g} ({(time.perf_counter() - t0) * 1e3:.0f} ms)")
    check(0.5 * truth <= est <= 2.0 * truth, "(c) the monitor's last estimate is "
          f"within 2x of torch.linalg.cond ({est / truth:.3f})")
    check(reg.find("rls.cond_estimate").value == est, "(c) rls.cond_estimate gauge recorded")
    u = state.R[n // 2] + 0.0  # a direction of the window's mass
    lev = float(rls.residual_gram(state, u))
    bad = (1.5 / lev) ** 0.5 * u  # leverage 1.5: past the rank cliff
    y = bad.sum().reshape(1)
    with obs.collecting() as reg:
        damped = rls.forget(state, bad, y, guard=ranks.DowndateGuard(1e-6, "damp"))
    trips = reg.find("solvers.downdate_guard_trips")
    check(bool(damped.R.isfinite().all()) and trips is not None and trips.value == 1,
          "(c) damp: the factor stays finite, solvers.downdate_guard_trips = "
          f"{None if trips is None else trips.value}")
    kept = rls.forget(state, bad, y, guard=ranks.DowndateGuard(1e-6, "refuse"))
    check(torch.equal(kept.R, state.R) and torch.equal(kept.d, state.d),
          "(c) refuse: the state comes back bit for bit")
    ok_free, why_free = solvers.state_integrity(damped)
    ok_cap, why_cap = solvers.state_integrity(damped, max_cond=1e3)
    ok_big, _ = solvers.state_integrity(damped, max_cond=1e12)
    print(f"  (c) state_integrity: {ok_free} ({why_free}); max_cond=1e3: {ok_cap} "
          f"({why_cap}); max_cond=1e12: {ok_big}")
    check(ok_free and ok_big and not ok_cap, "(c) state_integrity passes the "
          "damped state, and refuses it only under max_cond=1e3")

    # (d) flop accounting of one dense QR (a reading, not a claim)
    g = torch.Generator(device="cuda").manual_seed(2)
    M = torch.randn((4096, 4096), generator=g, device="cuda")
    ggr_qr_blocked(M)  # warm
    qr_ms = {"without": [], "with": []}
    for mode in ("without", "with", "with", "without"):
        if mode == "with":
            with obs.collecting() as reg:
                qr_ms[mode].append(wall_ms(lambda: ggr_qr_blocked(M))[1])
        else:
            qr_ms[mode].append(wall_ms(lambda: ggr_qr_blocked(M))[1])
    out["dense_qr_ms"] = qr_ms
    print(f"  (d) ggr_qr_blocked 4096^2 f32 wall: without a collector "
          f"{', '.join(f'{t:.2f}' for t in qr_ms['without'])} ms, with one "
          f"{', '.join(f'{t:.2f}' for t in qr_ms['with'])} ms")
    sched = "fused"
    disp = reg.find("blocked.dispatch_seconds", schedule=sched, precision="float32")
    fl = reg.find("blocked.flops_total", dtype="float32", schedule=sched, precision="float32")
    model = obs.ggr_sweep_flops(4096, 4096)
    check(disp is not None and fl is not None and fl.value == model,
          "(d) blocked.flops_total equals ggr_sweep_flops(4096, 4096)")
    if disp is not None:
        sec = disp.values[-1]
        out["dense_gflops"] = model / sec / 1e9
        print(f"  (d) ggr_qr_blocked 4096^2 f32 (\"auto\", {sched}): {model:.6g} flops "
              f"by the sweep model in {sec * 1e3:.2f} ms = {model / sec / 1e9:.1f} "
              f"GFLOP/s ({card})")
    del M

    # (e) the paper's baseline QRs against torch.linalg.qr
    out["baselines_ms"] = {}
    for name, shape in (("householder_qr2", (512, 256)), ("householder_qrf", (512, 256)),
                        ("mht_qr", (512, 256)), ("mgs_qr", (512, 256)),
                        ("givens_qr", (128, 128)), ("cgr_qr", (128, 128))):
        X = torch.randn(shape, generator=g, device="cuda")
        fn = getattr(baselines, name)
        res, ms = wall_ms(lambda: fn(X))
        R = res[1] if name == "mgs_qr" else res
        R_lib = torch.linalg.qr(X, mode="r").R
        k = min(shape)
        gap = float(torch.linalg.norm(R[:k].abs() - R_lib[:k].abs()) / torch.linalg.norm(R_lib))
        out["baselines_ms"][name] = ms
        check(gap <= 1e-3, f"(e) {name} {shape} f32: |R| within {gap:.2e} of "
                           f"torch.linalg.qr's (<= 1e-3), {ms:.1f} ms")
    launches = {k: fn.launches for k, fn in kernels.items()}
    out["launches"] = launches
    out["shapes"] = {k: set(fn.shapes) for k, fn in kernels.items()}
    print(f"  launches in phase 6: {launches} "
          f"({(time.perf_counter() - t_phase):.1f} s wall)")
    for k in ("batched_update", "panel_factor", "apply_factors"):
        check(launches[k] > 0, f"phase 6 launched {k}")
    return out


def same_bits(a, b) -> bool:
    """Two ticket results (a tensor or a tuple of tensors) equal bit for bit
    (float leaves compared as integers, so a NaN equals the same NaN)."""
    import torch

    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.is_floating_point():
            itype = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
            x, y = x.contiguous().view(itype), y.contiguous().view(itype)
        if not torch.equal(x, y):
            return False
    return True


def rel_gap(a, b) -> float:
    """Worst |a - b| over max(1, |b|) across the leaves of two results (the
    serving cross-check's scale); inf where a is not finite."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    if not all(bool(x.isfinite().all()) for x in a):
        return float("inf")
    scale = max(1.0, max(float(y.abs().max()) for y in b))
    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b)) / scale


def resolve(engine, ticket):
    """A ticket's result, or the ServeError it resolved to."""
    from repro_torch.serve import ServeError

    try:
        return engine.result(ticket)
    except ServeError as e:
        return e


def counter_sum(reg, name: str, /, **labels) -> float:
    return sum(m.value for m in reg.collect() if m.name == name
               and all(dict(m.labels).get(k) == v for k, v in labels.items()))


def resilient_phase(reqs, kernels, card: str) -> dict:
    """Phase 7 (a)-(f); returns the launches it made and its numbers."""
    import shutil

    import numpy as np
    import torch

    from repro_torch import obs, solvers
    from repro_torch.convert import from_numpy
    from repro_torch.launch.serve_qr import QRServer, _submit_all
    from repro_torch.obs import export
    from repro_torch.serve import (DEFAULT_LADDER, ContinuousBatcher, IntegrityError,
                                   PoisonedError, ResilientDispatcher, RetryPolicy, Rung,
                                   ServeError, StateVault)
    from repro_torch.testing.faults import (FaultPlan, ScriptedInjector, inject,
                                            poison_workload)

    b1 = kernels["batched_update"]
    for fn in kernels.values():
        fn.launches = 0
        fn.shapes.clear()
    t_phase = time.perf_counter()
    out = {"wall_s": {}}
    no_sleep = lambda s: None  # noqa: E731 — the drills do not wait out backoffs
    # the mix's operands as tensors on the card, made once (the fleet-shared
    # models stay one tensor): submits then copy nothing, and the flushes do
    # the same work as phase 4's
    reqs = from_numpy(reqs, "cuda")
    t_sub = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        out["wall_s"][part] = now - t_sub[0]
        print(f"  ({part}) took {now - t_sub[0]:.1f} s")
        t_sub[0] = now

    # (a) fault-free at full width: resilient == plain, bit for bit
    servers = {"plain": QRServer(device="cuda", max_batch=SERVE_MAX_BATCH),
               "resilient": QRServer(device="cuda", max_batch=SERVE_MAX_BATCH,
                                     resilient=True)}
    res = {}
    for name, srv in servers.items():
        before = b1.launches
        tickets = _submit_all(srv, reqs)
        srv.flush()
        srv.drain()
        res[name] = ([srv.result(t) for t in tickets], b1.launches - before)
    diff = sum(not same_bits(a, b) for a, b in zip(res["plain"][0], res["resilient"][0]))
    check(diff == 0, f"(a) fault-free resilient flush of {len(reqs)} requests: every result "
                     f"bitwise equal to the plain flush's ({diff} differ)")
    dispatcher = servers["resilient"]._engine.dispatcher
    provs = {(p.rung, p.attempts) for ps in dispatcher.provenance.values() for p in ps}
    check(provs == {("native", 1)}, f"(a) every provenance entry is (native, 1 attempt): {provs}")
    check(res["plain"][1] == res["resilient"][1] > 0,
          f"(a) batched_update launches: plain flush {res['plain'][1]}, resilient "
          f"{res['resilient'][1]}")
    _submit_all(servers["resilient"], reqs)
    with obs.collecting() as reg:
        servers["resilient"].flush()
        servers["resilient"].drain()
    faults = {f: counter_sum(reg, f) for f in
              ("serve.chunk_failures", "serve.degraded_dispatches", "serve.quarantined")}
    check(not any(faults.values()), f"(a) under a collector, no failure, degradation or "
                                    f"quarantine is counted: {faults}")
    rates = {"plain": [], "resilient": []}
    for name in ["plain", "resilient", "resilient", "plain"] * 2 + ["plain", "resilient"]:
        srv = servers[name]
        _submit_all(srv, reqs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = srv.flush()
        srv.drain()
        rates[name].append(served / (time.perf_counter() - t0))
    med = {k: float(np.median(v)) for k, v in rates.items()}
    out["serve_req_s"] = dict(rates, median=med)
    print(f"  (a) {len(reqs)}-request flush, 5 alternating pairs (plain, resilient, "
          f"resilient, plain, ...): plain {', '.join(f'{r:.1f}' for r in rates['plain'])}; "
          f"resilient {', '.join(f'{r:.1f}' for r in rates['resilient'])} req/s; medians "
          f"{med['plain']:.1f} / {med['resilient']:.1f}, ratio "
          f"{med['resilient'] / med['plain']:.3f} (the layer's bound >= 0.8: a reading, "
          f"not checked, as the host's spread is wider; {card})")
    del res, servers
    lap("a")

    # (b) chaos, as the JAX package's bench: a poisoned mix under a fault plan,
    # beside a fault-free resilient run of the same mix at the same max_batch
    poisoned, idx = poison_workload(reqs, rate=0.01, seed=11)
    runs = {}
    reg = obs.MetricsRegistry()
    for name in ("fault-free", "chaos"):
        srv = QRServer(device="cuda", max_batch=512, resilient=True)
        tickets = _submit_all(srv, poisoned)
        t0 = time.perf_counter()
        if name == "chaos":
            with obs.collecting(reg), inject(FaultPlan(seed=7, transient_rate=0.2,
                                                       poison_rate=0.05)) as inj:
                srv.flush()
                srv.drain()
        else:
            srv.flush()
            srv.drain()
        wall = time.perf_counter() - t0
        prov = srv._engine.dispatcher.provenance
        runs[name] = [(resolve(srv._engine, t), prov[(t.group, t.cycle)][t.index])
                      for t in tickets]
        print(f"  (b) {name} run, max_batch 512: {wall * 1e3:.1f} ms")
    counts = dict(inj.counts)
    bad = set(idx)
    for name, outs in runs.items():
        wrong = [i for i in idx if not isinstance(outs[i][0], PoisonedError)]
        check(not wrong, f"(b) {name}: all {len(idx)} poisoned requests resolve to "
                         f"PoisonedError (not: {wrong[:5]})")
    clean = [i for i in range(len(reqs)) if i not in bad]
    served = sum(not isinstance(runs["chaos"][i][0], ServeError) for i in clean)
    avail = served / len(clean)
    native = degraded = 0
    native_diff, worst = [], 0.0
    rungs: dict = {}
    for i in clean:
        got, prov = runs["chaos"][i]
        rungs[prov.rung] = rungs.get(prov.rung, 0) + 1
        want = runs["fault-free"][i][0]
        if isinstance(got, ServeError) or isinstance(want, ServeError):
            continue
        if prov.rung == "native":
            native += 1
            if not same_bits(got, want):
                native_diff.append(i)
        else:
            degraded += 1
            worst = max(worst, rel_gap(got, want))
    out["chaos"] = dict(counts=counts, availability=avail, native=native,
                        degraded=degraded, rungs=rungs, worst_degraded=worst)
    print(f"  (b) injected {counts}; {len(idx)} poisoned; availability {avail:.4f} of "
          f"{len(clean)} clean; served by rung {rungs}; worst degraded gap {worst:.2e}")
    check(avail >= 0.99, f"(b) {served} of {len(clean)} clean requests served "
                         f"({avail:.4f} >= 0.99)")
    check(not native_diff, f"(b) every native-rung result ({native}) is bitwise equal to "
                           f"the fault-free run's ({len(native_diff)} differ)")
    check(worst <= 2e-4, f"(b) degraded results ({degraded}) within {worst:.2e} of the "
                         "fault-free run (<= 2e-4 of max(1, |ref|))")
    check(counts.get("transient", 0) >= 1 and counts.get("poison", 0) >= 1,
          f"(b) the plan fired at least one transient and one poison: {counts}")
    del runs
    lap("b")

    # (c) ladder drill at full width: the mix's 4096 appends (two groups, one
    # chunk each), each group forced onto rung k by k scripted failures
    appends = [r for r in reqs if r[0] == "append"]
    groups = [[r for r in appends if len(r) == 5], [r for r in appends if len(r) == 3]]
    drill = {}
    native_res = None
    with obs.collecting(reg):
        for k, rung in enumerate(DEFAULT_LADDER):
            d = ResilientDispatcher(device="cuda", max_batch=SERVE_MAX_BATCH,
                                    retry=RetryPolicy(max_attempts=1), sleep=no_sleep)
            eng = ContinuousBatcher(d)
            before = b1.launches
            got, served_by = [], set()
            for group in groups:
                with inject(ScriptedInjector(range(k))):
                    tickets = [eng.submit(*r) for r in group]
                    eng.flush()
                got += [resolve(eng, t) for t in tickets]
                served_by |= {p.rung for p in d.provenance[(tickets[0].group, tickets[0].cycle)]}
            launches = b1.launches - before
            gap = 0.0 if k == 0 else max(rel_gap(a, b) for a, b in zip(got, native_res))
            if k == 0:
                native_res = got
            hops = counter_sum(reg, "serve.degraded_dispatches", to=rung.name)
            drill[rung.name] = dict(launches=launches, gap=gap, hops=hops)
            print(f"  (c) rung {k} {rung.name}: served by {sorted(served_by)}, "
                  f"batched_update launches {launches}, gap to native {gap:.2e}, "
                  f"degraded_dispatches to it {hops:g}")
            check(served_by == {rung.name} and not any(isinstance(x, ServeError) for x in got),
                  f"(c) {len(got)} appends forced onto rung {rung.name!r}: provenance "
                  f"{sorted(served_by)}")
            check(k == 0 or hops >= 1, f"(c) serve.degraded_dispatches{{to={rung.name}}} "
                                       f"= {hops:g} (>= 1)")
            check(gap <= 2e-4, f"(c) rung {rung.name!r} within {gap:.2e} of native (<= 2e-4)")
            check((launches == 0) == (rung.name == "reference"),
                  f"(c) rung {rung.name!r} launched batched_update {launches} times "
                  "(the reference rung none)")
        purged0 = counter_sum(reg, "serve.cycles_purged")
        d = ResilientDispatcher(device="cuda", ladder=(Rung("native"),),
                                retry=RetryPolicy(max_attempts=1), sleep=no_sleep)
        eng = ContinuousBatcher(d)
        with inject(ScriptedInjector(range(64))):
            t = eng.submit(*groups[0][0])
            eng.flush()
        got = resolve(eng, t)
        purged = counter_sum(reg, "serve.cycles_purged") - purged0
        check(isinstance(got, ServeError) and got.classification == "transient"
              and purged == 1, f"(c) purge drill: the ticket resolves to "
                               f"{type(got).__name__}, serve.cycles_purged +{purged:g}")
    out["ladder"] = drill
    lap("c")

    # (d) quarantine through the kernel: a NaN lane past a disabled pre-check,
    # and the condition gate
    def serve_appends(batch, **kw):
        d = ResilientDispatcher(device="cuda", max_batch=SERVE_MAX_BATCH, sleep=no_sleep, **kw)
        eng = ContinuousBatcher(d)
        before = b1.launches
        tickets = [eng.submit(*r) for r in batch]
        eng.flush()
        return [resolve(eng, t) for t in tickets], b1.launches - before

    with obs.collecting(reg):
        clean_res, _ = serve_appends(appends, precheck=False)
        nan_i = next(i for i, r in enumerate(appends) if len(r) == 5 and i >= 100)
        bad_reqs = list(appends)
        R = bad_reqs[nan_i][1].clone()
        R[3, 5] = float("nan")
        bad_reqs[nan_i] = ("append", R, *bad_reqs[nan_i][2:])
        got, launches = serve_appends(bad_reqs, precheck=False)
        diff = [i for i, (a, b) in enumerate(zip(got, clean_res))
                if i != nan_i and not same_bits(a, b)]
        check(isinstance(got[nan_i], PoisonedError) and "post-dispatch" in got[nan_i].reason,
              f"(d) the NaN lane through batched_update resolves to "
              f"{type(got[nan_i]).__name__} ({launches} launches)")
        check(not diff and launches >= 3, f"(d) the other {len(got) - 1} appends are "
                                          f"bitwise equal to the fault-free run "
                                          f"({len(diff)} differ)")
        ill = [i for i, r in enumerate(appends) if len(r) == 5][7:7 + 8 * 300:300]
        cond_reqs = list(appends)
        for i in ill:
            _, R, U, *rest = cond_reqs[i]
            R, U = R.clone(), U.clone()
            R[:, -1] *= 1e-12  # the last unknown barely observed: cond >= 1e10
            U[:, -1] *= 1e-12
            cond_reqs[i] = ("append", R, U, *rest)
        got, _ = serve_appends(cond_reqs, max_cond=1e6)
        caught = [i for i, x in enumerate(got) if isinstance(x, PoisonedError)]
        check(caught == ill, f"(d) the condition gate (max_cond=1e6) quarantines exactly "
                             f"the {len(ill)} ill-conditioned appends: {caught}")
        ungated, _ = serve_appends([cond_reqs[i] for i in ill])
        conds = [float(torch.linalg.cond(x[0].double())) for x in ungated]
        check(min(conds) >= 1e10, f"(d) their factors' cond without the gate: "
                                  f"{min(conds):.2e} .. {max(conds):.2e} (>= 1e10)")
        del clean_res, got

    # the chaos, drill and quarantine snapshot passes the chaos preset
    path = ROOT / "build" / "smoke_metrics" / "chaos.jsonl"
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.exists():
        path.unlink()
    obs.write_jsonl(str(path), reg, {"phase": "7 resilient serving"})
    try:
        export.main(["--validate", str(path), "--preset", "chaos"])
        valid = "ok"
    except SystemExit as e:
        valid = str(e)
    check(valid == "ok", f"(b-d) obs.export --validate --preset chaos accepts {path}: {valid}")
    lap("d")

    # (e) the state vault: a (256, 256) RecursiveLS state on the card
    n = 256
    rng = np.random.default_rng(31)
    f64 = dict(dtype=torch.float64, device="cuda")
    rls = solvers.RecursiveLS(n=n)
    state = rls.init(torch.float64, device="cuda")
    root = ROOT / "build" / "smoke_vault"
    shutil.rmtree(root, ignore_errors=True)
    vault = StateVault(root=str(root), interval=4, keep=3)
    saved = {}
    t0 = time.perf_counter()
    for step in range(1, 13):
        U = torch.as_tensor(rng.standard_normal((4, n)), **f64)
        state = rls.observe(state, U, torch.as_tensor(rng.standard_normal((4, 1)), **f64))
        if vault.snapshot("rls", state):
            saved[step] = state
    kept = sorted(int(p.name.split("_")[1]) for p in (root / "rls").glob("step_*"))
    newest = root / "rls" / f"step_{max(kept):08d}" / "leaves.npz"
    with np.load(newest) as f:
        leaves = dict(f)
    leaves[".R"][n // 2, n // 2 + 1] = np.nan
    np.savez(newest, **leaves)
    with obs.collecting(reg):
        got, step = vault.restore_latest("rls", like=state)
    rejected = counter_sum(reg, "serve.state_restores", name="rls", outcome="rejected")
    check(rejected == 1, f"(e) serve.state_restores{{outcome=rejected}} = {rejected:g}")
    check(kept == [4, 8, 12] and step == 8 and got.R.device.type == "cuda"
          and all(same_bits(a, b) for a, b in zip(got, saved[8])),
          f"(e) vault: snapshots {kept}; with a NaN in the newest R, restore_latest returns "
          f"step {step} on {got.R.device}, bit-equal to what was saved")
    for s in kept:
        p = root / "rls" / f"step_{s:08d}" / "leaves.npz"
        with np.load(p) as f:
            leaves = dict(f)
        leaves[".d"][0, 0] = np.inf
        np.savez(p, **leaves)
    try:
        vault.restore_latest("rls", like=state)
        raised = "nothing"
    except IntegrityError:
        raised = "IntegrityError"
    check(raised == "IntegrityError", f"(e) with every snapshot corrupted, restore_latest "
                                      f"raises {raised}")
    print(f"  (e) 12 updates of a ({n}, {n}) f64 state, 3 snapshots, two restores: "
          f"{time.perf_counter() - t0:.1f} s")
    lap("e")

    # (f) the CLI
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve_qr",
                          "--resilient", "--check", "--requests", "512"],
                         capture_output=True, text=True, env=env, timeout=600)
    lines = cli.stdout.strip().splitlines()
    check(cli.returncode == 0 and len(lines) == 2 and len(lines[-1].split(",")) == 3,
          f"(f) serve_qr --resilient --check --requests 512 exits {cli.returncode} with "
          f"{len(lines)} CSV lines: {lines[-1:]}")
    mesh = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve_qr",
                           "--mesh", "2"], capture_output=True, text=True, env=env,
                          timeout=300)
    check(mesh.returncode == 2, f"(f) serve_qr --mesh 2 exits {mesh.returncode} (2: not "
                                "ported yet)")

    lap("f")
    launches = {k: fn.launches for k, fn in kernels.items()}
    out["launches"] = launches
    out["shapes"] = {k: set(fn.shapes) for k, fn in kernels.items()}
    out["wall_s"]["phase"] = time.perf_counter() - t_phase
    print(f"  launches in phase 7: {launches} ({out['wall_s']['phase']:.1f} s wall)")
    check(launches["batched_update"] > 0, "phase 7 launched batched_update")
    return out


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
    phase("6. instrumented path and sketch least squares")
    inst = instrumented_phase(server, reqs, kernels, card)
    for name in kernels:
        recorded[name] |= inst["shapes"][name]

    # ------------------------------------------------------------ phase 7
    phase("7. resilient serving")
    resil = resilient_phase(reqs, kernels, card)
    for name in kernels:
        recorded[name] |= resil["shapes"][name]

    # ------------------------------------------------------------ phase 8
    phase("8. kernels vs plain versions at every main-path shape")
    n_shapes = sum(len(s) for s in recorded.values())
    recheck_worst = recheck_shapes(recorded, gen)
    print(f"  {n_shapes} (shape, dtype) launches rechecked; worst errors "
          f"{recheck_worst}")

    # ------------------------------------------------------------ phase 9
    phase("9. summary")
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
            "launches": (serve_launches[name] + dense_launches[name]
                         + inst["launches"][name] + resil["launches"][name]),
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
    print(f"  phase 6: {json.dumps({k: v for k, v in inst.items() if k != 'shapes'})}")
    print(f"  phase 7: {json.dumps({k: v for k, v in resil.items() if k != 'shapes'})}")
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
