"""Blocked GGR QR — ``dgeqrfggr`` as a panel pipeline over the GGR kernels.

The driver (``ggr_qr_blocked`` / ``ggr_triangularize_blocked``) is a
right-looking panel algorithm, a Python loop over panels.  Two schedules
share that loop:

``schedule="tree"`` — the batched-GEMM schedule (what ``"auto"`` runs on CPU
tensors)
    Per panel: every row tile of the panel is factored independently by one
    batched GEQRT launch (``kernels.batched_geqrt``, identity riding along so
    each tile also emits its explicit b x b transform Qt); the per-tile R
    factors are then coupled through a TSQR-style *binary tree* — log2(p)
    rounds of batched triangular-vs-triangular couplings via
    ``kernels.batched_update`` (the compact (b+1)-row active-set sweep) — and
    every transform is replayed onto the trailing matrix as batched GEMMs with
    the small Qt tiles.  GGR's per-column transform is Hessenberg-structured,
    so there is no rank-b compact WY form; at tile size 64 an explicit Qt is
    small and turns every trailing update into a plain ``torch.bmm``.

``schedule="fused"`` — the paper's merged UPDATE_ROW1/UPDATE schedule (what
``"auto"`` runs on CUDA tensors)
    Per panel: one ``kernels.ggr_panel.panel_factor`` launch factors the whole
    (F, b) panel and stores its compact (V, T) factors, then ONE
    ``kernels.ggr_apply.apply_factors`` launch replays all b transforms over
    the trailing columns in one bottom-up pass over each column, the b
    transforms as a pipeline of b stages — b-fold reuse of every element read
    instead of per-tile GEMMs.  Only the columns right
    of the panel are updated, in place: columns left of it are exact zeros in
    the frame's rows, and the panel's own columns are overwritten by its R.

``"auto"`` resolves as the reference does: ``"tree"`` on a CPU tensor, where
the kernels' plain versions run (the port's interpret mode), and ``"fused"``
on a CUDA tensor, where the kernels run.

Panel k works on a *frame*: the rows from its first pivot row down, a plain
slice.  Frame heights halve across O(log) phases as rows finalize
(``_phase_schedule``), exactly as the reference's static frames do, and
``kernels.pad_to_tile`` rounds arbitrary (m, n) up to the tile grid (zero
rows/cols are exact fixed points of the eps-guarded sweeps).

Every entry point takes an optional leading batch dimension: B problems x p
row tiles fold into ONE ``batched_geqrt`` launch per panel and B x npair
pairs into ONE ``batched_update`` launch per tree round; the fused schedule
makes one ``panel_factor`` and one ``apply_factors`` launch per panel for the
whole batch.

With an ``obs`` collector installed, each panel's phases run under the
spans ``repro/blocked/{panel,coupling,trailing}``, the whole call under
``repro/blocked/triangularize``, and the call is recorded as one
``blocked`` dispatch (its seconds, blocked on the result, and the flops of
the sweep model ``ggr_sweep_mults``).

``ggr_geqrt`` / ``ggr_tsqrt`` are the explicit-Q tile primitives, and
``ggr_qr_blocked_reference`` is the Python-unrolled PLASMA-style tile
algorithm with its serial TSQRT chain — plain PyTorch over ``core.ggr``.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels.backend import (Precision, count_resolution, dtype_name,
                                         resolve_precision, to_tile)
from repro_torch.kernels.backend import forced_schedule as backend_forced_schedule
from repro_torch.kernels.ggr_apply import apply_factors
from repro_torch.kernels.ggr_panel import batched_geqrt, panel_factor
from repro_torch.kernels.ggr_update import batched_update, pad_to_tile

from .ggr import apply_ggr_factors, ggr_column_step_at, ggr_factor_column

__all__ = [
    "ggr_geqrt",
    "ggr_tsqrt",
    "ggr_qr_blocked",
    "ggr_qr_blocked_reference",
    "ggr_triangularize_blocked",
    "suffix_col_norms",
]


def ggr_geqrt(tile: torch.Tensor):
    """Factor one (m x b) tile (or a (..., m, b) batch); returns (R_tile, Qt)
    with Qt @ tile = R."""
    m, b = tile.shape[-2:]
    R = tile
    Qt = torch.eye(m, dtype=tile.dtype, device=tile.device).expand(
        *tile.shape[:-2], m, m).contiguous()
    for c in range(min(m - 1, b)):
        f = ggr_factor_column(R, c)
        R = ggr_column_step_at(R, c)
        Qt = apply_ggr_factors(f, Qt, c)
    return torch.triu(R), Qt


def ggr_tsqrt(R_top: torch.Tensor, B: torch.Tensor):
    """Stacked factorization of [R_top; B] (R_top upper-triangular b x b).

    Returns (R_new, Qt_stacked) with Qt_stacked @ [R_top; B] = [R_new; 0].
    """
    b = R_top.shape[-1]
    R, Qt = ggr_geqrt(torch.cat([R_top, B], dim=-2))
    return R[..., :b, :], Qt


def ggr_qr_blocked_reference(A: torch.Tensor, tile: int = 128) -> torch.Tensor:
    """The PLASMA-style tile algorithm (§4.1.1), unrolled: (p x q) tile loops
    with a serial per-row-tile TSQRT chain and one small GEMM per (i, j) tile.

    A compact executable statement of the tile algorithm, kept as the
    baseline the blocked driver is measured against.  ``m`` and ``n`` must be
    tile multiples.
    """
    m, n = A.shape[-2:]
    if m % tile or n % tile:
        raise ValueError(f"ggr_qr_blocked_reference: pad ({m}, {n}) to tile "
                         f"multiples of {tile} first")
    p, q, t = m // tile, n // tile, tile
    R = A.clone()

    def blk(i, j):
        return R[..., i * t:(i + 1) * t, j * t:(j + 1) * t]

    for k in range(min(p, q)):
        # 1) diagonal tile factor, 2) row update of the tiles right of it
        r_kk, Qt = ggr_geqrt(blk(k, k))
        blk(k, k)[...] = r_kk
        for j in range(k + 1, q):
            blk(k, j)[...] = Qt @ blk(k, j)
        # 3) couple every tile below the diagonal + paired trailing updates
        for i in range(k + 1, p):
            r_new, Qt2 = ggr_tsqrt(blk(k, k), blk(i, k))
            blk(k, k)[...] = r_new
            blk(i, k)[...] = 0
            for j in range(k + 1, q):
                upd = Qt2 @ torch.cat([blk(k, j), blk(i, j)], dim=-2)
                blk(k, j)[...] = upd[..., :t, :]
                blk(i, j)[...] = upd[..., t:, :]
    return torch.triu(R)


def suffix_col_norms(X: torch.Tensor) -> torch.Tensor:
    """Squared suffix column norms ``t2[..., i, j] = sum_{r>=i} X[..., r, j]^2``.

    The matrix-wide form of the paper's eq. 3 DOT_k macro-op: one reverse
    cumulative sum yields every candidate column's trailing norm at every
    elimination depth (what ``ranks.ggr_qr_pivoted`` reads to pick pivots).
    f32-promoted accumulation, matching ``core.ggr.suffix_norms``.
    """
    acc = X.to(torch.promote_types(X.dtype, torch.float32))
    return (acc * acc).flip(-2).cumsum(-2).flip(-2)


def _tree_levels(p: int):
    """Static binary-tree pairing over p row tiles: [(ai, bi), ...] per round.

    Round r couples nodes ``ai[j]`` (survivor, receives the coupled R) with
    ``bi[j]``; node 0 — the tile holding the pivot rows — survives every
    round, so the final panel R lands in tile 0.  Odd leftovers propagate to
    the next round: log2(p) depth instead of the serial chain's p - 1.
    """
    levels = []
    nodes = list(range(p))
    while len(nodes) > 1:
        pairs = list(zip(nodes[0::2], nodes[1::2]))
        levels.append((np.asarray([a for a, _ in pairs]),
                       np.asarray([b for _, b in pairs])))
        nodes = sorted([a for a, _ in pairs]
                       + (nodes[-1:] if len(nodes) % 2 else []))
    return levels


def _phase_schedule(m: int, b: int, nk: int):
    """[(k_start, k_end, F)]: frame heights shrink by halves as rows finalize.

    Panel k only involves rows >= k*b; one frame tall enough for panel 0
    would waste ~2x on the later panels, so the panel loop is split into
    O(log) phases whose frame height F halves once the active height fits in
    F/2.  F is always a tile multiple and at least 2b.
    """
    phases = []
    F = -(-max(m, b) // b) * b
    k = 0
    while k < nk:
        if F <= 2 * b:
            k_end = nk
        else:
            k_end = min(nk, max(k + 1, -(-(m - F // 2) // b)))
        phases.append((k, k_end, F))
        k = k_end
        F = max(2 * b, -(-(F // 2) // b) * b)
    return phases


def _gemm(lhs: torch.Tensor, rhs: torch.Tensor, accum_dtype) -> torch.Tensor:
    """Batched tile GEMM; low-precision operands accumulate at accum_dtype.

    ``accum_dtype=None`` multiplies at operand dtype.  With an accumulation
    dtype the operands are widened, multiplied, and the result rounded back
    to tile dtype — the GEMM analogue of the kernels' in-body accumulation.
    """
    if accum_dtype is None:
        return torch.bmm(lhs, rhs)
    ad = getattr(torch, accum_dtype)
    return to_tile(torch.bmm(lhs.to(ad), rhs.to(ad)), lhs.dtype)


def _span(name: str):
    """A phase span when a collector is installed, else nothing."""
    return obs.named_span(name) if obs.enabled() else contextlib.nullcontext()


def _panel_step_tree(Xp: torch.Tensor, k: int, *, b: int, F: int, W: int,
                     block_b, accum_dtype=None) -> None:
    """One tree-scheduled panel, in place on ``Xp`` (B, rows, W): batched tile
    GEQRT -> log-depth coupling -> GEMM trailing updates, all on the (F, W)
    frame starting at the pivot row."""
    B = Xp.shape[0]
    p = F // b
    dtype, dev = Xp.dtype, Xp.device
    prec = (None if accum_dtype is None
            else Precision(dtype_name(dtype), accum_dtype, dtype_name(dtype)))
    eye = torch.eye(b, dtype=dtype, device=dev)
    c0 = k * b
    frame = Xp[:, c0:c0 + F]  # (B, F, W) view
    pan = frame[:, :, c0:c0 + b].reshape(B * p, b, b)

    # level 0: factor every row tile of every problem independently, identity
    # riding -> Qt_i; ONE launch for all B*p tiles
    with _span("repro/blocked/panel"):
        tiles = torch.cat([pan, eye.expand(B * p, b, b)], dim=2)
        out0 = batched_geqrt(tiles, n_pivots=b, block_b=block_b or B * p,
                             precision=prec)
        R = out0[:, :, :b].reshape(B, p, b, b)
    with _span("repro/blocked/trailing"):
        C = _gemm(out0[:, :, b:], frame.reshape(B * p, b, W),
                  accum_dtype).reshape(B, p, b, W)

    # binary-tree coupling of the per-tile R factors (log2(p) rounds); each
    # round is ONE batched compact-active-set sweep + ONE batched GEMM
    for ai, bi in _tree_levels(p):
        npair = len(ai)
        ai, bi = torch.as_tensor(ai, device=dev), torch.as_tensor(bi, device=dev)
        with _span("repro/blocked/coupling"):
            E = eye.expand(B, npair, b, b)
            Z = torch.zeros((B, npair, b, b), dtype=dtype, device=dev)
            stacked = torch.cat([torch.cat([R[:, ai], E, Z], dim=3),
                                 torch.cat([R[:, bi], Z, E], dim=3)], dim=2)
            out = batched_update(stacked.reshape(B * npair, 2 * b, 3 * b),
                                 n_pivots=b, block_b=block_b or B * npair,
                                 precision=prec).reshape(B, npair, 2 * b, 3 * b)
            R[:, ai] = out[:, :, :b, :b]
            Qt = out[:, :, :, b:].reshape(B * npair, 2 * b, 2 * b)  # node transform
        with _span("repro/blocked/trailing"):
            Ct = torch.cat([C[:, ai], C[:, bi]], dim=2).reshape(B * npair, 2 * b, W)
            Ct = _gemm(Qt, Ct, accum_dtype).reshape(B, npair, 2 * b, W)
            C[:, ai] = Ct[:, :, :b]
            C[:, bi] = Ct[:, :, b:]

    frame[:] = C.reshape(B, F, W)
    # exact panel-column write: [R; 0] (keeps finalized columns exactly zero
    # below their pivots, which is what makes later frames' GEMMs exact
    # no-ops on them)
    frame[:, :b, c0:c0 + b] = torch.triu(R[:, 0])
    frame[:, b:, c0:c0 + b] = 0


def _panel_step_fused(Xp: torch.Tensor, k: int, *, b: int, F: int,
                      block_w: int, accum_dtype=None) -> None:
    """One fused-scheduled panel, in place on ``Xp`` (B, rows, W): one panel
    kernel launch factors the (F, b) panel at the frame's pivot row, one apply
    launch replays its transforms over the columns right of it."""
    dtype = Xp.dtype
    prec = (None if accum_dtype is None
            else Precision(dtype_name(dtype), accum_dtype, dtype_name(dtype)))
    c0 = k * b
    frame = Xp[:, c0:c0 + F]  # (B, F, W) view
    with _span("repro/blocked/panel"):
        Rp, V, T = panel_factor(frame[:, :, c0:c0 + b], pivot0=0, precision=prec)
    C = frame[:, :, c0 + b:]
    if C.shape[2]:  # a pure QR's last panel has no trailing columns
        with _span("repro/blocked/trailing"):
            apply_factors(V, T, C, pivot0=0, block_w=block_w, precision=prec,
                          out=C)
    frame[:, :, c0:c0 + b] = Rp


def _triangularize_blocked_impl(X: torch.Tensor, n_pivots: int, tile: int,
                                schedule: str, block_w, block_b,
                                accum_dtype=None) -> torch.Tensor:
    B, m, w = X.shape
    b = min(tile, -(-n_pivots // 8) * 8)
    np_pad = -(-n_pivots // b) * b
    nk = np_pad // b

    # pad the pivot block up to a tile multiple (zero columns between the
    # pivots and any trailing rhs columns — exact no-op sweeps)
    if np_pad != n_pivots:
        if n_pivots == w:
            X = pad_to_tile(X, (b,), axes=(2,))
        else:
            X = torch.cat([X[:, :, :n_pivots],
                           X.new_zeros((B, m, np_pad - n_pivots)),
                           X[:, :, n_pivots:]], dim=2)
    W = X.shape[2]

    phases = _phase_schedule(m, b, nk)
    # rows: frames slide down b per panel, so the tail needs zero rows out to
    # the last frame's bottom edge (zero rows are exact sweep fixed points)
    total = max(F + (e - 1) * b for (_, e, F) in phases)
    Xp = torch.cat([X, X.new_zeros((B, total - m, W))], dim=1)

    for s, e, F in phases:
        for k in range(s, e):
            if schedule == "tree":
                _panel_step_tree(Xp, k, b=b, F=F, W=W, block_b=block_b,
                                 accum_dtype=accum_dtype)
            else:
                _panel_step_fused(Xp, k, b=b, F=F, block_w=block_w or 256,
                                  accum_dtype=accum_dtype)

    out = Xp[:, :m]
    if np_pad != n_pivots:
        out = torch.cat([out[:, :, :n_pivots], out[:, :, np_pad:]], dim=2)
    return out


def ggr_triangularize_blocked(X: torch.Tensor, n_pivots: int | None = None,
                              tile: int = 64, schedule: str = "auto",
                              block_w: int | None = None,
                              block_b: int | None = None,
                              precision=None) -> torch.Tensor:
    """Blocked GGR sweeps annihilating columns 0..n_pivots-1 below their
    diagonals; trailing columns (rhs) ride along as ``Q^T``-transformed data.

    The blocked sibling of ``core.ggr.ggr_triangularize``: same semantics,
    panel-pipeline execution (see module docstring).  Accepts arbitrary
    ``(m, w)`` — tile padding is internal — or a batch ``(B, m, w)``.

    schedule: ``"tree"`` (batched tile GEQRT + log-depth coupling + GEMM
    trailing), ``"fused"`` (one panel kernel + one trailing apply launch per
    panel) or ``"auto"``, which resolves to ``"tree"`` on a CPU tensor and to
    ``"fused"`` on a CUDA tensor.  A
    ``kernels.backend.degraded_mode(schedule=...)`` override outranks the
    argument.  ``block_w`` (fused) and ``block_b`` (tree) are kept for the JAX
    signature and must be positive when given; the CUDA kernels pick their
    own tiling.

    precision: mixed-precision policy (``Precision`` / name / None).  The
    input is cast to the policy's compute dtype at entry; suffix-norm and
    DET2 accumulation inside the kernels — and the trailing-GEMM partials —
    run at the policy's (wider) accumulation dtype.  ``None`` keeps
    everything at the input dtype.
    """
    m, w = X.shape[-2:]
    if n_pivots is None:
        n_pivots = min(m, w)
    if not 0 < n_pivots <= w:
        raise ValueError(f"n_pivots {n_pivots} out of range for width {w}")
    if schedule not in ("auto", "tree", "fused"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if block_w is not None and block_w <= 0:
        raise ValueError(f"block_w must be positive, got {block_w}")
    count_resolution(X)
    sched = backend_forced_schedule() or schedule
    if sched == "auto":
        sched = "tree" if X.device.type == "cpu" else "fused"
    accum_dtype = None
    if precision is not None:
        prec = resolve_precision(precision)
        X = to_tile(X, prec.compute)
        accum_dtype = prec.accum_dtype
    batched = X.ndim == 3
    Xb = X if batched else X[None]
    if not obs.enabled():
        out = _triangularize_blocked_impl(Xb, n_pivots, tile, sched, block_w,
                                          block_b, accum_dtype=accum_dtype)
        return out if batched else out[0]
    with obs.span("repro/blocked/triangularize"):
        t0 = time.perf_counter()
        out = _triangularize_blocked_impl(Xb, n_pivots, tile, sched, block_w,
                                          block_b, accum_dtype=accum_dtype)
        obs.block_ready(out)
        sweep_flops = Xb.shape[0] * obs.ggr_sweep_flops(m, w, n_pivots)
        dt = dtype_name(X.dtype)
        obs.record_dispatch("blocked", sweep_flops, time.perf_counter() - t0,
                            schedule=sched,
                            by_dtype=obs.flops_by_dtype(sweep_flops, dt,
                                                        accum_dtype),
                            precision=dt)
    return out if batched else out[0]


def ggr_qr_blocked(A: torch.Tensor, tile: int = 64, schedule: str = "auto",
                   block_w: int | None = None, block_b: int | None = None,
                   precision=None) -> torch.Tensor:
    """Blocked GGR QR of an arbitrary (m, n) matrix (or a (B, m, n) batch);
    returns the (m, n) R.

    Panel pipeline over the GGR kernels — see the module docstring for the
    two schedules.  There is no ``m % tile == 0`` restriction.
    """
    m, n = A.shape[-2:]
    if min(m, n) == 0:
        return torch.triu(A)
    R = ggr_triangularize_blocked(A, min(m, n), tile=tile, schedule=schedule,
                                  block_w=block_w, block_b=block_b,
                                  precision=precision)
    return torch.triu(R)
