"""Column-pivoted GGR QR, numerical rank, and min-norm least squares.

The paper's eq. 3 sweep computes suffix column norms as its own rotation
coefficients, so greedy column pivoting (QRCP) costs one extra reverse
cumulative sum + argmax per elimination step — the pivot selector reads row
``c`` of the ``core.blocked.suffix_col_norms`` matrix, swaps the winning
column in, and the ordinary ``ggr_column_step_at`` annihilates it.  No new
datapath and no kernel of its own.

Tall problems are reduced first: ``[A | rhs]`` goes through the *unpivoted*
size-routed driver down to its top ``(n, n+k)`` block, and the pivoted sweep
runs on that small block only.  This is exact — ``QRCP(A) = Q1 · QRCP(R0)``
because the reduction is orthogonal and preserves every trailing column norm
the pivot selection reads.

Every function takes an optional leading batch dimension (the serving
``lstsq_pivoted`` kind's batch); ranks are then per problem.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.blocked import suffix_col_norms
from repro_torch.core.ggr import ggr_column_step_at, ggr_qr2
from repro_torch.solvers.lstsq import _triangularize_auto, solve_triangular

__all__ = [
    "PivotedQR",
    "PivotedLstsq",
    "estimate_rank",
    "ggr_qr_pivoted",
    "lstsq_pivoted",
]


class PivotedQR(NamedTuple):
    """Permutation-carrying compact factor state: ``A[:, perm] = Q R``.

    R: (min(m, n), n) upper triangular (trapezoidal when m < n)
    d: (min(m, n), k) top rows of Q^T rhs, or None when no rhs rode along
    perm: (n,) int64 column permutation (pivot order)
    tail: (k,) squared rhs norms from the reduced-away rows below R, or None
    """

    R: torch.Tensor
    d: torch.Tensor | None
    perm: torch.Tensor
    tail: torch.Tensor | None


class PivotedLstsq(NamedTuple):
    x: torch.Tensor       # (n, k) min-norm solution
    resid: torch.Tensor   # (k,) residual 2-norms ||A x - b||
    rank: torch.Tensor    # () int32 numerical rank used for the solve
    R: torch.Tensor       # pivoted factor state (see PivotedQR)
    d: torch.Tensor
    perm: torch.Tensor


def _pivoted_sweep(X: torch.Tensor, n_pivots: int):
    """Greedy QRCP sweep over the first ``n_pivots`` columns of X (..., m, w).

    Per step: row ``c`` of the suffix-column-norm matrix -> argmax over the
    not-yet-pivoted columns -> column swap -> ``ggr_column_step_at``.
    Trailing columns (>= n_pivots, e.g. an rhs) ride along unswapped.
    """
    m, w = X.shape[-2:]
    lead = X.shape[:-2]
    steps = min(m, n_pivots)
    dev = X.device
    cols = torch.arange(n_pivots, device=dev)
    perm = torch.arange(n_pivots, device=dev).expand(*lead, n_pivots)
    base = torch.arange(w, device=dev).expand(*lead, w)
    for c in range(steps):
        trail = suffix_col_norms(X[..., :n_pivots])[..., c, :]
        j = torch.argmax(torch.where(cols >= c, trail, -1.0), dim=-1, keepdim=True)
        idx = base.clone()
        idx[..., c:c + 1] = j
        idx.scatter_(-1, j, c)
        X = torch.gather(X, -1, idx[..., None, :].expand(*lead, m, w))
        perm = torch.gather(perm, -1, idx[..., :n_pivots])
        # the last row needs no annihilation (matches ggr_qr2's step count)
        if c < m - 1:
            X = ggr_column_step_at(X, c)
    return X, perm


def ggr_qr_pivoted(A: torch.Tensor, rhs: torch.Tensor | None = None) -> PivotedQR:
    """Column-pivoted GGR QR of A with an optional rhs riding along.

    Tall A is first reduced unpivoted through the size-routed driver (column
    norms are preserved by the orthogonal reduction, so pivoting on the small
    top block is exact QRCP); the pivoted sweep then runs on the
    ``(min(m, n), n [+ k])`` block.  ``rhs`` may be ``(m,)`` or ``(m, k)``.
    """
    m, n = A.shape[-2:]
    k = 0
    X = A
    acc = torch.promote_types(A.dtype, torch.float32)
    if rhs is not None:
        B = rhs[..., None] if rhs.ndim == A.ndim - 1 else rhs
        k = B.shape[-1]
        X = torch.cat([A, B.to(A.dtype)], dim=-1)
    tail = None
    if m > n:
        X = _triangularize_auto(X, n)
        if rhs is not None:
            tail = torch.sum(X[..., n:, n:].to(acc) ** 2, dim=-2)
        X = X[..., :n, :]
    elif rhs is not None:
        tail = torch.zeros((*A.shape[:-2], k), dtype=acc, device=A.device)
    X, perm = _pivoted_sweep(X, n)
    R = torch.triu(X[..., :n])
    d = X[..., n:] if rhs is not None else None
    return PivotedQR(R=R, d=d, perm=perm, tail=tail)


def estimate_rank(R: torch.Tensor, rcond: float | None = None) -> torch.Tensor:
    """Numerical rank of a (pivoted) triangular factor: the rcond-relative
    diag test ``#{i : |r_ii| > rcond * max_j |r_jj|}``.

    QRCP orders the diagonal to decay, so this is the standard cheap
    estimator (same convention as ``numpy.linalg.lstsq``'s cutoff applied
    to the R diagonal).  Default rcond is ``max(R.shape) * eps(dtype)``.
    Returns an int32 tensor (one rank per problem when batched).
    """
    diag = torch.diagonal(R, dim1=-2, dim2=-1).abs()
    if rcond is None:
        rcond = max(R.shape[-2:]) * torch.finfo(R.dtype).eps
    if diag.shape[-1]:
        dmax = diag.amax(-1, keepdim=True)
    else:
        dmax = diag.new_zeros((*diag.shape[:-1], 1))
    return torch.sum(diag > rcond * dmax, dim=-1).to(torch.int32)


def _min_norm_from_state(R, d, perm, tail, rank):
    """Min-norm solve from a pivoted state with a per-problem rank.

    Complete orthogonal decomposition with masking instead of shape slicing:
    rows of (R, d) at or beyond ``rank`` are zeroed, the masked ``R^T`` gets
    its own GGR QR (``R_r^T = Q2 T``), and the triangular solves'
    eps-guarded diagonals keep every beyond-rank component exactly zero —
    so one code path serves every rank of the batch.
    """
    mm, n = R.shape[-2:]
    keep = (torch.arange(mm, device=R.device) < rank[..., None])[..., None]
    Rm = torch.where(keep, R, 0.0)
    dm = torch.where(keep, d, 0.0)
    T, Q2 = ggr_qr2(Rm.transpose(-1, -2), want_q=True)  # (n, mm) triu, (n, n)
    z = solve_triangular(torch.triu(T[..., :mm, :]), dm, trans=True)
    y = Q2[..., :, :mm] @ z                  # min-norm solution, permuted coords
    x = torch.zeros((*y.shape[:-2], n, d.shape[-1]), dtype=y.dtype, device=y.device)
    x = x.scatter(-2, perm[..., None].expand_as(y), y)
    # honest residual: the dropped rows of the *unmasked* state still hold
    # (small) mass — score y against them, plus the reduced-away tail
    f32 = torch.promote_types(R.dtype, torch.float32)
    rrows = (d - R @ y).to(f32)
    resid = torch.sqrt(torch.sum(rrows * rrows, dim=-2) + tail)
    return x, resid.to(R.dtype)


def lstsq_pivoted(A: torch.Tensor, b: torch.Tensor,
                  rcond: float | None = None) -> PivotedLstsq:
    """Rank-aware min ||Ax - b||: pivoted QR + min-norm solve.

    Unlike ``solvers.ggr_lstsq`` this never divides by a collapsed pivot:
    the numerical rank r comes from ``estimate_rank(R, rcond)`` and the
    solution is the minimum-norm x over the rank-r truncation — the same
    contract as ``numpy.linalg.lstsq`` (whose ``rcond`` this mirrors),
    computed without an SVD.  Accepts m < n as well.
    """
    vec = b.ndim == A.ndim - 1
    st = ggr_qr_pivoted(A, b)
    rank = estimate_rank(st.R, rcond)
    x, resid = _min_norm_from_state(st.R, st.d, st.perm, st.tail, rank)
    if vec:
        return PivotedLstsq(x=x[..., 0], resid=resid[..., 0], rank=rank,
                            R=st.R, d=st.d[..., 0], perm=st.perm)
    return PivotedLstsq(x=x, resid=resid, rank=rank,
                        R=st.R, d=st.d, perm=st.perm)
