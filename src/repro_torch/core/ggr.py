"""Generalized Givens Rotation (GGR) — the paper's core contribution.

Closed forms (derived from eq. 2 of the paper, 0-based indexing), annihilating
column ``c`` of ``X`` below the diagonal in ONE fused sweep:

    t_i     = sqrt( sum_{r>=i} x_{r,c}^2 )            (suffix norms; reverse cumsum)
    s_{i,j} = sum_{r>i} x_{r,c} * x_{r,j}             (suffix dots;  reverse cumsum)
    row c:    x'_{c,j}   = (x_{c,c} x_{c,j} + s_{c,j}) / t_c
    row i+1:  x'_{i+1,j} = k_i * s_{i,j} - l_i * x_{i,j}          (the DET2 grid)
              k_i = x_{i,c} / (t_i t_{i+1}),  l_i = t_{i+1} / t_i

Everything is expressed as reverse cumulative sums + elementwise FMA, i.e. the
paper's DOTk / DET2 macro-operations.  The compact factor of one column step is
``(v, t)`` — the annihilated column and its suffix norms — from which ``k, l``
are re-derived when the transform is replayed (``apply_ggr_factors``).

Every function takes an optional leading batch dimension (any number of
leading dims): ``X`` is ``(..., m, n)``, a column ``(..., m)``.  The batch
dimension replaces the ``vmap`` the JAX reference wraps around these sweeps;
each problem is swept independently, so a batched call equals a loop of
single-problem calls.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "GGRFactors",
    "ggr_column_step",
    "ggr_column_step_at",
    "ggr_qr2",
    "ggr_factor_column",
    "ggr_triangularize",
    "apply_ggr_factors",
    "suffix_norms",
]

_EPS = {torch.float64: 1e-300, torch.float32: 1e-30, torch.bfloat16: 1e-30}


def _eps_for(dtype) -> float:
    return _EPS.get(dtype, 1e-30)


def _acc_dtype(dtype) -> torch.dtype:
    """float32-promoted accumulation dtype (f64 stays f64)."""
    return torch.promote_types(dtype, torch.float32)


def _revcumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.flip(dim).cumsum(dim).flip(dim)


def suffix_norms(col: torch.Tensor) -> torch.Tensor:
    """t_i = sqrt(sum_{r>=i} col_r^2) via reverse cumsum (f32+ accumulation)."""
    acc = col.to(_acc_dtype(col.dtype))
    return torch.sqrt(_revcumsum(acc * acc, -1))


def scaled_column(v: torch.Tensor):
    """(v_scaled, t_scaled, sigma): overflow/underflow-safe column stats.

    All GGR update formulas are invariant under column scaling (k·S and l·x
    terms cancel sigma; the pivot row is P/t), so computing with v/sigma and
    its suffix norms is exact — this is the safe-Givens scaling of the
    paper's ref [26] applied to the fused form.  Only the annihilated-column
    diagonal needs sigma back: R[pivot, c] = sigma * t_scaled[pivot].
    ``sigma`` has shape ``(..., 1)``.
    """
    va = v.to(_acc_dtype(v.dtype))
    sigma = va.abs().amax(-1, keepdim=True)
    vs = va / torch.where(sigma > 0, sigma, 1.0)
    ts = suffix_norms(vs)
    return vs.to(v.dtype), ts.to(v.dtype), sigma.to(v.dtype)


class GGRFactors(NamedTuple):
    """Compact representation of one GGR column step (cf. Householder (v, tau)).

    v: the annihilated (masked) column, shape (..., m)
    t: its suffix norms,               shape (..., m)
    """

    v: torch.Tensor
    t: torch.Tensor


def _ggr_coeffs(v: torch.Tensor, t: torch.Tensor):
    """k, l vectors + validity mask from a (masked) column and its suffix norms."""
    eps = _eps_for(t.dtype)
    t_next = torch.cat([t[..., 1:], torch.zeros_like(t[..., :1])], dim=-1)
    valid = t_next > eps  # rotation at (i, i+1) is non-degenerate
    safe_t = torch.where(t > eps, t, 1.0)
    safe_tn = torch.where(valid, t_next, 1.0)
    k = v / (safe_t * safe_tn)
    l = safe_tn / safe_t
    return k, l, valid


def _ggr_update(X: torch.Tensor, v: torch.Tensor, t: torch.Tensor, pivot: int):
    """Apply one GGR column transform to all columns of X.

    ``v`` must be the active column masked to zero above ``pivot``; rows above
    ``pivot`` are left untouched.
    """
    f32 = _acc_dtype(X.dtype)
    Xa = X.to(f32)
    va = v.to(f32)
    ta = t.to(f32)
    eps = _eps_for(f32)

    prod = va[..., :, None] * Xa  # (..., m, n) — DOT partials
    P = _revcumsum(prod, -2)  # P_i = prod_i + S_i = sum_{r>=i}
    # exclusive suffix sum via SHIFT of the inclusive one — computing it as
    # P - prod cancels catastrophically when |prod_i| >> |tail|
    S = torch.cat([P[..., 1:, :], torch.zeros_like(P[..., :1, :])], dim=-2)

    k, l, valid = _ggr_coeffs(va, ta)

    # Pivot-row update extracted once (O(n)), not evaluated grid-wide: the
    # row-1 DOT of eq. 2 is (v·x_pivot + s_pivot)/t_pivot = P[pivot]/t_pivot.
    t_piv = ta[..., pivot:pivot + 1]  # (..., 1)
    pivot_row = P[..., pivot, :] / torch.where(t_piv > eps, t_piv, 1.0)

    # Candidate shifted DET2 update: new row i+1 from old row i.
    det2 = k[..., :-1, None] * S[..., :-1, :] - l[..., :-1, None] * Xa[..., :-1, :]
    det2 = torch.where(valid[..., :-1, None], det2, Xa[..., 1:, :])

    # rows < pivot untouched, row pivot <- pivot_row, rows > pivot <- DET2
    out = torch.cat([Xa[..., :pivot, :], pivot_row[..., None, :],
                     det2[..., pivot:, :]], dim=-2)
    # pivot-row guard: if the whole active column is ~0, no transform at all.
    do_any = (t_piv > eps)[..., None]
    out = torch.where(do_any, out, Xa)
    return out.to(X.dtype)


def ggr_column_step(X: torch.Tensor) -> torch.Tensor:
    """One GGR iteration: annihilate column 0 below the diagonal (eq. 2)."""
    return ggr_column_step_at(X, 0)


def ggr_column_step_at(X: torch.Tensor, c: int, pivot: int | None = None) -> torch.Tensor:
    """Annihilate column ``c`` below row ``pivot`` (default: the diagonal, c).

    ``pivot != c`` arises in panel factorization, where local column c of a
    panel sits at global pivot row ``panel_offset + c``.
    """
    if pivot is None:
        pivot = c
    v = X[..., c].clone()
    v[..., :pivot] = 0
    vs, ts, sigma = scaled_column(v)
    out = _ggr_update(X, vs, ts, pivot)
    t_piv = ts[..., pivot:pivot + 1]
    # exact zeros below the diagonal of the annihilated column
    newcol = torch.cat([out[..., :pivot, c], (sigma * t_piv).to(out.dtype),
                        torch.zeros_like(out[..., pivot + 1:, c])], dim=-1)
    newcol = torch.where(t_piv > _eps_for(ts.dtype), newcol, out[..., c])
    out[..., c] = newcol
    return out


def ggr_factor_column(X: torch.Tensor, c: int, pivot: int | None = None) -> GGRFactors:
    """Compact factors for the step annihilating column c below ``pivot``.

    Factors are stored in scaled form (v/sigma, t/sigma) — the replayed
    update formulas are scale-invariant, so apply needs no sigma.
    """
    if pivot is None:
        pivot = c
    v = X[..., c].clone()
    v[..., :pivot] = 0
    vs, ts, _ = scaled_column(v)
    return GGRFactors(v=vs, t=ts)


def apply_ggr_factors(factors: GGRFactors, X: torch.Tensor, pivot: int) -> torch.Tensor:
    """Replay a stored column transform on new columns X (the trailing update)."""
    return _ggr_update(X, factors.v, factors.t, pivot)


def ggr_triangularize(X: torch.Tensor, n_pivots: int) -> torch.Tensor:
    """GGR sweeps annihilating columns 0..n_pivots-1 below their diagonals.

    Unlike ``ggr_qr2`` this leaves trailing columns (>= n_pivots) as whatever
    the accumulated orthogonal transform maps them to — the primitive behind
    augmented-system least squares ([A | b] -> [R | Q^T b]) and row-append
    updating ([R | d; U | Y] -> [R' | d'; 0 | *]).  ``X`` is ``(m, w)`` or
    ``(B, m, w)``.
    """
    m = X.shape[-2]
    steps = min(m - 1, n_pivots) if m > 1 else 0
    R = X
    for c in range(steps):
        R = ggr_column_step_at(R, c)
    return R


def ggr_qr2(A: torch.Tensor, want_q: bool = False):
    """Unblocked GGR QR — ``dgeqr2ggr``.  Returns R (and Q if requested).

    Column loop with the fused one-sweep GGR step; the analogue of the paper's
    LAPACK ``lapack_dgeqr2ggr`` wrapper calling ``update()`` n times.
    """
    m, n = A.shape[-2:]
    steps = min(m - 1, n) if m > 1 else 0
    R = A
    if not want_q:
        for c in range(steps):
            R = ggr_column_step_at(R, c)
        return torch.triu(R)  # (m, n); exact zeros below the diagonal

    Qt = torch.eye(m, dtype=A.dtype, device=A.device).expand(
        *A.shape[:-2], m, m).contiguous()
    for c in range(steps):
        f = ggr_factor_column(R, c)
        R = ggr_column_step_at(R, c)
        Qt = apply_ggr_factors(f, Qt, c)
    return torch.triu(R), Qt.transpose(-1, -2)
