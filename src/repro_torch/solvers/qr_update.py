"""QR up/downdating of a stored ``(R, d)`` least-squares state.

Givens rotations are *the* canonical tool for factorization updating — this
module expresses all three update kinds in the paper's macro-op vocabulary
(suffix/prefix sums + elementwise DET2 FMA), so the same fused kernel path
that accelerates factorization accelerates streaming updates:

* ``qr_append_rows`` — add p observation rows: one GGR sweep over the stacked
  ``[R | d; U | Y]`` matrix (``ggr_triangularize``).
* ``qr_downdate_row`` — remove a row (sliding window).  The LINPACK ``dchdd``
  rotation cascade collapses to closed form: with ``q = R^{-T} u`` and
  ``t_k = sqrt(alpha^2 + sum_{j>=k} q_j^2)`` (a *seeded suffix norm*,
  ``alpha^2 = 1 - |q|^2``), the downdated rows are exactly a DET2 grid

      R'_k = l_k R_k - k_k S_k,   k_k = q_k/(t_k t_{k+1}),  l_k = t_{k+1}/t_k

  with S the exclusive suffix dots of q against R's rows — the same
  coefficients as ``core.ggr`` with the annihilation sign flipped.
* ``qr_rank1_update`` — symmetric Gram update R^T R + w·v v^T: dispatches to
  append (w >= 0) or downdate (w < 0) with the scaled row sqrt(|w|)·v.

State convention: R upper triangular with **non-negative diagonal** (GGR
produces this; downdating re-normalizes), d = Q^T b restricted to the top n
rows.  Invariants maintained: ``R^T R = sum_i u_i u_i^T`` and
``R^T d = sum_i u_i y_i`` over the observation stream.
"""
from __future__ import annotations

import torch

from repro_torch.core.ggr import _eps_for, ggr_triangularize
from repro_torch.kernels import batched_update, resolve_precision

__all__ = [
    "qr_append_rows",
    "qr_append_rows_batched",
    "qr_downdate_row",
    "qr_rank1_update",
]


def _tri_solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Forward substitution L x = B for lower-triangular L; B is (..., n, k).

    Row-sequential loop (n steps of an n·k DOT each) — the DOT-chain dual of
    the suffix-sum sweeps used everywhere else; no LAPACK dependency.
    """
    n = L.shape[-1]
    f32 = torch.promote_types(L.dtype, torch.float32)
    La, Ba = L.to(f32), B.to(f32)
    eps = _eps_for(f32)
    diag = torch.diagonal(La, dim1=-2, dim2=-1)
    safe_diag = torch.where(diag.abs() > eps, diag, 1.0)
    X = torch.zeros_like(Ba)
    for i in range(n):
        # x_i = (b_i - L[i, :] @ x) / L_ii ; x_j = 0 for j >= i so the full
        # row dot only picks up already-solved entries.
        s = (La[..., i, :, None] * X).sum(-2)
        X[..., i, :] = (Ba[..., i, :] - s) / safe_diag[..., i, None]
    return X.to(B.dtype)


def _stack_update(R, U, d, Y):
    """Stack [R | d; U | Y] for the augmented append sweep (rhs optional)."""
    if d is None:
        return torch.cat([R, U], dim=-2)
    top = torch.cat([R, d], dim=-1)
    bot = torch.cat([U, Y], dim=-1)
    return torch.cat([top, bot], dim=-2)


def qr_append_rows(R: torch.Tensor, U: torch.Tensor, d: torch.Tensor | None = None,
                   Y: torch.Tensor | None = None):
    """Update R (and rhs state d) for p appended observation rows U (and Y).

    Plain reference path: one GGR sweep over the (n+p, n[+k]) stacked
    matrix.  Returns R' or (R', d').  Cost O(n^2 (n+p)) vs O(n^2 m) for
    re-factorizing the full m-row history — independent of stream length.
    """
    n = R.shape[-1]
    if (d is None) != (Y is None):
        raise ValueError("pass both d and Y, or neither")
    X = ggr_triangularize(_stack_update(R, U, d, Y), n)
    R_new = torch.triu(X[..., :n, :n])
    if d is None:
        return R_new
    return R_new, X[..., :n, n:]


def _update_stacked(stacked: torch.Tensor, n: int, backend: str, block_b: int,
                    precision=None) -> torch.Tensor:
    """Batched sweep over stacked (B, n+p, w) problems.

    ``precision`` must already be resolved (a ``kernels.Precision`` or None).
    The reference backend casts to the compute dtype and relies on
    ``ggr_triangularize``'s own float32-promoted accumulation.
    """
    if backend == "reference":
        if precision is not None:
            stacked = stacked.to(precision.compute)
        return ggr_triangularize(stacked, n)
    if backend != "pallas":
        raise ValueError(f"unknown backend {backend!r}")
    return batched_update(stacked, n_pivots=n, block_b=block_b,
                          precision=precision)


def qr_append_rows_batched(R: torch.Tensor, U: torch.Tensor,
                           d: torch.Tensor | None = None,
                           Y: torch.Tensor | None = None,
                           *, backend: str = "pallas",
                           block_b: int = 8,
                           mesh=None, precision=None):
    """Batch of independent row-append updates in one fused kernel launch.

    R: (B, n, n) upper triangular, U: (B, p, n), optional d: (B, n, k),
    Y: (B, p, k).  backend "pallas" (the name of the kernel path) runs the
    batched row-append kernel — on CUDA tensors the hand-written CUDA kernel,
    on CPU tensors its plain version — whose compact active-set schedule
    *relies* on R's triangularity; "reference" runs the plain batched
    stacked sweep.  Both produce the unique non-negative-diagonal factor,
    agreeing to roundoff.

    ``mesh=`` (sharded dispatch) is not ported yet and raises
    ``NotImplementedError``.
    """
    if mesh is not None:
        raise NotImplementedError("sharded (mesh=) dispatch is not ported yet")
    n = R.shape[2]
    if (d is None) != (Y is None):
        raise ValueError("pass both d and Y, or neither")
    if precision is not None:
        precision = resolve_precision(precision)
    out = _update_stacked(_stack_update(R, U, d, Y), n, backend, block_b,
                          precision=precision)
    R_new = torch.triu(out[:, :n, :n])
    if d is None:
        return R_new
    return R_new, out[:, :n, n:]


def _downdate_core(R, u, d, y, guard=None):
    """Closed-form Givens downdate (macro-op form).  See module docstring.

    Solving R^T q = u places the removed row in the rotation cascade's last
    column; the cascade's compound coefficients telescope into GGR's own
    (k, l) form because prod_{i<j} c_i = t_j / t_0.  The rhs recurrence
    zeta_k = (zeta_{k-1} - s_k d_k)/c_k telescopes the same way into a
    prefix dot:  zeta_{k-1} = (t_0 y - sum_{j<k} q_j d_j) / t_k.

    ``guard`` (a ``ranks.DowndateGuard``) intercepts the hyperbolic blow-up:
    ``alpha^2 = 1 - ||q||^2`` measures the distance to the rank cliff, and
    the guard damps the removed row, refuses the downdate, or raises before
    the cascade divides by a vanishing ``alpha``.
    """
    f32 = torch.promote_types(R.dtype, torch.float32)
    Ra = R.to(f32)
    qv = _tri_solve_lower(Ra.T, u.to(f32)[:, None])[:, 0]
    eps = _eps_for(f32)
    triggered = None
    if guard is not None:
        # lazy: solvers <-> ranks would otherwise be a load-time cycle
        from repro_torch.ranks.monitor import _record_guard_trigger, guard_downdate_q

        guard.validate()
        if guard.mode == "raise":
            alpha2_0 = float(1.0 - qv @ qv)
            if alpha2_0 < guard.tau:
                raise FloatingPointError(
                    f"downdate rejected by guard: alpha^2 = 1 - ||R^-T u||^2 "
                    f"= {alpha2_0:.3e} < tau = {guard.tau:.1e} — removing "
                    "this row would push the factor across the rank cliff.  "
                    "Re-factorize the window, or use "
                    "DowndateGuard(mode='damp'/'refuse').")
        qv, triggered = guard_downdate_q(qv, guard)
        _record_guard_trigger(triggered)
    alpha2 = torch.clamp(1.0 - qv @ qv, min=eps)  # <=0 means u not in the factorization
    suff = (qv * qv).flip(0).cumsum(0).flip(0)
    t = torch.sqrt(alpha2 + suff)  # seeded suffix norms, t_n = alpha
    t_next = torch.cat([t[1:], torch.sqrt(alpha2)[None]])
    kk = qv / (t * t_next)
    ll = t_next / t

    P = (qv[:, None] * Ra).flip(0).cumsum(0).flip(0)  # inclusive suffix dots
    S = torch.cat([P[1:], torch.zeros_like(P[:1])], dim=0)  # exclusive
    R_new = ll[:, None] * Ra - kk[:, None] * S  # DET2 grid, annihilation sign flipped

    d_new = None
    if d is not None:
        da, ya = d.to(f32), y.to(f32)
        Pd = torch.cumsum(qv[:, None] * da, dim=0)
        Pd_excl = torch.cat([torch.zeros_like(Pd[:1]), Pd[:-1]], dim=0)
        zeta_prev = (t[0] * ya[None, :] - Pd_excl) / t[:, None]
        d_new = (t[:, None] * da - qv[:, None] * zeta_prev) / t_next[:, None]

    # canonical non-negative diagonal (makes downdate the exact inverse of
    # append, which always produces sigma·t >= 0 pivots)
    sg = torch.sign(torch.diagonal(R_new))
    sg = torch.where(sg == 0, 1.0, sg)
    R_new = torch.triu(sg[:, None] * R_new)
    if d_new is not None:
        d_new = sg[:, None] * d_new
    if triggered is not None and guard.mode == "refuse":
        # keep the original state when the guard fired: a select on the
        # device, so the unguarded path never reads ``triggered`` back
        R_new = torch.where(triggered, Ra, R_new)
        if d_new is not None:
            d_new = torch.where(triggered, d.to(d_new.dtype), d_new)
    return R_new.to(R.dtype), None if d is None else d_new.to(R.dtype)


def qr_downdate_row(R: torch.Tensor, u: torch.Tensor, d: torch.Tensor | None = None,
                    y: torch.Tensor | None = None, *, guard=None):
    """Remove observation row (u, y) from the state — sliding-window forget.

    ``u`` must be a row previously incorporated into R (a downdate of a row
    not in the span is clamped, not detected).  Returns R' or (R', d').

    ``guard``: an optional ``ranks.DowndateGuard``.  Downdating is
    hyperbolic — it removes information — and a row that carries (nearly)
    all remaining mass in some direction drives ``alpha^2 = 1 - ||R^-T u||^2``
    to zero, after which the factor is numerically singular.  The guard
    bounds ``alpha^2`` from below by ``tau``: ``mode="damp"`` shrinks the
    removed row to sit exactly at the floor, ``"refuse"`` keeps the state
    unchanged bit for bit, ``"raise"`` throws a ``FloatingPointError``
    diagnostic (PyTorch runs eagerly, so it always raises).  Trips are
    counted as ``solvers.downdate_guard_trips`` when a collector is
    installed.
    """
    if (d is None) != (y is None):
        raise ValueError("pass both d and y, or neither")
    R_new, d_new = _downdate_core(R, u, d, y, guard=guard)
    if d is None:
        return R_new
    return R_new, d_new


def qr_rank1_update(R: torch.Tensor, v: torch.Tensor, weight: float,
                    d: torch.Tensor | None = None, y: torch.Tensor | None = None,
                    *, guard=None):
    """Symmetric rank-1 Gram update: R'^T R' = R^T R + weight·v v^T.

    With rhs state: R'^T d' = R^T d + weight·v y.  ``weight >= 0`` appends the
    scaled row sqrt(w)·v; ``weight < 0`` downdates it.  ``guard`` protects
    the downdate branch (see ``qr_downdate_row``).
    """
    if (d is None) != (y is None):
        raise ValueError("pass both d and y, or neither")
    w = torch.as_tensor(weight, dtype=R.dtype, device=R.device)
    s = torch.sqrt(w.abs())
    u = s * v
    up = bool(w >= 0)
    if d is None:
        if up:
            return qr_append_rows(R, u[None, :])
        return qr_downdate_row(R, u, guard=guard)
    yr = (s * y)[None, :]
    if up:
        return qr_append_rows(R, u[None, :], d, yr)
    return qr_downdate_row(R, u, d, yr[0], guard=guard)
