"""Least-squares solvers on top of GGR QR: one-shot and streaming.

* ``solve_triangular`` — loop-based substitution (all four lower/upper ×
  trans variants reduce to one forward-substitution core via flips).
* ``ggr_lstsq`` — one-shot min ||Ax - b||: GGR sweep over the augmented
  ``[A | b]`` (so Q is never formed — the rhs rides along through the DET2
  grids), then a triangular solve.  Takes an optional leading batch
  dimension (the serving ``lstsq`` kind's batch).
* ``RecursiveLS`` — the streaming state machine: ``observe`` (row append,
  optionally with exponential forgetting), ``forget`` (sliding-window
  downdate) and ``solve``, all O(n^2) per event.  State is the compact
  ``(R, d)`` pair — never the Gram matrix, never Q.
* ``state_integrity`` — the finite / condition gate a serving vault runs on
  a streaming state before it restores it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.blocked import ggr_triangularize_blocked
from repro_torch.core.ggr import ggr_triangularize

from .qr_update import _tri_solve_lower, qr_append_rows, qr_downdate_row

__all__ = ["LstsqResult", "RLSState", "RecursiveLS", "ggr_lstsq",
           "solve_triangular", "state_integrity"]


def _leaves(state):
    """The array leaves of a state: tensors, arrays and Python numbers inside
    (named) tuples, lists and dicts, in order (None is no leaf)."""
    if isinstance(state, dict):
        for v in state.values():
            yield from _leaves(v)
    elif isinstance(state, (tuple, list)):
        for v in state:
            yield from _leaves(v)
    elif state is not None:
        yield state


def state_integrity(state, max_cond: float | None = None) -> tuple[bool, str]:
    """Integrity gate for a streaming factor state (``RLSState``,
    ``KalmanState``, or any ``(R, d)``-carrying tuple).

    Returns ``(ok, reason)``: every floating-point leaf must be finite, and —
    when ``max_cond`` is given and the state exposes an ``R`` attribute — the
    triangular factor's ``cond_estimate`` must not exceed it.  This is what a
    serving vault runs at restore time so a corrupted snapshot is rejected
    instead of resurrected; it reads each check to the host (one
    synchronization per leaf on the card).
    """
    for leaf in _leaves(state):
        a = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
        if ((a.is_floating_point() or a.is_complex())
                and not bool(torch.isfinite(a).all())):
            return False, "non-finite leaf"
    R = getattr(state, "R", None)
    if max_cond is not None and R is not None:
        from repro_torch.ranks.monitor import cond_estimate  # lazy: ranks -> solvers

        cond = float(cond_estimate(torch.as_tensor(R)).cond)
        if not cond <= max_cond:
            return False, (f"cond estimate {cond:.3e} exceeds "
                           f"bound {max_cond:.3e}")
    return True, "ok"

# Above this problem size the one-shot solvers dispatch their augmented sweep
# to the blocked panel driver (``core.blocked.ggr_triangularize_blocked``):
# batched tile kernels + tree coupling + GEMM trailing updates win once the
# column loop of the unblocked sweep stops fitting the machine, while small
# streaming problems keep the cheap single-sweep path.
_BLOCKED_MIN_ROWS = 256
_BLOCKED_MIN_PIVOTS = 128


def _triangularize_auto(X: torch.Tensor, n_pivots: int) -> torch.Tensor:
    """Size-routed augmented triangularization (unblocked vs blocked panel)."""
    m = X.shape[-2]
    if m >= _BLOCKED_MIN_ROWS and n_pivots >= _BLOCKED_MIN_PIVOTS:
        return ggr_triangularize_blocked(X, n_pivots)
    return ggr_triangularize(X, n_pivots)


def solve_triangular(R: torch.Tensor, b: torch.Tensor, *, lower: bool = False,
                     trans: bool = False) -> torch.Tensor:
    """Solve R x = b (or R^T x = b) for triangular R; b is (..., n) or (..., n, k).

    Upper-triangular systems are solved by the anti-diagonal flip
    ``flip(L_solve(flip(R), flip(b)))`` so a single forward-substitution
    loop serves every variant.
    """
    vec = b.ndim == R.ndim - 1
    B = b[..., None] if vec else b
    A = R.transpose(-1, -2) if trans else R
    eff_lower = lower != trans  # transposing swaps triangle orientation
    if eff_lower:
        X = _tri_solve_lower(A, B)
    else:
        X = _tri_solve_lower(A.flip(-2, -1), B.flip(-2)).flip(-2)
    return X[..., 0] if vec else X


class LstsqResult(NamedTuple):
    x: torch.Tensor       # (n, k) solution
    resid: torch.Tensor   # (k,) residual 2-norms ||A x - b||
    R: torch.Tensor       # (n, n) triangular factor
    d: torch.Tensor       # (n, k) Q^T b (top rows)


# A collapsed pivot sits at roundoff level relative to the largest one;
# anything below this many eps is rank-collapse junk, not data.
_RANK_COLLAPSE_EPS_MULT = 32.0


def ggr_lstsq(A: torch.Tensor, b: torch.Tensor, rcond: float | None = None,
              *, check_rank: bool = True) -> LstsqResult:
    """min ||Ax - b|| for full-column-rank A (m >= n) via augmented GGR.

    One sweep triangularizes ``[A | b]`` to ``[R | d; 0 | r]``; x solves
    R x = d and ||r|| is the residual norm.  ``A`` is ``(m, n)`` or a batch
    ``(B, m, n)``; ``b`` is ``(m,)``/``(m, k)`` (or batched alike).

    ``rcond`` is the rank-deficiency escape hatch: when given, the solve
    routes to the pivoted min-norm path (``ranks.lstsq_pivoted``) and the
    returned ``(R, d)`` are the *pivoted* factors.  With ``rcond=None`` a
    rank-collapsed pivot raises a diagnostic ``ValueError`` unless
    ``check_rank=False``: the batched serving path passes that, because the
    zero problems that pad a chunk are rank-collapsed by construction.
    """
    m, n = A.shape[-2:]
    if m < n:
        raise ValueError(f"ggr_lstsq requires m >= n, got {tuple(A.shape)}")
    if rcond is not None:
        from repro_torch.ranks import lstsq_pivoted  # lazy: breaks the import cycle

        fit = lstsq_pivoted(A, b, rcond=rcond)
        return LstsqResult(x=fit.x, resid=fit.resid, R=fit.R, d=fit.d)
    vec = b.ndim == A.ndim - 1
    B = b[..., None] if vec else b
    X = _triangularize_auto(torch.cat([A, B], dim=-1), n)
    R = torch.triu(X[..., :n, :n])
    d = X[..., :n, n:]
    if check_rank:
        diag = torch.diagonal(R, dim1=-2, dim2=-1).abs()
        dmin, dmax = diag.amin(-1), diag.amax(-1)
        cliff = _RANK_COLLAPSE_EPS_MULT * torch.finfo(R.dtype).eps
        bad = dmin <= dmax * cliff
        if bool(bad.any()):
            i = int(bad.flatten().nonzero()[0])
            lo, hi = float(dmin.flatten()[i]), float(dmax.flatten()[i])
            raise ValueError(
                f"ggr_lstsq: rank-deficient input — min |diag R| = {lo:.3e} "
                f"vs max {hi:.3e} (below {_RANK_COLLAPSE_EPS_MULT:g}*eps "
                "relative).  The triangular solve would amplify noise by "
                "1/|r_ii|.  Pass rcond= to get the pivoted min-norm solution "
                "(ranks.lstsq_pivoted), e.g. rcond=1e-10 for f64.")
    if obs.enabled() and A.ndim == 2:
        # numerical-health sensors of one problem (the batched serving path
        # records from its flush instead); the orthogonality audit is
        # sampled — see obs.health
        obs.factor_health(R, "lstsq")
        obs.maybe_sample_orthogonality(A, R, "lstsq")
    x = solve_triangular(R, d)
    resid = torch.sqrt(torch.sum(X[..., n:, n:] ** 2, dim=-2))
    if vec:
        return LstsqResult(x=x[..., 0], resid=resid[..., 0], R=R, d=d[..., 0])
    return LstsqResult(x=x, resid=resid, R=R, d=d)


class RLSState(NamedTuple):
    """Compact streaming least-squares state.

    Invariants over the (weighted) observation stream:
        R^T R = delta·I + sum_i w_i u_i u_i^T      (upper-tri, diag >= 0)
        R^T d = sum_i w_i u_i y_i
    """

    R: torch.Tensor  # (n, n)
    d: torch.Tensor  # (n, k)
    count: torch.Tensor  # scalar int32 — observations currently in the window


class RecursiveLS:
    """Streaming recursive least squares via QR up/downdating.

    The instance holds static config (feature dim n, rhs width k, forgetting
    factor lam, ridge seed delta); every method is a pure ``state -> state``
    map.

        rls = RecursiveLS(n=8)
        state = rls.init(device="cuda")
        state = rls.observe(state, u, y)        # new observation row
        state = rls.forget(state, u_old, y_old) # slide the window
        x = rls.solve(state)

    ``lam < 1`` applies exponential forgetting at each observe (the
    sqrt(lam)-scaling of (R, d) keeps the Gram invariant G <- lam·G + u u^T).
    """

    def __init__(self, n: int, k: int = 1, lam: float = 1.0, delta: float = 1e-8):
        if not 0.0 < lam <= 1.0:
            raise ValueError("forgetting factor lam must be in (0, 1]")
        self.n = n
        self.k = k
        self.lam = lam
        self.delta = delta

    def init(self, dtype=torch.float32, device="cuda") -> RLSState:
        """Fresh state: R = sqrt(delta)·I (ridge seed keeps R invertible).

        The state lives on ``device`` — the card unless the caller asks for
        the CPU."""
        R0 = torch.sqrt(torch.tensor(self.delta, dtype=dtype, device=device)
                        ) * torch.eye(self.n, dtype=dtype, device=device)
        return RLSState(R=R0, d=torch.zeros((self.n, self.k), dtype=dtype, device=device),
                        count=torch.zeros((), dtype=torch.int32, device=device))

    def _as_rows(self, u, y):
        U = u[None, :] if u.ndim == 1 else u
        Y = torch.as_tensor(y, dtype=U.dtype, device=U.device).reshape(U.shape[0], self.k)
        return U, Y

    def observe(self, state: RLSState, u: torch.Tensor, y) -> RLSState:
        """Fold in observation row(s): u (n,) or (p, n), y (k,)/(p, k)."""
        U, Y = self._as_rows(u, y)
        g = torch.tensor(self.lam, dtype=state.R.dtype) ** (0.5 * U.shape[0])
        g = g.to(state.R.device)
        R, d = qr_append_rows(g * state.R, U, g * state.d, Y)
        return RLSState(R=R, d=d, count=state.count + U.shape[0])

    def forget(self, state: RLSState, u: torch.Tensor, y, guard=None) -> RLSState:
        """Remove a previously-observed row (sliding-window downdate).

        Only meaningful with lam == 1.0 (with exponential forgetting the old
        row's weight has decayed, so the unscaled downdate would overshoot).
        ``guard`` (a ``ranks.DowndateGuard``) bounds the hyperbolic step away
        from the rank cliff — a shrinking window over nearly collinear
        features is exactly where an unguarded forget destroys the factor;
        see ``qr_downdate_row``.
        """
        y_row = torch.as_tensor(y, dtype=state.R.dtype, device=state.R.device).reshape(self.k)
        R, d = qr_downdate_row(state.R, u, state.d, y_row, guard=guard)
        return RLSState(R=R, d=d, count=state.count - 1)

    def solve(self, state: RLSState) -> torch.Tensor:
        """Current weights x = R^{-1} d, shape (n, k) (or (n,) when k == 1)."""
        x = solve_triangular(state.R, state.d)
        return x[:, 0] if self.k == 1 else x

    def predict(self, state: RLSState, u: torch.Tensor) -> torch.Tensor:
        """y_hat = u @ x for a feature row or batch of rows."""
        x = solve_triangular(state.R, state.d)
        out = u @ x
        return out[..., 0] if self.k == 1 else out

    def residual_gram(self, state: RLSState, u: torch.Tensor) -> torch.Tensor:
        """||R^{-T} u||^2 — the leverage of u under the current window
        (used by the downdate: 1 - leverage must stay positive)."""
        Rt = state.R.T.to(torch.promote_types(state.R.dtype, torch.float32))
        q = _tri_solve_lower(Rt, u[:, None])[:, 0]
        return q @ q
