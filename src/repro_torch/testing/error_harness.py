"""Numerical-error tracking harness for mixed-precision GGR.

The mixed-precision policy ("bf16 tiles, f32 accumulation") is only as good
as the instruments watching it, so this module packages the three pieces
every precision test and benchmark needs:

* **Graded matrix suites** — `graded_matrix` builds test problems with a
  *controlled* SVD spectrum (orthogonal factors from f64 QR, singular values
  laid out geometrically from 1 down to 1/cond), so condition numbers from
  1e0 to 1e8 are exact by construction rather than luck of the draw.
  ``matrix_suite`` iterates the standard (shape x cond) grid.

* **Error metrics** — all computed on host in f64 against the f64 problem:

  - ``gram_residual``   ``||A^T A - R^T R||_F / ||A^T A||_F``: the backward
    error of the *factorization* seen through the normal equations.  It is
    essentially condition-independent, which makes it the one metric that
    stays meaningful for bf16 at cond 1e8.
  - ``backward_error``  ``||A - QR||_F / ||A||_F`` for an *explicitly*
    formed Q (e.g. ``ggr_qr2(..., want_q=True)``).  With the implicit
    ``Q = A R^{-1}`` this identity is vacuous (``A - A R^{-1} R == 0`` in
    exact arithmetic), so R-only paths must audit through the gram
    residual instead — that is why it is the headline metric here.
  - ``orthogonality_loss``  ``max |Q^T Q - I|`` for the same implicit Q
    (delegates to :func:`repro_torch.obs.health.orthogonality_loss` so tests
    and production gauges can never drift apart).
  - ``forward_error``  ``||R - R_ref||_F / ||R_ref||_F`` after sign
    alignment (GGR and LAPACK may differ in per-row sign conventions).

* **Dtype-eps-scaled budgets** — ``error_budget`` turns (dtype, metric,
  shape, cond) into a pass/fail threshold.  The constants are the JAX
  package's, calibrated there against measured GGR behaviour (its
  ``docs/precision.md``): mixed bf16 gram
  residuals land at ~1-2x eps(bf16) while *broken* accumulation (bf16
  accumulators) lands ~3x higher, so the 2*sqrt(n)*eps gram budget both
  admits the healthy path with margin and documents the contract.
  ``budget_is_meaningful`` flags where cond amplification saturates a
  budget past any discriminating power (bf16 ortho at cond 1e8 is noise).

* **Kalman NIS** — ``fleet_nis`` runs a fleet of B SRIF filters through
  the port's ``kf_step_batched`` on a device at a given precision policy and
  scores innovation consistency (mean normalized-innovation-squared ~
  measurement dim p for a correctly specified filter).  The NIS itself is
  computed on host in f64 from the low-precision posterior states, so it
  measures the filter actually deployed, not an idealized shadow.

The suites, metrics and budgets are numpy and are the JAX package's
(``repro.testing.error_harness``), kept as the port's own copy.
"""
from __future__ import annotations

import math
from typing import Iterator, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.backend import torch_dtype

__all__ = [
    "Case",
    "DEFAULT_CONDS",
    "DEFAULT_RANK_CONDS",
    "DEFAULT_SHAPES",
    "RankCase",
    "backward_error",
    "budget_is_meaningful",
    "dtype_eps",
    "error_budget",
    "factorization_errors",
    "fleet_nis",
    "forward_error",
    "graded_matrix",
    "gram_residual",
    "matrix_suite",
    "orthogonality_loss",
    "rank_deficient_matrix",
    "rank_deficient_suite",
    "sign_align",
]

DEFAULT_SHAPES: Tuple[Tuple[int, int], ...] = ((64, 48), (96, 80), (192, 64))
DEFAULT_CONDS: Tuple[float, ...] = (1e0, 1e2, 1e4, 1e6, 1e8)
# conds of the *nonzero* spectrum in the rank-deficient suite: pushes all
# the way to 1e12 — the rank-revealing paths must hold where the unpivoted
# solver has long since given up
DEFAULT_RANK_CONDS: Tuple[float, ...] = (1e0, 1e4, 1e8, 1e12)


def dtype_eps(dtype) -> float:
    """Machine epsilon of ``dtype`` (accepts names, numpy/torch dtypes;
    understands bfloat16 via torch)."""
    return float(torch.finfo(torch_dtype(dtype)).eps)


class Case(NamedTuple):
    """One graded test problem: f64 matrix ``A`` with cond_2(A) == cond."""

    name: str
    A: np.ndarray
    cond: float


def graded_matrix(m: int, n: int, cond: float, seed: int = 0,
                  spectrum: str = "geometric") -> np.ndarray:
    """(m, n) f64 matrix with exactly controlled singular values.

    ``spectrum="geometric"`` spaces them geometrically from 1 to 1/cond —
    the graded case.  ``"cliff"`` puts half at 1 and half at 1/cond — the
    near-rank-deficient case that stresses pivot collapse.
    """
    if m < n:
        raise ValueError(f"need m >= n, got {(m, n)}")
    if cond < 1.0:
        raise ValueError(f"cond must be >= 1, got {cond}")
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    if spectrum == "geometric":
        s = np.geomspace(1.0, 1.0 / cond, n)
    elif spectrum == "cliff":
        s = np.ones(n)
        s[n // 2:] = 1.0 / cond
    else:
        raise ValueError(f"unknown spectrum {spectrum!r}")
    return (U * s) @ V.T


def matrix_suite(shapes: Sequence[Tuple[int, int]] = DEFAULT_SHAPES,
                 conds: Sequence[float] = DEFAULT_CONDS,
                 seed: int = 0,
                 spectrum: str = "geometric") -> Iterator[Case]:
    """The standard (shape x cond) grid of graded problems."""
    for i, (m, n) in enumerate(shapes):
        for j, cond in enumerate(conds):
            A = graded_matrix(m, n, cond, seed=seed + 97 * i + j,
                              spectrum=spectrum)
            yield Case(f"{m}x{n}@cond={cond:.0e}", A, float(cond))


class RankCase(NamedTuple):
    """One rank-deficient test problem: f64 matrix ``A`` with exactly
    ``rank`` nonzero singular values spanning ``cond``."""

    name: str
    A: np.ndarray
    cond: float
    rank: int


def rank_deficient_matrix(m: int, n: int, rank: int, cond: float = 1e4,
                          seed: int = 0) -> np.ndarray:
    """(m, n) f64 matrix of *exact* rank ``rank``: the nonzero singular
    values are geomspaced from 1 down to 1/cond, the remaining ``n - rank``
    are exactly zero.  The clean rank gap is what makes these suites honest
    oracles — every sensible threshold convention (singular values, |diag R|
    of a pivoted factor) detects the same rank."""
    if not 1 <= rank <= min(m, n):
        raise ValueError(f"need 1 <= rank <= min(m, n), got rank={rank} "
                         f"for {(m, n)}")
    if cond < 1.0:
        raise ValueError(f"cond must be >= 1, got {cond}")
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.zeros(n)
    s[:rank] = np.geomspace(1.0, 1.0 / cond, rank) if rank > 1 else 1.0
    return (U * s) @ V.T


def rank_deficient_suite(shapes: Sequence[Tuple[int, int]] = DEFAULT_SHAPES,
                         conds: Sequence[float] = DEFAULT_RANK_CONDS,
                         seed: int = 0) -> Iterator[RankCase]:
    """The (shape x cond x rank) grid of exactly-rank-deficient problems.

    Per shape the ranks exercised are a thin subspace (3), half rank
    (n // 2), and one short of full (n - 1) — the regimes where pivot
    selection, rank estimation, and the min-norm solve each fail
    differently when broken."""
    for i, (m, n) in enumerate(shapes):
        for j, cond in enumerate(conds):
            for rank in sorted({3, n // 2, n - 1}):
                if not 1 <= rank < n:
                    continue
                A = rank_deficient_matrix(m, n, rank, cond,
                                          seed=seed + 977 * i + 31 * j + rank)
                yield RankCase(f"{m}x{n}@rank={rank}@cond={cond:.0e}",
                               A, float(cond), rank)


# ------------------------------------------------------------------ metrics

def _triu64(R) -> np.ndarray:
    """f64 upper-triangular view of an R factor; (m, n) inputs with m > n
    (full triangularized matrices) are cut to their top (n, n) block."""
    Rf = np.triu(np.asarray(R, dtype=np.float64))
    n = Rf.shape[-1]
    return Rf[..., :n, :] if Rf.shape[-2] > n else Rf


def gram_residual(A, R) -> float:
    """``||A^T A - R^T R||_F / ||A^T A||_F`` — condition-independent
    backward error of the factorization through the normal equations."""
    Af = np.asarray(A, dtype=np.float64)
    Rf = _triu64(R)
    AtA = Af.T @ Af
    return float(np.linalg.norm(AtA - Rf.T @ Rf) / np.linalg.norm(AtA))


def backward_error(A, Q, R) -> float:
    """``||A - QR||_F / ||A||_F`` for an explicitly formed Q.

    Only meaningful when Q comes out of the factorization itself; with the
    implicit ``Q = A R^{-1}`` the residual is identically zero and proves
    nothing — use :func:`gram_residual` for R-only paths."""
    Af = np.asarray(A, dtype=np.float64)
    Qf = np.asarray(Q, dtype=np.float64)
    Rf = _triu64(R)
    return float(np.linalg.norm(Af - Qf[:, :Rf.shape[0]] @ Rf)
                 / np.linalg.norm(Af))


def orthogonality_loss(A, R) -> float:
    """``max |Q^T Q - I|`` for the implicit Q — same audit the serving
    health gauges sample (:mod:`repro_torch.obs.health`)."""
    from repro_torch.obs.health import orthogonality_loss as _loss

    return _loss(A, R)


def sign_align(R, R_ref) -> np.ndarray:
    """Flip rows of ``R`` so its diagonal signs match ``R_ref`` — removes
    the per-row sign freedom of a QR factor before forward comparison."""
    Rf, Rr = _triu64(R), _triu64(R_ref)
    flip = np.sign(np.diagonal(Rf)) * np.sign(np.diagonal(Rr))
    flip = np.where(flip == 0.0, 1.0, flip)
    return Rf * flip[:, None]


def forward_error(R, R_ref) -> float:
    """``||R - R_ref||_F / ||R_ref||_F`` after sign alignment."""
    Rr = _triu64(R_ref)
    return float(np.linalg.norm(sign_align(R, R_ref) - Rr)
                 / np.linalg.norm(Rr))


def factorization_errors(A, R, R_ref=None, Q=None) -> dict:
    """All applicable metrics for one factorization, as a flat dict
    (bench-friendly); ``backward_error`` only when an explicit Q exists."""
    out = {
        "gram_residual": gram_residual(A, R),
        "orthogonality_loss": orthogonality_loss(A, R),
    }
    if Q is not None:
        out["backward_error"] = backward_error(A, Q, R)
    if R_ref is not None:
        out["forward_error"] = forward_error(R, R_ref)
    return out


# ------------------------------------------------------------------ budgets

# Calibrated headroom factors (see docs/precision.md for the measurements).
_BUDGET_COEFF = {
    "gram_residual": 2.0,       # observed <= ~0.2 * sqrt(n) * eps
    "backward_error": 4.0,      # explicit-Q residual: backward stable
    "orthogonality_loss": 8.0,  # cond-amplified, max-abs metric
    "forward_error": 16.0,      # cond-amplified, vs an alien sign convention
}
_COND_FREE = frozenset({"gram_residual", "backward_error"})


def error_budget(dtype, metric: str, m: int, n: int,
                 cond: float = 1.0) -> float:
    """Pass/fail threshold for ``metric`` on an (m, n) problem at ``cond``
    when factored at ``dtype`` compute precision (f32 accumulation assumed
    for sub-f32 dtypes — that is the policy under test)."""
    if metric not in _BUDGET_COEFF:
        raise ValueError(f"unknown metric {metric!r}; "
                         f"one of {sorted(_BUDGET_COEFF)}")
    eps = dtype_eps(dtype)
    amp = 1.0 if metric in _COND_FREE else float(cond)
    return _BUDGET_COEFF[metric] * math.sqrt(n) * eps * amp


def budget_is_meaningful(dtype, metric: str, m: int, n: int,
                         cond: float = 1.0, ceiling: float = 0.5) -> bool:
    """False when cond amplification pushes the budget past ``ceiling`` —
    at that point "within budget" no longer distinguishes anything and
    tests should skip the assertion rather than celebrate it."""
    return error_budget(dtype, metric, m, n, cond) < ceiling


# ------------------------------------------------------------------ kalman

def _fleet_lti(n: int, w: int, p: int, seed: int):
    """Random stable LTI system (F, G, Q, H, Rn) in f64."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((n, n))
    F = 0.9 * F / max(abs(np.linalg.eigvals(F)))
    G = rng.standard_normal((n, w))
    Aq = rng.standard_normal((w, w + 3))
    Q = Aq @ Aq.T / (w + 3) + 0.1 * np.eye(w)
    H = rng.standard_normal((p, n))
    Ar = rng.standard_normal((p, p + 3))
    Rn = Ar @ Ar.T / (p + 3) + 0.1 * np.eye(p)
    return F, G, Q, H, Rn


def fleet_nis(B: int = 8, n: int = 4, w: int = 4, p: int = 2, T: int = 150,
              seed: int = 0, precision=None, backend: str = "pallas",
              block_b: int = 8, device="cuda") -> np.ndarray:
    """Mean NIS per fleet member for B filters stepped via
    ``kf_step_batched`` on ``device`` (the card unless the caller asks for
    the CPU) at ``precision``.

    One shared dynamics model, B independently simulated trajectories.  At
    each step the predicted mean/covariance are reconstructed on host in
    f64 *from the precision-policy posterior* ``(R, d)``, so the score
    reflects the filter the serving path actually runs.  A consistent
    filter scores ~p; broken precision handling inflates or deflates it.
    """
    from repro_torch.solvers import info_sqrt, kf_step_batched

    F, G, Q, H, Rn = _fleet_lti(n, w, p, seed)
    GQGt = G @ Q @ G.T
    rng = np.random.default_rng(seed + 1)
    Lq, Lr = np.linalg.cholesky(Q), np.linalg.cholesky(Rn)
    x = rng.standard_normal((B, n))          # true states
    zs = np.zeros((T, B, p))
    for t in range(T):
        x = x @ F.T + rng.standard_normal((B, w)) @ Lq.T @ G.T
        zs[t] = x @ H.T + rng.standard_normal((B, p)) @ Lr.T

    f32 = dict(dtype=torch.float32, device=device)
    # SRIF fleet state: prior mean 0, covariance I
    R_state = torch.eye(n, **f32).expand(B, n, n)
    d_state = torch.zeros((B, n), **f32)
    Qi = info_sqrt(torch.as_tensor(Q, device=device)).to(torch.float32)
    W = info_sqrt(torch.as_tensor(Rn, device=device)).cpu().numpy()
    Hw = torch.as_tensor(W @ H, **f32)
    Ft, Gt = torch.as_tensor(F, **f32), torch.as_tensor(G, **f32)

    nis = np.zeros((T, B))
    eyen = np.eye(n)
    for t in range(T):
        # host-f64 prediction from the (possibly low-precision) posterior
        Rh = np.triu(R_state.double().cpu().numpy())
        dh = d_state.double().cpu().numpy()
        x_post = np.stack([np.linalg.solve(Rh[b], dh[b]) for b in range(B)])
        Rinv = np.stack([np.linalg.solve(Rh[b], eyen) for b in range(B)])
        P_post = Rinv @ Rinv.transpose(0, 2, 1)
        x_pred = x_post @ F.T
        P_pred = F @ P_post @ F.T + GQGt
        e = zs[t] - x_pred @ H.T
        S = H @ P_pred @ H.T + Rn
        nis[t] = np.einsum("bp,bp->b", e,
                           np.stack([np.linalg.solve(S[b], e[b])
                                     for b in range(B)]))
        zw = torch.as_tensor((W @ zs[t].T).T, **f32)
        R_state, d_state = kf_step_batched(
            R_state, d_state, Ft, Qi, Hw, zw, Gt, backend=backend,
            block_b=block_b, precision=precision)
    return nis.mean(axis=0)
