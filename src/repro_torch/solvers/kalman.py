"""Square-root information filtering (SRIF) on GGR — Kalman as triangularization.

The square-root information filter (Bierman/Dyer-McReynolds) keeps the state
estimate as the compact pair ``(R, d)`` with ``R^T R = P^{-1}`` (upper
triangular, non-negative diagonal — the GGR sign convention) and ``d = R x``.
Both filter steps are then *exactly* augmented QR triangularizations:

* **observe** — a whitened measurement ``z = H x + v`` is one appended
  data-equation row per measurement: ``qr_append_rows(R, H, d, z)``.
* **predict** — with dynamics ``x' = F x + G w``, ``w ~ N(0, Q)``, substitute
  ``x = F^{-1}(x' - G w)`` into the data equation ``R x = d - nu`` and stack
  the process-noise data equation ``Qi w = 0 - nu_w`` (``Qi^T Qi = Q^{-1}``):

      [ Qi        0    | 0 ]        GGR sweep        [ *   *     | *  ]
      [ -Rd G     Rd   | d ]   ----------------->    [ 0   R'    | d' ]

  with ``Rd = R F^{-1}``.  Triangularizing the first ``w + n`` columns
  marginalizes the noise ``w`` out; rows ``w..w+n`` are the predicted pair.
* **step** (predict + observe fused) — append the whitened measurement rows
  ``[0 | H | z]`` to the same stack and insert an all-zero pivot block so the
  top ``w + n`` rows stay upper triangular:

      [ Qi      0     | 0 ]   <- w pivot rows (triangular)
      [ 0       0     | 0 ]   <- n zero pivot rows (diag picked up below)
      [ -Rd G   Rd    | d ]   <- n appended rows
      [ 0       H     | z ]   <- p appended rows

  One sweep over ``w + n`` pivots yields the *posterior* pair in the zero
  block's rows.  This is the ``[R_tri | rhs; appended]`` shape the batched
  row-append kernel (``kernels.ggr_update``) handles, so ``kf_step_batched``
  advances thousands of independent filters per kernel launch.

Smoothing: ``kf_filter`` stores the per-step predicted/filtered factors;
``kf_smooth`` runs the RTS backward pass on them (covariances recovered by
triangular solves against the stored ``R`` factors).

Every helper takes an optional leading batch dimension, which replaces the
reference's ``vmap`` over filters.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.core.ggr import ggr_qr2, ggr_triangularize
from repro_torch.kernels import resolve_precision

from .lstsq import solve_triangular
from .qr_update import _update_stacked, qr_append_rows

__all__ = [
    "KalmanState",
    "KalmanTrajectory",
    "info_sqrt",
    "kf_init",
    "kf_mean",
    "kf_cov",
    "kf_predict",
    "kf_observe",
    "kf_step",
    "kf_step_batched",
    "kf_filter",
    "kf_smooth",
    "whiten_measurement",
]


class KalmanState(NamedTuple):
    """Square-root information state: ``R^T R = P^{-1}``, ``d = R x``.

    R: (n, n) upper triangular, non-negative diagonal (GGR convention)
    d: (n,)   information rhs — the state mean is ``solve(R, d)``
    step: scalar int32 — number of predict steps applied so far
    """

    R: torch.Tensor
    d: torch.Tensor
    step: torch.Tensor


class KalmanTrajectory(NamedTuple):
    """Stored per-step factors from ``kf_filter`` (inputs to ``kf_smooth``).

    Rp/dp: (T, n, n) / (T, n) predicted (prior) pairs, one per time step
    Rf/df: (T, n, n) / (T, n) filtered (posterior) pairs
    """

    Rp: torch.Tensor
    dp: torch.Tensor
    Rf: torch.Tensor
    df: torch.Tensor


def _eye_like(M: torch.Tensor, n: int) -> torch.Tensor:
    return torch.eye(n, dtype=M.dtype, device=M.device)


def info_sqrt(M: torch.Tensor) -> torch.Tensor:
    """Upper-triangular ``U`` with ``U^T U = M^{-1}`` for symmetric PD ``M``.

    Cholesky ``M = L L^T`` followed by a GGR QR of ``L^{-1}``: the R factor
    of ``L^{-1} = Theta U`` satisfies ``U^T U = L^{-T} L^{-1} = M^{-1}`` and
    carries the module-wide non-negative-diagonal convention.
    """
    L = torch.linalg.cholesky(M)
    Linv = solve_triangular(L, _eye_like(M, M.shape[-1]).expand_as(M), lower=True)
    return ggr_qr2(Linv)


def whiten_measurement(R_noise: torch.Tensor, H: torch.Tensor, z: torch.Tensor):
    """Whiten a measurement model: returns ``(W H, W z)``, ``W^T W = R_noise^{-1}``."""
    W = info_sqrt(R_noise)
    return W @ H, W @ z


def kf_init(x0: torch.Tensor, P0: torch.Tensor) -> KalmanState:
    """State from a prior mean ``x0`` and covariance ``P0``: R = info_sqrt(P0)."""
    R0 = info_sqrt(P0)
    return KalmanState(R=R0, d=R0 @ x0,
                       step=torch.zeros((), dtype=torch.int32, device=R0.device))


def kf_mean(state: KalmanState) -> torch.Tensor:
    """Current state estimate ``x = R^{-1} d`` (one triangular solve)."""
    return solve_triangular(state.R, state.d)


def kf_cov(state: KalmanState) -> torch.Tensor:
    """Current covariance ``P = R^{-1} R^{-T}`` via a triangular solve."""
    K = solve_triangular(state.R, _eye_like(state.R, state.R.shape[-1]))
    return K @ K.T


def _matmul(a, b):
    """``a @ b`` as a batched product: a 2-D product runs as a batch of one,
    which on the CPU sums in the same order as each lane of a batched
    product (a plain 2-D product may not).  That keeps one filter stepped
    alone bitwise equal to its lane of ``kf_step_batched(backend="reference")``."""
    if a.ndim == 2 and b.ndim == 2:
        return torch.matmul(a[None], b[None])[0]
    return torch.matmul(a, b)


def _apply_F_inv(R, F):
    """``Rd = R F^{-1}`` via the repo's own engine — F is never inverted.

    GGR-factor ``F^T = Theta U`` (orthogonal x upper triangular), then
    ``Rd^T = U^{-1} (Theta^T R^T)`` is a matmul plus one triangular solve.
    Deliberately not a LAPACK solve, whose batched path may pick a different
    accumulation order than the single-matrix one.
    """
    U, Theta = ggr_qr2(F.transpose(-1, -2), want_q=True)
    rhs = _matmul(Theta.transpose(-1, -2), R.transpose(-1, -2))
    return solve_triangular(U, rhs).transpose(-1, -2)


def _predict_blocks(R, d, F, Qi, G):
    """The two SRIF prediction rows: ``[Qi | 0 | 0]`` and ``[-Rd G | Rd | d]``."""
    n = R.shape[-1]
    w = Qi.shape[-2]
    lead = R.shape[:-2]
    Rd = _apply_F_inv(R, F)
    RdG = Rd if G is None else _matmul(Rd, G)
    top = torch.cat([Qi, R.new_zeros((*lead, w, n + 1))], dim=-1)
    mid = torch.cat([-RdG, Rd, d[..., None]], dim=-1)
    return top, mid


def kf_predict(state: KalmanState, F: torch.Tensor, Qi: torch.Tensor,
               G: torch.Tensor | None = None) -> KalmanState:
    """SRIF time update for ``x' = F x + G w``, ``w ~ N(0, Q)``.

    ``Qi = info_sqrt(Q)`` is the (w, w) upper-triangular process-noise
    information square root; ``G`` is the (n, w) noise input map (default:
    identity, w = n).  One ``ggr_triangularize`` sweep over the stacked
    ``(w + n, w + n + 1)`` matrix marginalizes the process noise; rows
    ``w..`` hold the predicted ``(R, d)``.
    """
    n = state.R.shape[-1]
    w = Qi.shape[-2]
    top, mid = _predict_blocks(state.R, state.d, F, Qi, G)
    out = ggr_triangularize(torch.cat([top, mid], dim=-2), w + n)
    return KalmanState(R=torch.triu(out[..., w:, w:w + n]), d=out[..., w:, w + n],
                       step=state.step + 1)


def kf_observe(state: KalmanState, H: torch.Tensor, z: torch.Tensor) -> KalmanState:
    """SRIF measurement update: fold in whitened rows ``z = H x + v``, v ~ N(0, I).

    Delegates to ``qr_append_rows`` — each measurement is literally an
    appended observation row of the information least-squares system.
    """
    R, d = qr_append_rows(state.R, H, state.d[..., None], z[..., None])
    return KalmanState(R=R, d=d[..., 0], step=state.step)


def _step_stacked(R, d, F, Qi, H, z, G):
    """Fused predict+observe stack, shape ``(..., w + 2n + p, w + n + 1)``.

    Top ``w + n`` rows are upper triangular by construction (Qi block plus an
    all-zero pivot block), so this is directly consumable by both
    ``ggr_triangularize`` and the batched row-append kernel; the posterior
    pair lands in rows ``w..w+n`` after the sweep.
    """
    n = R.shape[-1]
    w = Qi.shape[-2]
    p = H.shape[-2]
    lead = R.shape[:-2]
    top, mid = _predict_blocks(R, d, F, Qi, G)
    zero_piv = R.new_zeros((*lead, n, w + n + 1))
    meas = torch.cat([R.new_zeros((*lead, p, w)), H, z[..., None]], dim=-1)
    return torch.cat([top, zero_piv, mid, meas], dim=-2)


def kf_step(state: KalmanState, F: torch.Tensor, Qi: torch.Tensor, H: torch.Tensor,
            z: torch.Tensor, G: torch.Tensor | None = None) -> KalmanState:
    """One fused predict+observe sweep (the unit ``kf_step_batched`` batches).

    Same posterior as ``kf_observe(kf_predict(state, F, Qi, G), H, z)`` up to
    rotation order (both yield the unique non-negative-diagonal factor, so
    they agree to roundoff).
    """
    n = state.R.shape[-1]
    w = Qi.shape[-2]
    X = _step_stacked(state.R, state.d, F, Qi, H, z, G)
    out = ggr_triangularize(X, w + n)
    R_new = torch.triu(out[..., w:w + n, w:w + n])
    # posterior-factor health (a no-op unless a collector is installed);
    # fleets wanting per-track trend + alarms attach a
    # ``ranks.ConditionMonitor`` to their results instead
    obs.factor_health(R_new, "kalman")
    return KalmanState(R=R_new, d=out[..., w:w + n, w + n], step=state.step + 1)


def kf_step_batched(R: torch.Tensor, d: torch.Tensor, F: torch.Tensor,
                    Qi: torch.Tensor, H: torch.Tensor, z: torch.Tensor,
                    G: torch.Tensor | None = None,
                    *, backend: str = "pallas", block_b: int = 8, mesh=None,
                    precision=None):
    """Advance B independent SRIF filters one predict+observe step at once.

    R: (B, n, n), d: (B, n), z: (B, p); the model matrices ``F`` (n, n),
    ``Qi`` (w, w), ``H`` (p, n), ``G`` (n, w) may be shared (2-D, broadcast
    across the batch — the multi-target-tracking case of one dynamics model
    and many tracks) or per-filter (leading B dimension).  Returns
    ``(R', d')`` of the same batch shapes.

    The B stacked step matrices run through the batched row-append kernel
    (``backend="pallas"``, one launch per call) or the plain batched
    ``ggr_triangularize`` (``backend="reference"``).  ``mesh=`` is not
    ported yet and raises ``NotImplementedError``.

    ``precision``: mixed-precision policy (``Precision`` / name / None).
    """
    if mesh is not None:
        raise NotImplementedError("sharded (mesh=) dispatch is not ported yet")
    B, n = R.shape[0], R.shape[2]
    w = Qi.shape[-1]
    if precision is not None:
        precision = resolve_precision(precision)

    def bcast(M):
        if M is None or M.ndim == 3:
            return M
        return M.expand((B,) + M.shape)

    zb = z.expand((B,) + z.shape) if z.ndim == 1 else z
    stacked = _step_stacked(R, d, bcast(F), bcast(Qi), bcast(H), zb, bcast(G))
    out = _update_stacked(stacked, w + n, backend, block_b, precision=precision)
    R_new = torch.triu(out[:, w:w + n, w:w + n])
    # batch-wide posterior condition gauge (worst member estimated; see
    # obs.factor_health) — a no-op unless a collector is installed
    obs.factor_health(R_new, "kalman")
    return R_new, out[:, w:w + n, w + n]


def kf_filter(state: KalmanState, F: torch.Tensor, Qi: torch.Tensor, H: torch.Tensor,
              zs: torch.Tensor, G: torch.Tensor | None = None):
    """Run the filter over a (T, p) measurement sequence.

    Returns ``(final_state, KalmanTrajectory)`` — the trajectory stores each
    step's predicted and filtered ``(R, d)`` factors so ``kf_smooth`` can run
    its backward pass without re-filtering.
    """
    Rp, dp, Rf, df = [], [], [], []
    st = state
    for z in zs:
        pred = kf_predict(st, F, Qi, G)
        st = kf_observe(pred, H, z)
        Rp.append(pred.R)
        dp.append(pred.d)
        Rf.append(st.R)
        df.append(st.d)
    return st, KalmanTrajectory(Rp=torch.stack(Rp), dp=torch.stack(dp),
                                Rf=torch.stack(Rf), df=torch.stack(df))


def kf_smooth(traj: KalmanTrajectory, F: torch.Tensor):
    """RTS (Rauch-Tung-Striebel) backward pass on stored SRIF factors.

    For each step the smoother gain is ``C_t = P_f[t] F^T P_p[t+1]^{-1}``
    with ``P_p^{-1} = Rp^T Rp`` read directly off the stored predicted factor
    (no matrix inversion beyond triangular solves against the stored ``R``s):

        x_s[t] = x_f[t] + C_t (x_s[t+1] - x_p[t+1])
        P_s[t] = P_f[t] + C_t (P_s[t+1] - P_p[t+1]) C_t^T

    Returns ``(xs, Ps)`` of shapes (T, n) and (T, n, n).
    """
    Rp, dp, Rf, df = traj
    n = df.shape[1]
    eye = _eye_like(Rf, n).expand_as(Rf)

    def mean_cov(R, d):
        K = solve_triangular(R, eye)
        return solve_triangular(R, d), K @ K.transpose(-1, -2)

    xf, Pf = mean_cov(Rf, df)
    xp, Pp = mean_cov(Rp, dp)

    T = df.shape[0]
    xs, Ps = [xf[-1]], [Pf[-1]]
    for t in range(T - 2, -1, -1):
        C = Pf[t] @ F.T @ (Rp[t + 1].T @ Rp[t + 1])
        xs.append(xf[t] + C @ (xs[-1] - xp[t + 1]))
        Ps.append(Pf[t] + C @ (Ps[-1] - Pp[t + 1]) @ C.T)
    return torch.stack(xs[::-1]), torch.stack(Ps[::-1])
