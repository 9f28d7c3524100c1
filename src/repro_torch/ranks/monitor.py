"""Streaming condition monitoring and the hyperbolic downdate guard.

A streaming ``(R, d)`` state drifts toward the rank cliff one update at a
time — an over-forgotten window, a collinear burst of observations — and the
``|diag R|`` ratio only *lower-bounds* the damage.  This module carries a
real 2-norm condition estimate alongside the state:

* ``cond_estimate`` — power iteration (for ``smax``) + inverse iteration via
  the solvers' eps-guarded triangular solves (for ``smin``) on a triangular
  factor, or on a batch of them.  Pass the previous ``CondState`` back in
  and one iteration per update suffices, because the singular vectors move
  slowly under rank-1-ish updates — that persistence is what makes the
  estimate *incremental* (O(n^2) per refresh, vs O(n^3) from scratch).
* ``ConditionMonitor`` — host-side wrapper that tracks a stream of factors,
  records ``<layer>.cond_estimate`` gauges through ``repro_torch.obs``, and
  counts alarm crossings.
* ``DowndateGuard`` — the hyperbolic safety valve for ``qr_downdate_row``:
  the downdate cascade's ``alpha^2 = 1 - ||R^{-T} u||^2`` measures how close
  the removed row comes to annihilating a direction of the factor.  The
  guard refuses (or damps to the ``tau`` floor) any downdate with
  ``alpha^2 < tau``, or raises.  Wired through
  ``solvers.qr_update.qr_downdate_row(guard=...)`` and
  ``RecursiveLS.forget``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.solvers.lstsq import solve_triangular

__all__ = ["CondState", "ConditionMonitor", "DowndateGuard",
           "batch_cond_estimate", "cond_estimate"]


class CondState(NamedTuple):
    """One condition estimate plus the singular-vector carry that makes the
    next refresh incremental (leading batch dims follow R's)."""

    cond: torch.Tensor   # (...) estimated cond_2(R) = smax / smin
    smax: torch.Tensor   # (...) largest-singular-value estimate
    smin: torch.Tensor   # (...) smallest-singular-value estimate
    vmax: torch.Tensor   # (..., n) right singular vector carry for smax
    vmin: torch.Tensor   # (..., n) right singular vector carry for smin


def _seed_vec(n: int, dtype, device) -> torch.Tensor:
    """Deterministic, all-direction-touching start vector (LINPACK-style
    alternating ramp) — no RNG so the estimate is reproducible."""
    i = torch.arange(n, dtype=dtype, device=device)
    v = torch.where(i % 2 == 0, 1.0, -1.0) * (1.0 + i / n)
    return v / torch.linalg.norm(v)


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def cond_estimate(R: torch.Tensor, state: CondState | None = None,
                  iters: int = 4) -> CondState:
    """Estimate ``cond_2(R)`` of a triangular factor ``(n, n)`` or of each
    factor of a batch ``(..., n, n)``.

    ``iters`` rounds of power iteration on ``R^T R`` drive ``vmax`` toward
    the top right-singular vector, and inverse iteration (two triangular
    solves per round — the solvers' own eps-guarded ``solve_triangular``)
    drives ``vmin`` toward the bottom one; the final norms ``||R v||`` are
    the singular-value estimates.  The reported cond is a slight
    *underestimate* — pair alarm thresholds with headroom.

    Passing the previous ``CondState`` reuses its singular-vector carry:
    after a streaming append/downdate one iteration re-converges.  A
    numerically singular R saturates the inverse iteration through the
    eps-guarded solves rather than dividing by zero (cond comes back huge
    but finite).
    """
    f32 = torch.promote_types(R.dtype, torch.float32)
    Ra = torch.triu(R).to(f32)
    n = Ra.shape[-1]
    if state is None:
        seed = _seed_vec(n, f32, Ra.device).expand(*Ra.shape[:-2], n)
        vmax, vmin = seed, seed.flip(-1)
    else:
        vmax, vmin = state.vmax.to(f32), state.vmin.to(f32)

    tiny = torch.finfo(f32).tiny
    RaT = Ra.transpose(-1, -2)
    for _ in range(iters):
        w = _matvec(RaT, _matvec(Ra, vmax))
        vmax = w / torch.linalg.norm(w, dim=-1, keepdim=True).clamp(min=tiny)
        y = solve_triangular(Ra, vmin, trans=True)   # R^T y = v
        z = solve_triangular(Ra, y)                  # R z = y
        vmin = z / torch.linalg.norm(z, dim=-1, keepdim=True).clamp(min=tiny)
    smax = torch.linalg.norm(_matvec(Ra, vmax), dim=-1)
    smin = torch.linalg.norm(_matvec(Ra, vmin), dim=-1)
    # the eps-guarded solves *annihilate* an exactly-collapsed direction
    # instead of blowing up on it, which would leave the iterate blind to a
    # zero pivot; smin <= min|r_ii| for any triangular factor, so clamping
    # restores the honest (still upper) bound there
    smin = torch.minimum(smin, torch.diagonal(Ra, dim1=-2, dim2=-1).abs().amin(-1))
    cond = smax / smin.clamp(min=tiny)
    return CondState(cond=cond, smax=smax, smin=smin, vmax=vmax, vmin=vmin)


def batch_cond_estimate(Rb: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """Per-factor ``cond_2`` estimates for a stacked batch of triangular
    factors: ``(B, n, n) -> (B,)`` — ``cond_estimate`` over the batch in one
    batched pass (fresh seed vectors, no carry)."""
    return cond_estimate(torch.as_tensor(Rb), iters=iters).cond


class ConditionMonitor:
    """Host-side condition tracker for a stream of triangular factors.

    Call ``observe(R)`` after each append/downdate: the first call pays the
    full ``iters`` refresh, subsequent calls ride the singular-vector carry
    with ``refresh_iters`` (default 1) — the incremental estimate.  Records
    ``<layer>.cond_estimate`` (gauge) and ``<layer>.cond_alarms`` (counter,
    when ``alarm_cond`` is crossed) through ``repro_torch.obs``.  Each
    observation reads the estimate to the host (one synchronization).
    """

    def __init__(self, layer: str = "solvers", alarm_cond: float | None = None,
                 iters: int = 4, refresh_iters: int = 1):
        self.layer = layer
        self.alarm_cond = alarm_cond
        self.iters = iters
        self.refresh_iters = refresh_iters
        self.state: CondState | None = None
        self.alarms = 0

    def observe(self, R, **labels) -> float:
        """Fold one factor into the estimate; returns the current cond."""
        it = self.iters if self.state is None else self.refresh_iters
        self.state = cond_estimate(torch.as_tensor(R), self.state, iters=it)
        cond = float(self.state.cond)
        if obs.enabled():
            obs.gauge(f"{self.layer}.cond_estimate", **labels).set(cond)
            obs.gauge(f"{self.layer}.smin_estimate", **labels).set(
                float(self.state.smin))
        if self.alarm_cond is not None and cond > self.alarm_cond:
            self.alarms += 1
            if obs.enabled():
                obs.counter(f"{self.layer}.cond_alarms", **labels).inc()
        return cond


class DowndateGuard(NamedTuple):
    """Policy for downdates that would cross the rank cliff.

    The downdate cascade computes ``alpha^2 = 1 - ||R^{-T} u||^2``; at 0 the
    removed row exactly annihilates a direction of the factor and the
    hyperbolic rotation blows up.  ``tau`` is the floor on ``alpha^2``:

    * ``mode="damp"``  — shrink the removed row just enough that
      ``alpha^2 == tau`` (removes *most* of the observation, keeps the
      factor at the guard's distance from singularity).  The default.
    * ``mode="refuse"`` — return the state unchanged, bit for bit.
    * ``mode="raise"``  — raise ``FloatingPointError`` with a diagnostic.
      PyTorch runs eagerly, so this always raises (the JAX package degrades
      it to "refuse" under tracing).
    """

    tau: float = 1e-6
    mode: str = "damp"

    def validate(self) -> "DowndateGuard":
        if not 0.0 < self.tau < 1.0:
            raise ValueError(f"guard tau must be in (0, 1), got {self.tau}")
        if self.mode not in ("damp", "refuse", "raise"):
            raise ValueError(f"unknown guard mode {self.mode!r}")
        return self


def guard_downdate_q(qv: torch.Tensor, guard: DowndateGuard):
    """Apply a guard to the downdate's solved direction ``q = R^{-T} u``.

    Returns ``(q', triggered)``: ``q'`` is the (possibly damped) direction
    whose seeded suffix cascade stays at least ``tau`` from the cliff, and
    ``triggered`` a 0-d bool tensor (left on the device).  "refuse" leaves q
    untouched — the caller keeps the original state when triggered.
    Called by ``solvers.qr_update._downdate_core``, where "raise" happens.
    """
    qq = qv @ qv
    triggered = (1.0 - qq) < guard.tau
    if guard.mode == "damp":
        # scale so ||q'||^2 = 1 - tau  =>  alpha'^2 = tau exactly
        g = torch.sqrt((1.0 - guard.tau) / qq.clamp(min=guard.tau))
        qv = torch.where(triggered, g * qv, qv)
    return qv, triggered


def _record_guard_trigger(triggered, layer: str = "solvers") -> None:
    """Count guard trips; under the null registry nothing is read back from
    the device."""
    if not obs.enabled():
        return
    if bool(triggered):
        obs.counter(f"{layer}.downdate_guard_trips").inc()
