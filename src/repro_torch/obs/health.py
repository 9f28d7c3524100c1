"""Numerical-health gauges for factor states.

Two signals, both cheap relative to the solves they watch:

* **Condition estimate** — min/max ``|diag(R)|`` of a triangular factor,
  plus a real 2-norm condition estimate (``condition_estimate``: a few
  power-iteration rounds for ``smax`` and inverse-iteration rounds through
  triangular solves for ``smin``, host f64).  ``r_cond_proxy`` is kept as an
  alias carrying the same estimate, as in the JAX package.  For a batch of
  factors the per-member ``|diag|`` ratio is screened **on the device** and
  only the member with the worst ratio is copied to the host for the
  estimate: a serving flush's (B, n, n) batch never crosses whole.  The
  incremental variant for streaming states lives in ``ranks.monitor``.
* **Orthogonality loss** — ``max |Q^T Q - I|`` with ``Q = A R^{-1}``
  reconstructed implicitly (Q is never formed by the GGR paths).  It is
  O(m n^2) — as expensive as the solve — so it is *sampled*:
  ``maybe_sample_orthogonality`` fires every ``REPRO_OBS_ORTHO_EVERY``-th
  eligible call (default 16).

Everything no-ops under the null registry, before any device transfer
happens, and under ``torch.compile`` tracing.
"""
from __future__ import annotations

import itertools
import os

import numpy as np
import torch

from ._state import _active

__all__ = [
    "condition_estimate",
    "factor_health",
    "orthogonality_loss",
    "ortho_tolerance",
    "maybe_sample_orthogonality",
]

_ortho_clock = itertools.count()


def _host64(x) -> np.ndarray:
    """A tensor or array as a host float64 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def condition_estimate(R, iters: int = 6) -> float:
    """2-norm condition estimate of one triangular factor (host f64).

    A few rounds of power iteration on ``R^T R`` estimate ``smax``; inverse
    iteration (two triangular solves per round) estimates ``smin``; the
    report is ``||R v_max|| / ||R v_min||``.  Deterministic alternating-ramp
    seeds (LINPACK-style), so the gauge is reproducible.  Converges from
    below.  An exactly-zero pivot returns ``inf`` directly."""
    Rf = np.triu(_host64(R))
    n = Rf.shape[-1]
    if Rf.shape[0] > n:
        Rf = Rf[:n]
    if n == 0:
        return float("nan")
    if not np.all(np.abs(np.diag(Rf)) > 0.0):
        return float(np.inf)
    i = np.arange(n)
    v = np.where(i % 2 == 0, 1.0, -1.0) * (1.0 + i / n)
    vmax = v / np.linalg.norm(v)
    vmin = vmax[::-1].copy()
    for _ in range(iters):
        w = Rf.T @ (Rf @ vmax)
        vmax = w / max(np.linalg.norm(w), np.finfo(np.float64).tiny)
        y = np.linalg.solve(Rf.T, vmin)
        z = np.linalg.solve(Rf, y)
        vmin = z / max(np.linalg.norm(z), np.finfo(np.float64).tiny)
    smax = np.linalg.norm(Rf @ vmax)
    smin = np.linalg.norm(Rf @ vmin)
    return float(smax / max(smin, np.finfo(np.float64).tiny))


def factor_health(R, layer: str, **labels) -> None:
    """Record min/max ``|diag(R)|`` + condition gauges for a triangular
    factor ``(n, n)`` or a batch ``(..., n, n)`` of them (the batch-wide
    excursion is what serving wants).  ``<layer>.r_cond_estimate`` carries
    the ``condition_estimate`` of the member with the worst diag ratio (the
    screen runs where R lives, in float64, and one factor is copied to the
    host); ``<layer>.r_cond_proxy`` is an alias of the same value.  Skips
    under the null registry and under ``torch.compile`` tracing."""
    reg = _active()
    if not reg.enabled or torch.compiler.is_compiling():
        return
    diag = torch.diagonal(R, dim1=-2, dim2=-1).abs().to(torch.float64)
    if diag.numel() == 0:
        return
    if R.ndim >= 3:
        diag = diag.reshape(-1, diag.shape[-1])
        lo, hi = diag.amin(-1), diag.amax(-1)
        ratios = torch.where(lo > 0.0, hi / lo, torch.inf)
        dmin, dmax, worst = torch.stack(
            [lo.min(), hi.max(), ratios.argmax().to(torch.float64)]).tolist()
        Rw = R.reshape(-1, *R.shape[-2:])[int(worst)]
    else:
        dmin, dmax = torch.stack([diag.min(), diag.max()]).tolist()
        Rw = R
    reg.gauge(f"{layer}.r_diag_min", **labels).set(dmin)
    reg.gauge(f"{layer}.r_diag_max", **labels).set(dmax)
    cond = condition_estimate(Rw)
    reg.gauge(f"{layer}.r_cond_estimate", **labels).set(cond)
    reg.gauge(f"{layer}.r_cond_proxy", **labels).set(cond)  # legacy alias


def orthogonality_loss(A, R) -> float:
    """``max |Q^T Q - I|`` for the implicit ``Q = A R^{-1}`` (float64 host
    computation; A is (m, n), R the (n, n) upper factor of its QR — a full
    (m, n) triangularized matrix is cut to its top (n, n) block)."""
    Af = _host64(A)
    Rf = np.triu(_host64(R))
    n = Rf.shape[-1]
    if Rf.shape[0] > n:
        Rf = Rf[:n]
    Qt = np.linalg.solve(Rf.T, Af.T)
    G = Qt @ Qt.T
    return float(np.abs(G - np.eye(n)).max())


def ortho_tolerance(n: int, dtype) -> float:
    """Alarm threshold for ``orthogonality_loss``: ``64 * n * eps(dtype)``,
    scaled by the *compute* dtype's machine epsilon so the same audit is
    honest across precision policies."""
    from repro_torch.kernels.backend import torch_dtype

    return 64.0 * float(n) * float(torch.finfo(torch_dtype(dtype)).eps)


def maybe_sample_orthogonality(A, R, layer: str, *, dtype=None,
                               **labels) -> float | None:
    """Sampled orthogonality audit: every N-th eligible call (N from
    ``REPRO_OBS_ORTHO_EVERY``, default 16) computes ``orthogonality_loss``
    and records it as ``<layer>.orthogonality_loss``; returns the loss when
    sampled, else None.

    Each sample is judged against ``ortho_tolerance(n, dtype)`` (``dtype``
    defaults to R's own dtype); breaches increment
    ``<layer>.orthogonality_alarms``."""
    reg = _active()
    if not reg.enabled or torch.compiler.is_compiling():
        return None
    every = int(os.environ.get("REPRO_OBS_ORTHO_EVERY", "16"))
    tick = next(_ortho_clock)
    if every > 1 and tick % every:
        return None
    loss = orthogonality_loss(A, R)
    reg.gauge(f"{layer}.orthogonality_loss", **labels).set(loss)
    reg.counter(f"{layer}.orthogonality_samples", **labels).inc()
    rdt = R.dtype if isinstance(R, torch.Tensor) else np.asarray(R).dtype
    tol = ortho_tolerance(R.shape[-1], rdt if dtype is None else dtype)
    reg.gauge(f"{layer}.orthogonality_tolerance", **labels).set(tol)
    if loss > tol:
        reg.counter(f"{layer}.orthogonality_alarms", **labels).inc()
    return loss
