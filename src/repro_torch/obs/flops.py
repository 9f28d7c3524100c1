"""Flop accounting: achieved-GFLOP/s per dispatch from the analytic models.

The flop numbers come from the ``core.counts`` analytic multiplication
models (eqs. 3-5 and their rectangular/append generalizations,
``ggr_sweep_mults`` / ``ggr_append_mults``) converted with
``mults_to_flops`` (each macro-op multiplication pairs with one add in the
DET2/FMA grids).

``record_dispatch`` is the single chokepoint every instrumented dispatch
site funnels through: it observes ``<layer>.dispatch_seconds`` and
``<layer>.achieved_gflops`` histograms and bumps ``<layer>.dispatches`` —
one histogram sample per dispatch.

``repro_torch.core.counts`` is imported lazily: ``core.blocked`` imports
``repro_torch.obs`` at module scope, and the ``repro_torch.core`` package
init imports ``core.blocked`` — a top-level counts import here would close
that cycle.
"""
from __future__ import annotations

from ._state import _active

__all__ = [
    "ggr_sweep_flops",
    "ggr_append_flops",
    "lstsq_flops",
    "flops_by_dtype",
    "record_dispatch",
]


def ggr_sweep_flops(m: int, w: int, n_pivots: int | None = None) -> int:
    """Flops of one dense GGR triangularization sweep on an (m, w) matrix."""
    from repro_torch.core.counts import ggr_sweep_mults, mults_to_flops

    return mults_to_flops(ggr_sweep_mults(m, w, n_pivots))


def ggr_append_flops(n: int, p: int, w: int) -> int:
    """Flops of one compact active-set row-append sweep: (n, n) triangular R
    plus p appended rows, total width w (>= n when rhs columns ride along)."""
    from repro_torch.core.counts import ggr_append_mults, mults_to_flops

    return mults_to_flops(ggr_append_mults(n, p, w))


def lstsq_flops(m: int, n: int, k: int) -> int:
    """Flops of one augmented least-squares solve: the dense sweep over
    ``[A | b]`` (m, n+k) with n pivots plus the (n^2 k)-flop back solve."""
    return ggr_sweep_flops(m, n + k, n) + n * n * k


def flops_by_dtype(flops: float, compute_dtype="float32",
                   accum_dtype=None) -> dict:
    """Split a total dispatch flop count by execution dtype.

    Thin adapter over :func:`repro_torch.core.counts.flops_by_dtype` (which
    works in model *mults* = flops/2): multiplies run at the tile compute
    dtype, their paired adds at the accumulator dtype, values sum to
    ``flops``."""
    from repro_torch.core.counts import flops_by_dtype as _split

    return _split(int(flops) // 2, compute_dtype, accum_dtype)


def record_dispatch(layer: str, flops: float, seconds: float, *,
                    by_dtype: dict | None = None, **labels) -> None:
    """Record one timed dispatch: duration + achieved GFLOP/s histograms.

    ``seconds`` must come from a blocked timer (``obs.device_timer``) or the
    rate is fiction.  ``by_dtype`` (``{dtype_name: flops}``, e.g. from
    :func:`flops_by_dtype`) additionally bumps per-dtype
    ``<layer>.flops_total`` counters.  No-op under the null registry.
    """
    reg = _active()
    if not reg.enabled:
        return
    reg.counter(f"{layer}.dispatches", **labels).inc()
    reg.histogram(f"{layer}.dispatch_seconds", **labels).observe(seconds)
    if seconds > 0.0:
        reg.histogram(f"{layer}.achieved_gflops", **labels).observe(
            flops / seconds / 1e9)
    if by_dtype:
        for dt, f in by_dtype.items():
            reg.counter(f"{layer}.flops_total", dtype=str(dt),
                        **labels).inc(float(f))
