"""repro_torch.ranks: rank-aware linear algebra on the GGR sweeps.

* ``pivoted`` — column-pivoted GGR QR (``ggr_qr_pivoted``), an
  rcond-relative numerical rank estimator, and the min-norm
  ``lstsq_pivoted`` solve that the serving ``lstsq_pivoted`` kind
  dispatches.
* ``monitor`` — streaming condition estimation for ``(R, d)`` states
  (``cond_estimate`` / ``ConditionMonitor``) and the hyperbolic
  ``DowndateGuard`` that refuses or damps downdates about to cross the rank
  cliff (wired into ``solvers.qr_update``).
* ``sketch`` — sketch-and-precondition least squares (``sketch_lstsq``):
  CountSketch/SRHT embedding -> GGR QR of the sketch -> right-preconditioned
  LSQR, with the TSQR tree coupling reused for multi-shard sketch reduction.
"""
from .monitor import (
    CondState,
    ConditionMonitor,
    DowndateGuard,
    batch_cond_estimate,
    cond_estimate,
)
from .pivoted import (
    PivotedLstsq,
    PivotedQR,
    estimate_rank,
    ggr_qr_pivoted,
    lstsq_pivoted,
)
from .sketch import (
    SketchedLstsq,
    countsketch,
    lsqr,
    sketch_lstsq,
    sketch_qr,
    srht,
)

__all__ = [
    "CondState",
    "ConditionMonitor",
    "DowndateGuard",
    "PivotedLstsq",
    "PivotedQR",
    "SketchedLstsq",
    "batch_cond_estimate",
    "cond_estimate",
    "countsketch",
    "estimate_rank",
    "ggr_qr_pivoted",
    "lsqr",
    "lstsq_pivoted",
    "sketch_lstsq",
    "sketch_qr",
    "srht",
]
