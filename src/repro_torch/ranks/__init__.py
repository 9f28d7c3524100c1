"""repro_torch.ranks: rank-aware linear algebra on the GGR sweeps.

``pivoted`` — column-pivoted GGR QR (``ggr_qr_pivoted``), an rcond-relative
numerical rank estimator, and the min-norm ``lstsq_pivoted`` solve that the
serving ``lstsq_pivoted`` kind dispatches.  The condition monitor and the
sketch solvers are not ported yet.
"""
from .pivoted import (
    PivotedLstsq,
    PivotedQR,
    estimate_rank,
    ggr_qr_pivoted,
    lstsq_pivoted,
)

__all__ = [
    "PivotedLstsq",
    "PivotedQR",
    "estimate_rank",
    "ggr_qr_pivoted",
    "lstsq_pivoted",
]
