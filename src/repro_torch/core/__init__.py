"""Core GGR library — closed-form column steps and the blocked driver."""
from .blocked import (
    ggr_geqrt,
    ggr_qr_blocked,
    ggr_qr_blocked_reference,
    ggr_triangularize_blocked,
    ggr_tsqrt,
    suffix_col_norms,
)
from .ggr import (
    GGRFactors,
    apply_ggr_factors,
    ggr_column_step,
    ggr_column_step_at,
    ggr_factor_column,
    ggr_qr2,
    ggr_triangularize,
    suffix_norms,
)

__all__ = [
    "GGRFactors",
    "apply_ggr_factors",
    "ggr_column_step",
    "ggr_column_step_at",
    "ggr_factor_column",
    "ggr_geqrt",
    "ggr_qr2",
    "ggr_qr_blocked",
    "ggr_qr_blocked_reference",
    "ggr_triangularize",
    "ggr_triangularize_blocked",
    "ggr_tsqrt",
    "suffix_col_norms",
    "suffix_norms",
]
