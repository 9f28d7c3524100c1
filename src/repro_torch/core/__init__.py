"""Core GGR library — closed-form column steps, the blocked driver, the
paper's multiplication-count models, the baseline QR routines and the
distributed QR over ``torch.distributed``."""
from .baselines import (
    cgr_qr,
    givens_qr,
    householder_qr2,
    householder_qrf,
    mgs_qr,
    mht_qr,
)
from .blocked import (
    ggr_geqrt,
    ggr_qr_blocked,
    ggr_qr_blocked_reference,
    ggr_triangularize_blocked,
    ggr_tsqrt,
    suffix_col_norms,
)
from .counts import (
    MultCount,
    alpha_ratio,
    cgr_mults,
    count_mults,
    flops_by_dtype,
    ggr_append_mults,
    ggr_sweep_mults,
    gr_mults,
    mults_to_flops,
)
from .distributed import (
    cyclic_perm,
    distributed_ggr_qr_1d,
    distributed_orthogonalize,
    tsqr,
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
    "MultCount",
    "alpha_ratio",
    "apply_ggr_factors",
    "cgr_mults",
    "cgr_qr",
    "count_mults",
    "cyclic_perm",
    "distributed_ggr_qr_1d",
    "distributed_orthogonalize",
    "flops_by_dtype",
    "ggr_append_mults",
    "ggr_column_step",
    "ggr_column_step_at",
    "ggr_factor_column",
    "ggr_geqrt",
    "ggr_qr2",
    "ggr_qr_blocked",
    "ggr_qr_blocked_reference",
    "ggr_sweep_mults",
    "ggr_triangularize",
    "ggr_triangularize_blocked",
    "ggr_tsqrt",
    "givens_qr",
    "gr_mults",
    "householder_qr2",
    "householder_qrf",
    "mgs_qr",
    "mht_qr",
    "mults_to_flops",
    "suffix_col_norms",
    "suffix_norms",
    "tsqr",
]
