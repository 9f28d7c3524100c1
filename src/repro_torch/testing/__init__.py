"""repro_torch.testing: reusable numerical-verification harnesses.

Not imported by any production path — tests and ``chip_smoke.py`` pull from
here so their matrix suites, error metrics, tolerance budgets and fault
injectors stay in one place instead of drifting apart file by file.
"""
from .faults import (
    FaultInjector,
    FaultPlan,
    InjectedFatal,
    InjectedPoison,
    InjectedTransient,
    ScriptedInjector,
    inject,
    poison_workload,
)
from .error_harness import (
    DEFAULT_CONDS,
    DEFAULT_RANK_CONDS,
    DEFAULT_SHAPES,
    Case,
    RankCase,
    backward_error,
    budget_is_meaningful,
    dtype_eps,
    error_budget,
    factorization_errors,
    fleet_nis,
    forward_error,
    graded_matrix,
    gram_residual,
    matrix_suite,
    orthogonality_loss,
    rank_deficient_matrix,
    rank_deficient_suite,
    sign_align,
)

__all__ = [
    "Case",
    "DEFAULT_CONDS",
    "DEFAULT_RANK_CONDS",
    "DEFAULT_SHAPES",
    "FaultInjector",
    "FaultPlan",
    "InjectedFatal",
    "InjectedPoison",
    "InjectedTransient",
    "RankCase",
    "ScriptedInjector",
    "backward_error",
    "budget_is_meaningful",
    "dtype_eps",
    "error_budget",
    "factorization_errors",
    "fleet_nis",
    "forward_error",
    "graded_matrix",
    "gram_residual",
    "inject",
    "matrix_suite",
    "orthogonality_loss",
    "poison_workload",
    "rank_deficient_matrix",
    "rank_deficient_suite",
    "sign_align",
]
