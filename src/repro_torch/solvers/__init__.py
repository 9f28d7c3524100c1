"""repro_torch.solvers — streaming QR updates, least squares and SRIF Kalman
filtering on GGR.

Instead of re-factorizing an ever-growing matrix, maintain a compact
``(R, d)`` state and apply Givens-based up/downdates; batches of independent
small updates run as one launch of the batched row-append kernel (one a
shard over a ``parallel.BatchMesh``).
"""
from .kalman import (
    KalmanState,
    KalmanTrajectory,
    info_sqrt,
    kf_cov,
    kf_filter,
    kf_init,
    kf_mean,
    kf_observe,
    kf_predict,
    kf_smooth,
    kf_step,
    kf_step_batched,
    whiten_measurement,
)
from .lstsq import (LstsqResult, RecursiveLS, RLSState, ggr_lstsq, solve_triangular,
                    state_integrity)
from .qr_update import (
    qr_append_rows,
    qr_append_rows_batched,
    qr_downdate_row,
    qr_rank1_update,
)

__all__ = [
    "KalmanState",
    "KalmanTrajectory",
    "LstsqResult",
    "RLSState",
    "RecursiveLS",
    "ggr_lstsq",
    "info_sqrt",
    "kf_cov",
    "kf_filter",
    "kf_init",
    "kf_mean",
    "kf_observe",
    "kf_predict",
    "kf_smooth",
    "kf_step",
    "kf_step_batched",
    "qr_append_rows",
    "qr_append_rows_batched",
    "qr_downdate_row",
    "qr_rank1_update",
    "solve_triangular",
    "state_integrity",
    "whiten_measurement",
]
