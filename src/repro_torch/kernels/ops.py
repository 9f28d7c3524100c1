"""Public kernel entry points (the JAX package's ``kernels.ops`` names).

Every entry point keeps the JAX signature minus ``interpret``: the tensor's
device decides — a CPU tensor runs the plain PyTorch version, a CUDA tensor
the hand-written kernel (or raises).  Each also takes an optional leading
batch dimension.
"""
from __future__ import annotations

import torch

from .backend import Precision, resolve_precision
from .ggr_apply import apply_factors
from .ggr_panel import batched_geqrt, panel_factor
from .ggr_update import batched_update

__all__ = [
    "Precision",
    "resolve_precision",
    "panel_qr",
    "apply_panel",
    "batched_geqrt",
    "batched_update",
    "tsqrt",
    "ggr_qr_pallas",
]


def panel_qr(panel: torch.Tensor, pivot0: int = 0, precision=None):
    """(R, V, T) = fused GGR factorization of an (m, b) panel."""
    return panel_factor(panel, pivot0=pivot0, precision=precision)


def apply_panel(V, T, C, pivot0: int = 0, block_w: int = 256, precision=None):
    """Replay a factored panel's b transforms over trailing columns C."""
    return apply_factors(V, T, C, pivot0=pivot0, block_w=block_w,
                         precision=precision)


def tsqrt(R_top: torch.Tensor, B: torch.Tensor):
    """Stacked [R_top; B] factorization (the TSQRT tile op) via the panel kernel.

    Returns (R_new, V, T) where the stacked transform annihilates B entirely.
    """
    b = R_top.shape[-1]
    R, V, T = panel_qr(torch.cat([R_top, B], dim=-2), pivot0=0)
    return R[..., :b, :], V, T


def ggr_qr_pallas(A: torch.Tensor, panel: int = 32,
                  block_w: int = 256) -> torch.Tensor:
    """Full GGR QR with the fused kernels: dgeqr2ggr, right-looking panels.

    Per panel: one ``panel_factor`` launch factors the full-height panel with
    pivots ``c0 + c``, then one ``apply_factors`` launch replays its
    transforms over every column right of it, in place.  ``A`` is (m, n) or
    (B, m, n) with ``n % panel == 0``.  The production driver is
    ``core.blocked.ggr_qr_blocked``, whose frames shrink as rows finalize.
    """
    m, n = A.shape[-2:]
    if panel <= 0 or n % panel:
        raise ValueError(f"ggr_qr_pallas: pad columns to a panel multiple "
                         f"(n = {n}, panel = {panel})")
    R = A.clone()
    for c0 in range(0, n, panel):
        Rp, V, T = panel_factor(R[..., c0:c0 + panel], pivot0=c0)
        R[..., c0:c0 + panel] = Rp
        if c0 + panel < n:
            C = R[..., c0 + panel:]
            apply_factors(V, T, C, pivot0=c0, block_w=block_w, out=C)
    return torch.triu(R)
