"""Plain-PyTorch oracles for the GGR kernels (the correctness contract).

Semantics match ``core.ggr`` exactly: each oracle is a loop of the closed-form
column steps, with f32-promoted accumulation and core's dtype-keyed eps.  The
kernels' plain versions are held against these in the tests.  Every oracle
takes an optional leading batch dimension.
"""
from __future__ import annotations

import torch

from repro_torch.core.ggr import (GGRFactors, apply_ggr_factors, ggr_column_step_at,
                                  ggr_factor_column)

__all__ = [
    "ref_panel_factor",
    "ref_pivoted_panel_factor",
    "ref_apply_factors",
    "ref_det2_grid",
    "ref_suffix_stats",
]


def _acc(dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _revcumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.flip(dim).cumsum(dim).flip(dim)


def ref_suffix_stats(v: torch.Tensor, X: torch.Tensor):
    """(t, S): suffix norms of v and exclusive suffix dots of v against the
    columns of X (``v`` is (..., m), ``X`` (..., m, n))."""
    f32 = _acc(X.dtype)
    va = v.to(f32)
    t = torch.sqrt(_revcumsum(va * va, -1))
    P = _revcumsum(va[..., :, None] * X.to(f32), -2)
    S = torch.cat([P[..., 1:, :], torch.zeros_like(P[..., :1, :])], dim=-2)
    return t.to(X.dtype), S.to(X.dtype)


def ref_det2_grid(k: torch.Tensor, l: torch.Tensor, S: torch.Tensor,
                  X: torch.Tensor) -> torch.Tensor:
    """The RDP DET2 macro-op grid: out_{i+1,j} = k_i s_{ij} - l_i x_{ij}."""
    return k[..., :, None] * S - l[..., :, None] * X


def ref_panel_factor(panel: torch.Tensor, pivot0: int = 0):
    """Factor an (..., m, b) panel with pivots pivot0+c; returns (R, V, T)."""
    b = panel.shape[-1]
    X = panel
    V = torch.zeros_like(panel)
    T = torch.zeros_like(panel)
    for c in range(b):
        f = ggr_factor_column(X, c, pivot0 + c)
        X = ggr_column_step_at(X, c, pivot0 + c)
        V[..., c] = f.v
        T[..., c] = f.t
    return X, V, T


def ref_pivoted_panel_factor(panel: torch.Tensor):
    """Column-pivoted variant of ``ref_panel_factor`` (the QRCP oracle) for
    one (m, b) panel.

    Per step: trailing column norms — row ``c`` of the eq. 3 suffix-norm
    matrix — select the pivot, a column swap moves it in, and the ordinary
    GGR step annihilates it.  Returns ``(R, perm)``.
    """
    m, b = panel.shape
    f32 = _acc(panel.dtype)
    X = panel
    perm = list(range(b))
    for c in range(min(m, b)):
        Xa = X.to(f32)
        t2 = _revcumsum(Xa * Xa, 0)[c]
        j = c + int(torch.argmax(t2[c:]))
        if j != c:
            idx = list(range(b))
            idx[c], idx[j] = idx[j], idx[c]
            X = X[:, idx]
            perm[c], perm[j] = perm[j], perm[c]
        if c < m - 1:
            X = ggr_column_step_at(X, c)
    return torch.triu(X), torch.tensor(perm, dtype=torch.int32)


def ref_apply_factors(V: torch.Tensor, T: torch.Tensor, C: torch.Tensor,
                      pivot0: int = 0) -> torch.Tensor:
    """Replay b stored GGR column transforms on trailing columns C."""
    for c in range(V.shape[-1]):
        C = apply_ggr_factors(GGRFactors(v=V[..., c], t=T[..., c]), C, pivot0 + c)
    return C
