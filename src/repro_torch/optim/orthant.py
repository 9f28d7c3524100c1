"""Orthant — GGR-orthogonalized momentum optimizer (Muon-class).

The paper's technique on the LM-training critical path: for every >=2-D
parameter, the momentum matrix is orthogonalized through a GGR QR
factorization (Q = M·R⁻¹ — "CholeskyQR-style" but with the R factor coming
from the paper's fused Givens sweep, which is numerically stable where
Gram-based R is not).  1-D parameters (norm scales, biases) fall back to
AdamW moments.

R is the blocked driver's fused schedule (``kernels.ggr_panel.panel_factor``
and ``kernels.ggr_apply.apply_factors`` on the card) over ``min(m - 1, n)``
pivots: the R of the reference's ``ggr_geqrt``, whose last row of a square
matrix is left unnormalized, so a square momentum's direction keeps the
reference's sign in its last column.  Stacked (scanned-layer) parameters
fold their leading dimensions into one batch of the driver: one call a leaf.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.blocked import ggr_triangularize_blocked
from repro_torch.models import mesh_ops

from ._tree import tree_map, zeros_f32


class OrthantState(NamedTuple):
    step: torch.Tensor
    momentum: dict  # f32 momentum for every param
    v: dict  # second moment, used only by the 1-D AdamW fallback


def _orthogonalize_2d(m: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Q = M R⁻¹ of each matrix of a (B, a, b) batch, R from GGR QR of the
    (transposed-to-tall) matrix."""
    a, b = m.shape[-2:]
    mt = m.mT if a < b else m  # tall
    rows, n = mt.shape[-2:]
    mf = mt.to(torch.float32)
    scale = torch.sqrt((mf * mf).mean((-2, -1), keepdim=True) + 1e-20)
    mf = mf / scale
    R = torch.triu(ggr_triangularize_blocked(mf, min(rows - 1, n), schedule="fused"))
    R = R[..., :n, :]
    diag = R.diagonal(dim1=-2, dim2=-1).abs()
    shift = eps * (diag.amax(-1) + 1e-20)
    Rs = R + shift[:, None, None] * torch.eye(n, dtype=R.dtype, device=R.device)
    q = torch.linalg.solve_triangular(Rs, mf, upper=True, left=False)
    q = torch.where(torch.isfinite(q), q, 0.0)
    return (q if a >= b else q.mT).to(m.dtype)


def _orthogonalize(m: torch.Tensor) -> torch.Tensor:
    """``_orthogonalize_2d`` of every matrix of ``m`` (its last two
    dimensions), the leading dimensions folded into one batch.

    A sharded ``m`` (a ``DTensor`` on a mesh) is orthogonalized whole on
    every rank, as GSPMD runs a kernel that has no sharding rule: each rank
    gathers it (``full_tensor``), runs the same QR on the same bits, and
    keeps its own block of the direction, so every rank's copy of a
    replicated block is the same."""
    if mesh_ops.is_dtensor(m):
        from torch.distributed.tensor import DTensor, Replicate

        mesh = m.device_mesh
        q = DTensor.from_local(_orthogonalize(m.full_tensor()), mesh,
                               [Replicate()] * mesh.ndim, run_check=False)
        return q.redistribute(mesh, m.placements)
    return _orthogonalize_2d(m.reshape(-1, *m.shape[-2:])).reshape(m.shape)


def init(params) -> OrthantState:
    z = zeros_f32(params)
    return OrthantState(step=torch.zeros((), dtype=torch.int32), momentum=z,
                        v=tree_map(torch.clone, z))


def update(
    grads,
    state: OrthantState,
    params,
    lr: float | torch.Tensor,
    beta: float = 0.95,
    weight_decay: float = 0.1,
    fallback_b2: float = 0.95,
    fallback_eps: float = 1e-8,
):
    step = state.step + 1

    def upd(g, mom, v, p):
        g = g.to(torch.float32)
        mom2 = beta * mom + (1 - beta) * g
        if p.ndim >= 2 and min(p.shape[-2:]) > 1:
            direction = _orthogonalize(mom2)
            # Muon-style shape-aware scale
            scale = math.sqrt(max(1.0, p.shape[-2] / p.shape[-1]))
            delta = scale * direction + weight_decay * p.to(torch.float32)
            v2 = v
        else:
            v2 = fallback_b2 * v + (1 - fallback_b2) * g * g
            delta = mom2 / (torch.sqrt(v2) + fallback_eps) + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), mom2, v2

    new_params, momentum, v = tree_map(upd, grads, state.momentum, state.v, params,
                                       n_out=3)
    return new_params, OrthantState(step=step, momentum=momentum, v=v)
