"""Distributed GGR QR — the REDEFINE K x K tile-array scheme mapped to the
ranks of a ``torch.distributed`` process group.

The port runs SPMD, one process a rank; each function is called on every rank
of ``group`` (the default group when ``None``) with that rank's shard.  Three
entry points:

* ``distributed_ggr_qr_1d`` — 1-D block-cyclic panel QR over the ranks (the
  paper's scheme-1: the owning rank factors a panel,
  ``kernels.ggr_panel.panel_factor``; its compact factors (V, T) go to every
  rank by one ``dist.broadcast`` from the owner, the NoC broadcast; every
  rank replays them over its own later panels, ``kernels.ggr_apply.
  apply_factors``, one launch).

* ``tsqr`` — communication-avoiding tall-skinny QR: a local GGR factor and a
  binary reduction tree of stacked-R GGR factorizations.  Round r exchanges R
  factors inside the pair {i, i ^ 2^r}, one broadcast from each end — the n^2
  elements each way of the reference's ``ppermute``.

* ``distributed_orthogonalize`` — Q = A · R⁻¹ from ``tsqr`` (+ one optional
  refinement).

Every exchange is a ``dist.broadcast``: gloo carries broadcast on CUDA tensors
as NCCL does, so several gloo ranks on one card run the exchange code that
NCCL runs across cards.  Each R of ``tsqr`` is the blocked driver's fused
schedule over ``min(m - 1, n)`` pivots, which reproduces the reference's
``ggr_geqrt`` R (its last row of a square input unnormalized) without forming
the m x m transform ``ggr_geqrt`` carries.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.ggr_apply import apply_factors
from repro_torch.kernels.ggr_panel import panel_factor

from .blocked import ggr_triangularize_blocked

__all__ = [
    "cyclic_perm",
    "distributed_ggr_qr_1d",
    "distributed_orthogonalize",
    "tsqr",
    "tsqr_local_r",
]


def _group(group):
    return dist.group.WORLD if group is None else group


def _broadcast(t: torch.Tensor, src: int, group) -> None:
    """Broadcast ``t`` from the rank ``src`` of ``group``, in place."""
    dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)


def _gather_columns(X: torch.Tensor, group, nP: int) -> torch.Tensor:
    """The column blocks of every rank, concatenated in rank order: one
    broadcast of each rank's block (gloo carries no all_gather of CUDA
    tensors)."""
    me = dist.get_rank(group)
    out = X.new_empty((X.shape[0], nP * X.shape[1]))
    for r, blk in enumerate(out.tensor_split(nP, dim=1)):
        buf = X.contiguous() if r == me else torch.empty_like(X)
        _broadcast(buf, r, group)
        blk.copy_(buf)
    return out


def cyclic_perm(n: int, nP: int, panel: int):
    """Permutation: logical column order -> block-cyclic storage order.

    Storage layout = concat over ranks d of panels (d, d+nP, d+2nP, ...),
    i.e. rank d owns logical panels {p : p % nP == d} (paper scheme-1 load
    balancing: as the factorization shrinks, work stays spread across CEs).
    Returns (perm, inv) index arrays with ``stored = logical[:, perm]``.
    """
    npanels = n // panel
    order = []
    for d in range(nP):
        for p in range(d, npanels, nP):
            order.extend(range(p * panel, (p + 1) * panel))
    perm = np.asarray(order)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    return perm, inv


def distributed_ggr_qr_1d(A: torch.Tensor, group=None, panel: int = 32,
                          layout: str = "logical") -> torch.Tensor:
    """QR of an (m, n) matrix whose columns are split over the ranks of
    ``group``; ``A`` is this rank's (m, n / P) shard and the result is this
    rank's shard of R, in the same layout.

    ``layout="logical"``: rank r holds the contiguous columns r·n/P ..
    (r+1)·n/P; the block-cyclic redistribution happens internally (P
    broadcasts each way) and R comes back triangular, in logical order.
    ``layout="cyclic"``: rank r ALREADY holds the logical panels {p : p % P ==
    r}, in order, and gets R's columns of those panels — skips both
    permutation exchanges, for producers and consumers that live in cyclic
    layout.

    Per panel p: the owner (p mod P) factors its stored panel at pivot row
    p·panel, all ``panel`` columns (a pivot on the last row is
    sign-normalized); (V, T) go to every rank by one broadcast from the owner;
    every rank updates the local panels after p — a contiguous suffix of its
    slots, one launch.  Raises ``ValueError`` unless ``n % panel == 0`` and
    the panel count is a multiple of P.
    """
    if layout not in ("logical", "cyclic"):
        raise ValueError(f"unknown layout {layout!r}")
    group = _group(group)
    nP, me = dist.get_world_size(group), dist.get_rank(group)
    m, n_local = A.shape
    n = n_local * nP
    if n % panel:
        raise ValueError(f"pad columns to a panel multiple: n = {n}, panel = {panel}")
    npanels = n // panel
    if npanels % nP:
        raise ValueError(f"{npanels} panels do not divide evenly over {nP} ranks")
    local_panels = npanels // nP

    if layout == "logical":
        perm, inv = cyclic_perm(n, nP, panel)
        cols = torch.as_tensor(perm[me * n_local:(me + 1) * n_local], device=A.device)
        Al = _gather_columns(A, group, nP)[:, cols]
    else:
        Al = A.clone(memory_format=torch.contiguous_format)

    for p in range(npanels):
        owner, slot, pivot0 = p % nP, p // nP, p * panel
        if me == owner:
            cols_p = slice(slot * panel, (slot + 1) * panel)
            Rp, V, T = panel_factor(Al[:, cols_p], pivot0=pivot0)
            Al[:, cols_p] = Rp
            VT = torch.stack([V, T])
        else:
            VT = Al.new_empty((2, m, panel))
        _broadcast(VT, owner, group)
        first = (p - me) // nP + 1  # this rank's first slot after panel p
        if first < local_panels:
            C = Al[:, first * panel:]
            apply_factors(VT[0], VT[1], C, pivot0=pivot0, out=C)

    if layout == "cyclic":
        return Al
    cols = torch.as_tensor(inv[me * n_local:(me + 1) * n_local], device=A.device)
    return torch.triu(_gather_columns(Al, group, nP)[:, cols],
                      diagonal=-me * n_local)


# ---------------------------------------------------------------------------
# TSQR (communication-avoiding tall-skinny QR) — beyond-paper optimization
# ---------------------------------------------------------------------------
def _r_factor(X: torch.Tensor) -> torch.Tensor:
    """(n x n) R of an (m, n) matrix, m >= n, as the reference's
    ``ggr_geqrt`` gives it: ``min(m - 1, n)`` pivots, through the fused
    schedule (the GGR kernels on the card)."""
    m, n = X.shape
    k = min(m - 1, n)
    R = X if k == 0 else ggr_triangularize_blocked(X, k, schedule="fused")
    return torch.triu(R)[:n]


def tsqr_local_r(A_local: torch.Tensor) -> torch.Tensor:
    """Local GGR factor of the row-shard; returns the (n x n) R factor.
    Raises ``ValueError`` for a shard with fewer rows than columns."""
    m, n = A_local.shape
    if m < n:
        raise ValueError(f"tsqr needs at least as many local rows as columns, "
                         f"got a ({m}, {n}) shard")
    return _r_factor(A_local)


# group -> {global ranks of a pair: the pair's process group}; a group's
# entry goes with the group itself (weak keys: once it is destroyed and
# dropped, e.g. by ``dist.destroy_process_group``)
_PAIRS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _pair_group(group, a: int, b: int):
    """The process group of the global ranks {a, b} of ``group``, built on
    first use by the pair alone (``use_local_synchronization``: no other
    rank enters ``dist.new_group``, so pairs of a subgroup work too) and
    cached under ``group``."""
    pairs = _PAIRS.setdefault(group, {})
    key = (min(a, b), max(a, b))
    if key not in pairs:
        pairs[key] = dist.new_group(list(key), use_local_synchronization=True)
    return pairs[key]


def tsqr(A_local: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce-style TSQR: the global R (replicated on every rank) of the
    (m, n) matrix whose rows are split over the ranks of ``group``;
    ``A_local`` is this rank's row block, at least n rows.

    log2(P) rounds; round r exchanges R factors with the rank 2^r away (one
    broadcast from each end of the pair) and re-factors the stacked 2n x n —
    the paper's TSQRT tile op as the reduction operator.  P must be a power
    of two (``ValueError`` otherwise).
    """
    group = _group(group)
    nP, me = dist.get_world_size(group), dist.get_rank(group)
    if nP & (nP - 1):
        raise ValueError(f"tsqr needs a power-of-two number of ranks, got {nP}")
    R = tsqr_local_r(A_local).contiguous()
    for r in range(nP.bit_length() - 1):
        ends = [dist.get_global_rank(group, i)
                for i in (me & ~(1 << r), me | (1 << r))]
        pair = _pair_group(group, *ends)
        bufs = []
        for end in ends:  # the low end's R first, on both ranks
            buf = R if end == dist.get_rank() else torch.empty_like(R)
            dist.broadcast(buf, src=end, group=pair)
            bufs.append(buf)
        R = _r_factor(torch.cat(bufs, dim=0)).contiguous()
    return R


def distributed_orthogonalize(A_local: torch.Tensor, group=None,
                              eps: float = 1e-7, refine: bool = True) -> torch.Tensor:
    """Orthonormalize the columns of a row-split tall matrix: Q = A · R⁻¹,
    this rank's row block of Q.

    R from communication-avoiding GGR TSQR; the triangular solve is local (R
    is replicated).  One optional re-orthogonalization pass ("twice is
    enough").  Used by the Orthant optimizer for model-parallel parameters.
    """
    n = A_local.shape[1]

    def solve_q(Al, R):
        ct = torch.promote_types(Al.dtype, torch.float32)
        scale = R.diagonal().abs().max().to(ct) + 1e-30
        Rs = (R.to(ct) + (eps * scale) * torch.eye(n, dtype=ct, device=R.device))
        q = torch.linalg.solve_triangular(Rs, Al.to(ct), upper=True, left=False)
        return q.to(Al.dtype)

    q = solve_q(A_local, tsqr(A_local, group))
    if refine:
        q = solve_q(q, tsqr(q, group))
    return q
