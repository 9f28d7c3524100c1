"""Sketch-and-precondition least squares: CountSketch/SRHT -> GGR QR -> LSQR.

For tall-skinny ill-conditioned problems (m >> n, cond up to ~1e8) plain
LSQR needs O(cond) iterations; the Blendenpik/LSRN recipe fixes that:

1. **Sketch** ``S A`` with a subspace embedding — ``countsketch`` (one
   scatter-add pass, O(nnz)) or ``srht`` (signed fast Walsh-Hadamard
   transform + row sampling, O(m n log m)), ``s ~ 4n`` rows.
2. **GGR QR of the sketch** (size-routed through the same blocked driver as
   every other factorization here — on the card a (1024, 256) sketch runs
   the fused schedule's panel and apply kernels): ``S A = Q_s R_s``.
3. **Preconditioned LSQR** on ``B = A R_s^{-1}`` (right preconditioner):
   with an (eps, delta)-embedding, ``cond(B) <= (1+eps)/(1-eps)``
   *independent of cond(A)*, and LSQR converges in tens of iterations;
   ``x = R_s^{-1} y``.

The hash, sign and row streams are host numpy ``default_rng(seed)`` draws in
the JAX package's order, so for one seed the port's S is the reference's S.

CountSketch accumulates **deterministically**.  ``index_add_`` with repeated
indices on a CUDA tensor accumulates with atomics, in an order that changes
from run to run, and so would the sketch's low bits and R_s.  Instead the
rows are grouped on the host by their rank within their bucket: round j adds
the j-th row of every bucket at once, each bucket at most once a round.  So
every bucket is summed in row order, one add at a time, whatever the device:
a CUDA run gives the same bits as another CUDA run, and as the CPU run.

Multi-shard reduction: per-shard sketches are QR'd locally and coupled
through the TSQR tree (``core.blocked.ggr_tsqrt``) — a block-diagonal
CountSketch is still a valid embedding.

``lsqr`` is a standalone Golub-Kahan LSQR (Paige & Saunders 1982) as a
Python loop with an optional triangular right preconditioner, terminating on
``||B^T r|| <= tol * ||B|| * ||r||``.  Its stopping test reads one scalar to
the host each iteration (one synchronization per iteration on the card).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.blocked import ggr_tsqrt
from repro_torch.solvers.lstsq import _triangularize_auto, solve_triangular

__all__ = [
    "SketchedLstsq",
    "countsketch",
    "lsqr",
    "sketch_lstsq",
    "sketch_qr",
    "srht",
]


class SketchedLstsq(NamedTuple):
    x: torch.Tensor       # (n,) / (n, k) solution
    resid: torch.Tensor   # () / (k,) LSQR residual-norm estimate ||Ax - b||
    iters: torch.Tensor   # () int32 LSQR iterations actually taken
    arnorm: torch.Tensor  # () final ||B^T r|| — the convergence criterion value
    R: torch.Tensor       # (n, n) sketch preconditioner factor R_s


def _bucket_rounds(h: np.ndarray, s: int):
    """Host plan of the deterministic scatter-add: ``(rows, buckets,
    bounds)`` with round j = ``[bounds[j], bounds[j+1])`` holding the j-th
    row (in row order) of every bucket that has one, each bucket once."""
    order = np.argsort(h, kind="stable")
    hs = h[order]
    counts = np.bincount(h, minlength=s)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(h.size) - starts[hs]
    by = np.argsort(rank, kind="stable")
    bounds = np.searchsorted(rank[by], np.arange(int(counts.max(initial=0)) + 1))
    return order[by], hs[by], bounds


def countsketch(A: torch.Tensor, s: int, seed: int = 0) -> torch.Tensor:
    """CountSketch embedding ``S A``: each row of A lands in one of ``s``
    buckets with a random sign — a single scatter-add pass (O(nnz(A))), the
    cheapest known subspace embedding.  Sketch dim ``s ~ 4n`` gives a
    constant-distortion embedding w.h.p.  Hash/sign streams are host-side
    ``default_rng(seed)``; every bucket is summed in row order (see the
    module docstring), so the sketch's bits do not depend on the run."""
    m = A.shape[0]
    rng = np.random.default_rng(seed)
    h = rng.integers(0, s, size=m)
    g = torch.as_tensor(rng.choice(np.array([-1.0, 1.0]), size=m),
                        dtype=A.dtype, device=A.device)
    X = g[:, None] * A
    rows, buckets, bounds = _bucket_rounds(h, s)
    rows = torch.as_tensor(rows, device=A.device)
    buckets = torch.as_tensor(buckets, device=A.device)
    out = torch.zeros((s,) + A.shape[1:], dtype=A.dtype, device=A.device)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        out.index_add_(0, buckets[lo:hi], X.index_select(0, rows[lo:hi]))
    return out


def _fwht(X: torch.Tensor) -> torch.Tensor:
    """Fast Walsh-Hadamard transform along dim 0 (rows must be a power of
    two): log2(P) rounds of the butterfly, each one reshape + add/sub."""
    P = X.shape[0]
    h = 1
    while h < P:
        Xr = X.reshape(P // (2 * h), 2, h, -1)
        X = torch.cat([Xr[:, 0] + Xr[:, 1], Xr[:, 0] - Xr[:, 1]],
                      dim=1).reshape(X.shape)
        h *= 2
    return X


def srht(A: torch.Tensor, s: int, seed: int = 0) -> torch.Tensor:
    """Subsampled randomized Hadamard transform: ``sqrt(1/s) * Omega H D A``
    (D random signs, H Walsh-Hadamard after zero-padding m to a power of
    two, Omega a uniform row sample of size s).  O(m n log m)."""
    m = A.shape[0]
    P = 1 << max(1, math.ceil(math.log2(m)))
    rng = np.random.default_rng(seed)
    d = torch.as_tensor(rng.choice(np.array([-1.0, 1.0]), size=m),
                        dtype=A.dtype, device=A.device)
    X = torch.zeros((P,) + A.shape[1:], dtype=A.dtype, device=A.device)
    X[:m] = d[:, None] * A
    X = _fwht(X)
    rows = torch.as_tensor(rng.choice(P, size=s, replace=False), device=A.device)
    return X[rows] * (1.0 / math.sqrt(s))


_SKETCHES = {"countsketch": countsketch, "srht": srht}


def sketch_qr(A: torch.Tensor, s: int | None = None, kind: str = "countsketch",
              seed: int = 0, shards: int | None = None) -> torch.Tensor:
    """Preconditioner factor ``R_s`` from a GGR QR of a sketch of A.

    ``s`` defaults to ``min(m, 4 n)``; when ``s >= m`` the "sketch" is A
    itself (exact QR).  ``shards`` splits A into row blocks, sketches and
    QR-factors each independently, and couples the per-shard triangles
    through the TSQR tree (``ggr_tsqrt`` pairs, log-depth).
    """
    if kind not in _SKETCHES:
        raise ValueError(f"unknown sketch kind {kind!r} "
                         f"(one of {sorted(_SKETCHES)})")
    m, n = A.shape
    if s is None:
        s = min(m, 4 * n)
    if s >= m and shards is None:
        return torch.triu(_triangularize_auto(A, n)[:n])
    if shards is None or shards <= 1:
        SA = _SKETCHES[kind](A, s, seed=seed)
        return torch.triu(_triangularize_auto(SA, n)[:n])

    bounds = np.linspace(0, m, shards + 1).astype(int)
    s_loc = max(n, -(-s // shards))
    Rs = []
    for i in range(shards):
        blk = A[bounds[i]:bounds[i + 1]]
        SA = _SKETCHES[kind](blk, s_loc, seed=seed + 1009 * i)
        Rs.append(torch.triu(_triangularize_auto(SA, n)[:n]))
    # TSQR tree coupling: same log-depth reduction the blocked driver uses
    while len(Rs) > 1:
        nxt = [ggr_tsqrt(Rs[i], Rs[i + 1])[0]
               for i in range(0, len(Rs) - 1, 2)]
        if len(Rs) % 2:
            nxt.append(Rs[-1])
        Rs = nxt
    return Rs[0]


def _lsqr_core(A, b, R, iters: int, tol: float):
    """Golub-Kahan LSQR on ``B = A R^{-1}`` (or A itself when R is None).

    Runs until ``k == iters`` or the Paige-Saunders normal-equations test
    ``||B^T r|| <= tol * ||B||_F-est * ||r||`` passes.  Returns the solution
    in y-coordinates plus (iters, rnorm, arnorm); the caller maps back
    ``x = R^{-1} y``.
    """
    f32 = torch.promote_types(A.dtype, torch.float32)
    A = A.to(f32)
    b = b.to(f32)
    At = A.T
    tol = torch.tensor(tol, dtype=f32, device=A.device)

    def Bv(v):
        return A @ (solve_triangular(R, v) if R is not None else v)

    def Btu(u):
        w = At @ u
        return solve_triangular(R, w, trans=True) if R is not None else w

    tiny = torch.finfo(f32).tiny
    beta0 = torch.linalg.norm(b)
    u = b / beta0.clamp(min=tiny)
    av = Btu(u)
    alpha = torch.linalg.norm(av)
    v = av / alpha.clamp(min=tiny)
    y, w = torch.zeros_like(v), v
    phibar, rhobar = beta0, alpha
    anorm2, arnorm = alpha * alpha, alpha * beta0
    k = 0
    while k < iters and bool((arnorm > tol * torch.sqrt(anorm2) * phibar)
                             & (phibar > tiny)):
        # bidiagonalization step
        p = Bv(v) - alpha * u
        beta = torch.linalg.norm(p)
        u = p / beta.clamp(min=tiny)
        q = Btu(u) - beta * v
        alpha_new = torch.linalg.norm(q)
        v = q / alpha_new.clamp(min=tiny)
        # plane rotation of the bidiagonal system
        rho = torch.sqrt(rhobar ** 2 + beta ** 2)
        cs, sn = rhobar / rho, beta / rho
        theta = sn * alpha_new
        rhobar = -cs * alpha_new
        phi = cs * phibar
        phibar = sn * phibar
        y = y + (phi / rho) * w
        w = v - (theta / rho) * w
        anorm2 = anorm2 + alpha_new ** 2 + beta ** 2
        arnorm = phibar * alpha_new * torch.abs(cs)
        alpha = alpha_new
        k += 1
    return y, k, phibar, arnorm


def lsqr(A: torch.Tensor, b: torch.Tensor, R: torch.Tensor | None = None,
         iters: int = 100, tol: float = 1e-10):
    """Standalone (optionally right-preconditioned) LSQR.

    Solves ``min ||A x - b||`` touching A only via matvecs; with a
    triangular ``R`` it iterates on ``A R^{-1}`` and maps back.  Returns
    ``(x, iters_taken, rnorm, arnorm)`` (``iters_taken`` a 0-d int32
    tensor).  ``b`` must be a vector — LSQR is a single-rhs method (loop
    columns for multiple rhs).  Each iteration reads its stopping test to
    the host.
    """
    if b.ndim != 1:
        raise ValueError(f"lsqr takes a single rhs vector, got shape {tuple(b.shape)}")
    Rt = torch.triu(R) if R is not None else None
    y, k, rnorm, arnorm = _lsqr_core(A, b, Rt, iters, tol)
    x = solve_triangular(R, y) if R is not None else y
    return (x.to(A.dtype), torch.tensor(k, dtype=torch.int32, device=A.device),
            rnorm, arnorm)


def sketch_lstsq(A: torch.Tensor, b: torch.Tensor, s: int | None = None,
                 kind: str = "countsketch", iters: int = 50,
                 tol: float = 1e-10, shards: int | None = None,
                 seed: int = 0) -> SketchedLstsq:
    """Sketch-preconditioned least squares for tall-skinny full-rank A.

    One sketch pass + one small QR + <= ``iters`` LSQR iterations whose
    count is cond(A)-independent — the Blendenpik/LSRN trade.
    Rank-*deficient* problems belong to ``lstsq_pivoted`` instead.
    """
    m, n = A.shape
    if m < n:
        raise ValueError(f"sketch_lstsq requires m >= n, got {tuple(A.shape)}")
    R = sketch_qr(A, s=s, kind=kind, seed=seed, shards=shards)
    vec = b.ndim == 1
    B = b[:, None] if vec else b
    xs, ks, rn, an = [], [], [], []
    for j in range(B.shape[1]):
        x, k, rnorm, arnorm = lsqr(A, B[:, j], R, iters=iters, tol=tol)
        xs.append(x)
        ks.append(k)
        rn.append(rnorm)
        an.append(arnorm)
    x = xs[0] if vec else torch.stack(xs, dim=1)
    resid = rn[0] if vec else torch.stack(rn)
    return SketchedLstsq(x=x, resid=resid, iters=torch.stack(ks).max(),
                         arnorm=torch.stack(an).max(), R=R)
