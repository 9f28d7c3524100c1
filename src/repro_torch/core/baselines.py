"""Baseline QR routines the paper compares against.

* ``givens_qr``       — classical Givens Rotation (one 2x2 rotation per element,
                        n(n-1)/2 sequences; eq. 4 multiplication count).
* ``cgr_qr``          — Column-wise GR [13]: one *serial scan* per column (n-1
                        sequences), the pre-GGR formulation.
* ``householder_qr2`` — LAPACK ``dgeqr2`` (dgemv-style rank-1 updates).
* ``householder_qrf`` — LAPACK ``dgeqrf`` (blocked compact-WY, dgemm updates).
* ``mht_qr``          — ``dgeqr2ht`` [7]: Modified HT, panel-fused PA = A - V·(T·(VᵀA))
                        without materializing P.
* ``mgs_qr``          — Modified Gram-Schmidt.

Plain PyTorch with the JAX package's arithmetic, on whatever device ``A``
lives; they serve as correctness oracles and yardsticks (the paper's figs. 9
and 13).  The reference's ``fori_loop``s are Python loops here: ``givens_qr``
runs one host step per rotation and ``cgr_qr`` one per active row of each
column, O(n^2) small launches on the card, so keep their shapes small there.
"""
from __future__ import annotations

import torch

__all__ = [
    "givens_qr",
    "cgr_qr",
    "householder_qr2",
    "householder_qrf",
    "mht_qr",
    "mgs_qr",
]


# ---------------------------------------------------------------------------
# classical Givens
# ---------------------------------------------------------------------------
def _rot_coeffs(a: torch.Tensor, b: torch.Tensor):
    """(c, s) of the rotation taking (a, b) to (r, 0); identity when r = 0."""
    r = torch.sqrt(a * a + b * b)
    safe = r > 0
    rr = torch.where(safe, r, 1.0)
    c = torch.where(safe, a / rr, 1.0)
    s = torch.where(safe, b / rr, 0.0)
    return c, s


def _rot_pair(hi: torch.Tensor, lo: torch.Tensor, c_idx: int):
    """Rotate the 2-row pair (hi, lo) to zero lo[c_idx]."""
    c, s = _rot_coeffs(hi[c_idx], lo[c_idx])
    return c * hi + s * lo, -s * hi + c * lo


def givens_qr(A: torch.Tensor) -> torch.Tensor:
    """Classical GR: bottom-up rotations, one per annihilated element."""
    m, n = A.shape
    X = A.clone()
    for c in range(min(m - 1, n)):
        for i in range(m - 1, c, -1):  # rotate rows (i-1, i)
            X[i - 1], X[i] = _rot_pair(X[i - 1], X[i], c)
    return torch.triu(X)


# ---------------------------------------------------------------------------
# CGR — column-wise Givens Rotation [13] as a serial scan per column
# ---------------------------------------------------------------------------
def cgr_qr(A: torch.Tensor) -> torch.Tensor:
    """CGR: per column, a bottom-up serial scan of 2x2 rotations.

    Mathematically matches the GGR closed forms; structurally serial (the
    scan carry is the partially-accumulated row) — this is the formulation
    GGR improves upon by precomputing suffix norms/dots.  Row i of the scan
    rotates (row i, carry) and finalizes row i+1; rows above the pivot take
    no part.
    """
    m, n = A.shape
    X = A.clone()
    for c in range(min(m - 1, n)):
        carry = torch.zeros_like(X[0])
        for i in range(m - 1, c - 1, -1):
            row = X[i]
            cc, ss = _rot_coeffs(row[c], carry[c])
            out_row = -ss * row + cc * carry  # finalized row i+1
            carry = cc * row + ss * carry     # accumulated row (moves up)
            if i + 1 < m:
                X[i + 1] = out_row
        X[c] = carry
    return torch.triu(X)


# ---------------------------------------------------------------------------
# Householder
# ---------------------------------------------------------------------------
def _house_vec(x: torch.Tensor, c: int):
    """Masked Householder vector for column x with pivot c; returns (v, beta)."""
    rows = torch.arange(x.shape[0], device=x.device)
    xa = torch.where(rows >= c, x, 0.0)
    sigma = torch.sum(xa * xa)
    norm = torch.sqrt(sigma)
    alpha = xa[c]
    sign = torch.where(alpha >= 0, 1.0, -1.0).to(x.dtype)
    v = torch.where(rows == c, alpha + sign * norm, xa)
    vtv = torch.sum(v * v)
    safe = vtv > 0
    beta = torch.where(safe, 2.0 / torch.where(safe, vtv, 1.0), 0.0)
    return v, beta


def householder_qr2(A: torch.Tensor, want_factors: bool = False):
    """dgeqr2: unblocked Householder QR (rank-1 dgemv-style updates)."""
    m, n = A.shape
    steps = min(m, n)
    X = A
    V = A.new_zeros((m, steps))
    betas = A.new_zeros((steps,))
    for c in range(steps):
        v, beta = _house_vec(X[:, c], c)
        w = beta * (v @ X)                 # dgemv
        X = X - v[:, None] * w[None, :]    # rank-1 update
        V[:, c] = v
        betas[c] = beta
    if want_factors:
        return torch.triu(X), V, betas
    return torch.triu(X)


def _form_T(V: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """Compact-WY T: Q = I - V T Vᵀ (forward accumulation)."""
    b = V.shape[1]
    T = V.new_zeros((b, b))
    below = torch.arange(b, device=V.device)
    for j in range(b):
        col = -betas[j] * (T @ (V.T @ V[:, j]))
        T[:, j] = torch.where(below < j, col, 0.0)
        T[j, j] = betas[j]
    return T


def householder_qrf(A: torch.Tensor, block: int = 32) -> torch.Tensor:
    """dgeqrf: blocked Householder QR with compact-WY dgemm trailing updates."""
    m, n = A.shape
    steps = min(m, n)
    R = A.clone()
    for k0 in range(0, steps, block):
        b = min(block, steps - k0)
        pr, V, betas = householder_qr2(R[k0:, k0:k0 + b], want_factors=True)
        R[k0:, k0:k0 + b] = pr
        if n - (k0 + b) > 0:
            T = _form_T(V, betas)
            C = R[k0:, k0 + b:]
            R[k0:, k0 + b:] = C - V @ (T.T @ (V.T @ C))  # dgemm chain
    return torch.triu(R)


def mht_qr(A: torch.Tensor, block: int = 32) -> torch.Tensor:
    """dgeqr2ht [7]: Modified HT — panel-local factor, single fused PA update.

    Identical math to dgeqrf but the trailing update is expressed as one fused
    expression PA = A - V·(T·(VᵀA)) over the panel and the trailing matrix
    together (the paper's loop-fusion: no separate P, fewer passes over the
    trailing matrix).
    """
    m, n = A.shape
    steps = min(m, n)
    R = A.clone()
    for k0 in range(0, steps, block):
        b = min(block, steps - k0)
        panelplus = R[k0:, k0:]
        pr, V, betas = householder_qr2(panelplus[:, :b], want_factors=True)
        T = _form_T(V, betas)
        # fused: update panel remainder and trailing matrix in one expression
        W = T.T @ (V.T @ panelplus)
        panelplus = panelplus - V @ W
        panelplus[:, :b] = pr
        R[k0:, k0:] = panelplus
    return torch.triu(R)


# ---------------------------------------------------------------------------
# MGS
# ---------------------------------------------------------------------------
def mgs_qr(A: torch.Tensor):
    """Modified Gram-Schmidt; returns (Q_thin, R)."""
    m, n = A.shape
    Q = A.clone()
    R = A.new_zeros((n, n))
    cols = torch.arange(n, device=A.device)
    for c in range(n):
        a = Q[:, c]
        r = torch.sqrt(torch.sum(a * a))
        safe = r > 0
        q = torch.where(safe, a / torch.where(safe, r, 1.0), a)
        R[c, c] = r
        proj = q @ Q  # (n,)
        mask = cols > c
        R[c, :] = torch.where(mask, proj, R[c, :])
        Q = Q - torch.where(mask, proj, 0.0)[None, :] * q[:, None]
        Q[:, c] = q
    return Q, torch.triu(R)
