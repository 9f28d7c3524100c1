"""Batched row-append update kernel: many small QR updates, one launch.

The streaming-solver workload (RLS / Kalman / sliding-window regression) is
millions of *independent small* updates, not one big factorization.  Per
request the work is a GGR sweep over a stacked ``[R | d; U | Y]`` matrix.
``batched_update`` runs a whole batch of them in one launch:

* per column the sweep exploits the append structure: R is upper triangular,
  so annihilating column c of ``[R; U]`` only rotates pivot row c against the
  p appended rows.  The active set is (p+1) rows, not (n+p) — the fused
  suffix-norm + suffix-dot + DET2 schedule (the paper's merged
  UPDATE_ROW1/UPDATE) runs on that compact block;
* rhs columns (>= n_pivots) ride along through the DET2 grids, so (R, d)
  solver states update in one pass.

On a CUDA tensor it launches the hand-written kernel ``csrc/ggr_update.cu``
(a group of threads per problem, laid out by ``_update_layout`` from the
problem's shape); on a CPU tensor it runs
``batched_update_plain``, the same function in plain PyTorch.

Semantics contract: this is a *different rotation order* than a batched
``core.ggr.ggr_triangularize`` over the stacked matrix, but both produce the
unique non-negative-diagonal triangular factor of the same Gram update, so
they agree to roundoff.

An all-zero problem is a fixed point of the sweep — every divisor is
eps-guarded — and comes back bitwise zero, which is what lets the serving
layer pad chunks with zero problems (``pad_batch``) and slice them off.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda
from .backend import count_resolution, dtype_name, resolve_precision, to_tile
from .ggr_panel import (_EPS, _accum_dt, _check_stack, _kernel_dtype_check, _launched,
                        _revcumsum)

__all__ = ["batched_update", "batched_update_plain", "pad_batch", "pad_to_tile"]


def pad_batch(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad dim 0 of ``x`` up to the next multiple of ``multiple``.

    The padding primitive of the batched-update stack: the serving layer uses
    it to round flushed request groups up to ``block_b``.  Zero problems pass
    through the eps-guarded sweep unchanged, so callers simply slice
    ``out[:B]`` to drop them.
    """
    if multiple <= 0:
        raise ValueError(f"pad multiple must be positive, got {multiple}")
    return pad_to_tile(x, (multiple,), axes=(0,))


def pad_to_tile(x: torch.Tensor, tiles, axes=None) -> torch.Tensor:
    """Zero-pad ``x`` so the given axes become multiples of the given tiles.

    The general-rank sibling of ``pad_batch`` (which pads dim 0 only):
    ``tiles`` is an int or a sequence of ints, ``axes`` the matching axis
    indices (default: the last ``len(tiles)`` axes).  Zero rows/columns are
    exact fixed points of every eps-guarded GGR sweep, so callers simply slice
    the padding back off.
    """
    if isinstance(tiles, int):
        tiles = (tiles,)
    tiles = tuple(int(t) for t in tiles)
    if axes is None:
        axes = tuple(range(x.ndim - len(tiles), x.ndim))
    axes = tuple(int(a) % x.ndim for a in axes)
    if len(axes) != len(tiles):
        raise ValueError(f"{len(tiles)} tiles for {len(axes)} axes")
    if any(t <= 0 for t in tiles):
        raise ValueError(f"pad tiles must be positive, got {tiles}")
    widths = [0] * x.ndim
    for a, t in zip(axes, tiles):
        widths[a] = -(-x.shape[a] // t) * t - x.shape[a]
    if not any(widths):
        return x
    pads = []
    for a in reversed(range(x.ndim)):  # F.pad lists the last dim first
        pads += [0, widths[a]]
    return F.pad(x, pads)


def batched_update_plain(stacked: torch.Tensor, n_pivots: int,
                         accum_dtype: str | None = None) -> torch.Tensor:
    """Plain-PyTorch batched row-append sweep — the kernel's reference."""
    B, m, w = stacked.shape
    cd = stacked.dtype
    ad = _accum_dt(stacked, accum_dtype)
    Xt, Xu = stacked[:, :n_pivots].clone(), stacked[:, n_pivots:]
    for c in range(n_pivots):
        A = torch.cat([Xt[:, c:c + 1], Xu], 1)  # (B, p+1, w): pivot row + appended
        v = A[:, :, c].to(ad)
        sigma = v.abs().amax(1, keepdim=True)  # safe-Givens scale
        v = v / torch.where(sigma > 0, sigma, 1.0)
        t = torch.sqrt(_revcumsum(v * v, 1))

        P = _revcumsum(v[..., None] * A.to(ad), 1)  # inclusive suffix dots
        # exclusive suffix via shift (P - prod cancels catastrophically)
        S = torch.cat([P[:, 1:], torch.zeros_like(P[:, :1])], 1)

        t_next = torch.cat([t[:, 1:], torch.zeros_like(t[:, :1])], 1)
        valid = t_next > _EPS
        safe_t = torch.where(t > _EPS, t, 1.0)
        safe_tn = torch.where(valid, t_next, 1.0)
        k = v / (safe_t * safe_tn)
        l = safe_tn / safe_t

        t_piv = t[:, 0]  # pivot is row 0 of the active block
        do_any = t_piv > _EPS
        pivot_new = to_tile(P[:, 0] / torch.where(do_any, t_piv, 1.0)[:, None], cd)

        det2 = k[:, :-1, None] * S[:, :-1] - l[:, :-1, None] * A[:, :-1].to(ad)
        det2 = torch.where(valid[:, :-1, None], to_tile(det2, cd), A[:, 1:])
        A_new = torch.cat([pivot_new[:, None], det2], 1)
        # annihilated column written exactly: sigma·t at the pivot, 0 below
        A_new[:, 0, c] = to_tile(sigma[:, 0] * t_piv, cd)
        A_new[:, 1:, c] = 0
        A_new = torch.where(do_any[:, None, None], A_new, A)
        Xt[:, c] = A_new[:, 0]
        Xu = A_new[:, 1:]
    return torch.cat([Xt, Xu], 1)


# The thread layout (csrc/ggr_update.cu).  Chosen from a sweep on the card
# (tools/update_sweep.py; PERF.md §6).
_BLOCK_THREADS = 256  # threads of a block that several problems share
_KERNEL_THREADS = 512  # the kernel's launch bound (128 registers a thread)
_NAMED_BARRIERS = 15  # bar.sync ids 1..15: groups of more than one warp a block


def _smem_elems(n: int, ws: int, nbuf: int) -> int:
    """Shared-memory elements of one problem (mirrors group_elems in
    ggr_update.cu): the n active rows' coefficient records (4 each), nbuf
    pivot rows and n - 1 appended rows of stride ws, sigma and t_0 — rounded
    up to a multiple of 4."""
    e = 4 * n + (nbuf + n - 1) * ws + 2
    return -(-e // 4) * 4


def _update_layout(m: int, w: int, n_pivots: int, itemsize: int):
    """(G, PB, ws, nbuf) for a (m, w) problem with ``n_pivots`` pivots: G
    threads per problem, PB problems per block, row stride ws and nbuf pivot
    buffers — from the shape, the dtype and the card's limits only, never
    the batch, so a problem's bits do not depend on its batch.  None when no
    layout fits one block's shared memory.

    A thread a swept column (at most w - 1, whole warps, up to
    _KERNEL_THREADS), each walking whole columns; as many problems a block
    as fill _BLOCK_THREADS.  Two pivot buffers (the next row fetched a step
    ahead) and an odd row stride (a column read free of bank conflicts)
    where they fit, else one buffer, stride w and one warp: the parent
    kernel's footprint."""
    n = m - n_pivots + 1
    G = min(_KERNEL_THREADS, -(-max(1, w - 1) // 32) * 32)
    for G_, ws, nbuf in ((G, w | 1, 2), (G, w, 1), (32, w, 1)):
        elems = _smem_elems(n, ws, nbuf)
        if elems * itemsize <= _cuda.MAX_SMEM_BYTES:
            PB = min(max(1, _BLOCK_THREADS // G_),
                     _cuda.MAX_SMEM_BYTES // (elems * itemsize),
                     32 if G_ == 32 else _NAMED_BARRIERS)
            return G_, PB, ws, nbuf
    return None


def _batched_update_cuda(stacked: torch.Tensor, n_pivots: int,
                         accum_dtype: str | None) -> torch.Tensor:
    if stacked.device.type != "cuda":
        raise ValueError(f"batched_update: unsupported device {stacked.device}")
    _kernel_dtype_check(stacked, accum_dtype, "batched_update")
    B, m, w = stacked.shape
    size = _accum_dt(stacked, accum_dtype).itemsize  # shared memory holds the sums' dtype
    layout = (_update_layout(m, w, n_pivots, size)
              if w <= _cuda.MAX_THREADS else None)
    if layout is None:
        smem = _smem_elems(m - n_pivots + 1, w, 1) * size
        raise ValueError(
            f"batched_update: a ({m}, {w}) {dtype_name(stacked.dtype)} problem "
            f"with {n_pivots} pivots needs {smem} bytes of shared memory and "
            f"{w} threads; the kernel takes at most {_cuda.MAX_SMEM_BYTES} bytes "
            f"and {_cuda.MAX_THREADS} threads")
    out = torch.empty_like(stacked)
    if B == 0:
        return out
    _cuda.launch("ggr_update", "ggr_batched_update", [stacked, out], B, m, w,
                 n_pivots, *layout, accum=accum_dtype)
    batched_update.launches += 1
    batched_update.shapes.add((tuple(stacked.shape), n_pivots,
                               *_launched(stacked, accum_dtype)))
    return out


def batched_update(stacked: torch.Tensor, n_pivots: int, block_b: int = 8,
                   precision=None) -> torch.Tensor:
    """Triangularize the first ``n_pivots`` columns of each stacked problem.

    stacked: (B, n_pivots + p, w) batch of ``[R | d; U | Y]`` matrices, R
    upper triangular (rows n_pivots.. are the appended observation rows);
    the CUDA kernel relies on it and sweeps only the columns right of each
    pivot, as the compact active-set schedule does.  Returns the (B, m, w)
    updated batch; callers slice ``[:, :n, :n]`` (updated R) and
    ``[:, :n, n:]`` (updated rhs).  With no appended rows (``m ==
    n_pivots``) there is nothing to annihilate and the batch comes back as
    it was, without a launch.

    The CUDA kernel runs one group of threads per problem over the whole
    batch, laid out by the problem's shape alone, so ``block_b`` (kept for
    parity with the JAX signature) sets no tiling; it must be positive.
    ``precision`` selects tile compute + in-kernel accumulation dtypes
    (``None`` = the batch at its own dtype with same-width accumulation); on
    CUDA tensors the kernel takes the uniform f32 / f64 policies, bf16 / f16
    tiles with f32 accumulation and f32 / bf16 / f16 tiles with f64
    accumulation.  The launch count is
    ``batched_update.launches``.
    """
    _check_stack(stacked, n_pivots, block_b, "batched_update")
    m = stacked.shape[1]
    if m < n_pivots:
        raise ValueError(f"stacked rows {m} < n_pivots {n_pivots}")
    accum = None
    if precision is not None:
        prec = resolve_precision(precision)
        stacked = to_tile(stacked, prec.compute)
        accum = prec.accum_dtype
    if m == n_pivots:  # no appended rows — nothing to annihilate
        return stacked
    count_resolution(stacked)
    if stacked.device.type == "cpu":
        return batched_update_plain(stacked, n_pivots, accum)
    return _batched_update_cuda(stacked, n_pivots, accum)


batched_update.launches = 0  # kernel launches, for tests and chip_smoke.py
batched_update.shapes = set()  # (shape, n_pivots, dtype, accum name) of every launch
