"""Fused trailing update: replay a factored panel's b GGR column transforms
over trailing columns — the fused schedule's DET2 grid (the paper's
``UPDATE``).

For a panel factored by ``ggr_panel.panel_factor`` into compact factors
(V, T), ``apply_factors`` applies its b column steps, in order, to trailing
columns C, with the same pivots ``pivot0 + c``.  Per step: one suffix-dot
scan and one DET2 grid, with the coefficients k, l recomputed from (v, t).
The CUDA kernel runs the b steps as a pipeline of b stages over one
bottom-up pass of each column, so C is read and written once.

On a CUDA tensor it launches the hand-written kernel ``csrc/ggr_apply.cu``;
on a CPU tensor it runs ``apply_factors_plain``, the same function in plain
PyTorch.
"""
from __future__ import annotations

import torch

from . import _cuda
from .backend import count_resolution, resolve_precision, to_tile
from .ggr_panel import _EPS, _accum_dt, _kernel_dtype_check, _launched, _revcumsum

__all__ = ["apply_factors", "apply_factors_plain"]

_TICKS = 32  # mirrors kTicks in ggr_apply.cu: ticks per coefficient tile
_MAX_STAGES = 128  # transforms one launch pipelines: 32 lanes x 4 each
_MAX_WARPS = 16  # warps per block
_WAVE = 264  # blocks in one wave: two on each of the H100's 132 SMs


def apply_factors_plain(V: torch.Tensor, T: torch.Tensor, C: torch.Tensor,
                        pivot0: int = 0,
                        accum_dtype: str | None = None) -> torch.Tensor:
    """Plain-PyTorch replay of a (B, m, b) batch of factors over (B, m, w)
    trailing columns — the kernel's reference.  Rows above each pivot are
    untouched; only the active rows take part in the suffix sums."""
    B, m, b = V.shape
    cd = C.dtype
    ad = _accum_dt(C, accum_dtype)
    C = C.clone()
    for c in range(b):
        p = pivot0 + c
        if p >= m:
            break  # t_pivot = 0: this and every later step is a no-op
        v = V[:, p:, c].to(ad)
        t = T[:, p:, c].to(ad)
        A = C[:, p:]
        P = _revcumsum(v[:, :, None] * A.to(ad), 1)  # inclusive suffix dots
        # exclusive suffix via shift (P - prod would cancel catastrophically)
        S = torch.cat([P[:, 1:], torch.zeros_like(P[:, :1])], 1)
        tn = torch.cat([t[:, 1:], torch.zeros_like(t[:, :1])], 1)
        valid = tn > _EPS
        st = torch.where(t > _EPS, t, 1.0)
        stn = torch.where(valid, tn, 1.0)
        k = v / (st * stn)
        l = stn / st

        t_piv = t[:, 0]
        do_any = t_piv > _EPS
        pivot_new = to_tile(P[:, 0] / torch.where(do_any, t_piv, 1.0)[:, None], cd)
        det2 = k[:, :-1, None] * S[:, :-1] - l[:, :-1, None] * A[:, :-1].to(ad)
        det2 = torch.where(valid[:, :-1, None], to_tile(det2, cd), A[:, 1:])
        out = torch.cat([pivot_new[:, None], det2], 1)
        C[:, p:] = torch.where(do_any[:, None, None], out, A)
    return C


def _pipeline(b: int) -> tuple[int, int]:
    """(lanes, per_lane) for b <= _MAX_STAGES transforms: the lanes of a warp
    that run one column's pipeline (8, 16 or 32, so a warp runs 32 // lanes
    columns) and the transforms each lane holds (1, 2 or 4)."""
    lanes = 8 if b <= 8 else 16 if b <= 16 else 32
    per_lane = 1 if b <= lanes else 2 if b <= 2 * lanes else 4
    return lanes, per_lane


def _apply_factors_cuda(V, T, C, pivot0, accum_dtype, out):
    if C.device.type != "cuda":
        raise ValueError(f"apply_factors: unsupported device {C.device}")
    _kernel_dtype_check(C, accum_dtype, "apply_factors")
    if not V.dtype == T.dtype == C.dtype:
        raise ValueError(f"apply_factors: V {V.dtype}, T {T.dtype} and C {C.dtype} "
                         "must share a dtype on the card")
    B, m, b = V.shape
    w = C.shape[2]
    if out is None:
        out = torch.empty_like(C, memory_format=torch.contiguous_format)
    if B == 0 or m == 0 or w == 0 or b == 0 or pivot0 >= m:
        return out.copy_(C)  # no transform has a pivot row
    V, T = V.contiguous(), T.contiguous()
    src = C if C.stride(2) == 1 else C.contiguous()
    dst = out if out.stride(2) == 1 else torch.empty_like(src)
    # more than _MAX_STAGES transforms: one launch per group, in place after
    # the first
    for g0 in range(0, b, _MAX_STAGES):
        p0 = pivot0 + g0
        if p0 >= m:
            break
        Vg = V[:, :, g0:g0 + _MAX_STAGES].contiguous()  # V itself if b <= 128
        Tg = T[:, :, g0:g0 + _MAX_STAGES].contiguous()
        bg = Vg.shape[2]
        lanes, per_lane = _pipeline(bg)
        ntiles = -(-(m - p0 + 2 * bg - 1) // _TICKS)
        warps = B * -(-w // (32 // lanes))
        nwarps = min(_MAX_WARPS, -(-warps // _WAVE))
        # the (a, c) pairs at the accumulation dtype, from the tile-dtype V and T
        coef = torch.empty((B, ntiles * _TICKS, lanes * per_lane, 2),
                           dtype=_accum_dt(C, accum_dtype), device=C.device)
        _cuda.launch("ggr_apply", "ggr_apply_factors", [Vg, Tg, src, dst, coef],
                     B, m, bg, w, p0, lanes, per_lane, nwarps, ntiles,
                     src.stride(0), src.stride(1), dst.stride(0), dst.stride(1),
                     accum=accum_dtype)
        apply_factors.launches += 1
        apply_factors.shapes.add((tuple(C.shape), (bg, p0), *_launched(C, accum_dtype)))
        src = dst
    if dst is not out:
        out.copy_(dst)
    return out


def _apply_factors_meta(V, T, C, pivot0, accum_dtype, out):
    """The kernel's result as a meta tensor of C's shape and dtype (``out``
    itself when given), nothing computed: the dry run's stand-in for the
    launches (``launch.dryrun``).  It tallies the launches the card would
    make (one per ``_MAX_STAGES`` transforms with a pivot row) and their
    operations (``core.counts.apply_flops``) in any open
    ``core.counts.kernel_tally``, and leaves ``launches`` and ``shapes`` as
    they are."""
    from repro_torch.core import counts

    _kernel_dtype_check(C, accum_dtype, "apply_factors")
    B, m, b = V.shape
    w = C.shape[2]
    if B and m and w and b:
        launches = len([g0 for g0 in range(0, b, _MAX_STAGES) if pivot0 + g0 < m])
        counts.tally_kernel("apply_factors", launches, counts.apply_flops(C.shape, b, pivot0))
    if out is None:
        out = torch.empty_like(C, memory_format=torch.contiguous_format)
    return out


def apply_factors(V: torch.Tensor, T: torch.Tensor, C: torch.Tensor,
                  pivot0: int = 0, block_w: int = 256, precision=None,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Apply the b stored GGR transforms (V, T) ((m, b), or (B, m, b) for a
    batch in one launch) to trailing columns C ((m, w) / (B, m, w)).

    Step c uses pivot row ``pivot0 + c``: rows above it are untouched, and
    k, l are recomputed from (v, t).  Any width and height are accepted.  The
    CUDA kernel streams each column once, so ``block_w`` (kept for parity
    with the JAX signature) sets no tiling; it must be positive.  ``out``
    (optional, C's shape) receives the result and may be C itself — a
    strided view of a larger frame is updated in place.  ``precision``
    selects compute + accumulation dtypes; on CUDA tensors the kernel takes
    the uniform f32 / f64 policies, bf16 / f16 tiles with f32 accumulation
    and f32 / bf16 / f16 tiles with f64 accumulation.  The launch count is
    ``apply_factors.launches``; more than 128 transforms take one launch per
    128.  A meta tensor computes nothing: the result's shape comes back and
    the launches are tallied for the dry run (``_apply_factors_meta``).
    """
    if block_w <= 0:
        raise ValueError(f"block_w must be positive, got {block_w}")
    if pivot0 < 0:
        raise ValueError(f"pivot0 must be non-negative, got {pivot0}")
    if not (V.shape == T.shape and V.ndim == C.ndim and V.ndim in (2, 3)
            and V.shape[:-1] == C.shape[:-1]):
        raise ValueError(f"apply_factors: V {tuple(V.shape)}, T {tuple(T.shape)} "
                         f"and C {tuple(C.shape)} do not match")
    if out is not None and out.shape != C.shape:
        raise ValueError(f"out {tuple(out.shape)} does not match C {tuple(C.shape)}")
    accum = None
    if precision is not None:
        prec = resolve_precision(precision)
        V, T, C = (to_tile(M, prec.compute) for M in (V, T, C))
        accum = prec.accum_dtype
    batched = C.ndim == 3
    if not batched:
        V, T, C = V[None], T[None], C[None]
        out = None if out is None else out[None]
    count_resolution(C)
    if C.device.type == "cpu":
        res = apply_factors_plain(V, T, C, pivot0, accum)
        res = res if out is None else out.copy_(res)
    elif C.device.type == "meta":
        res = _apply_factors_meta(V, T, C, pivot0, accum, out)
    else:
        res = _apply_factors_cuda(V, T, C, pivot0, accum, out)
    return res if batched else res[0]


apply_factors.launches = 0  # kernel launches, for tests and chip_smoke.py
apply_factors.shapes = set()  # (C shape, (b, pivot0), dtype, accum name) of every launch
