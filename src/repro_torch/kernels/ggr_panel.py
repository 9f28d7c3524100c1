"""GGR panel kernels — the fused schedule's panel factorization, the tree
schedule's batched dense GEQRT sweeps — and the helpers shared by the GGR
kernels.

``panel_factor``
    (R, V, T) for one (m, b) panel, or a (B, m, b) batch of them: the
    factored panel plus the compact GGR factors (V the scaled columns, T their
    suffix norms) that ``ggr_apply.apply_factors`` replays over trailing
    columns — the fused schedule's panel step.

``batched_geqrt``
    A (B, t, w) batch of independent tiles, each triangularized in its first
    ``n_pivots`` columns while the remaining ``w - n_pivots`` columns ride
    along through the DET2 grids.  Riding an identity block turns each output
    into the tile's explicit transform Qt — the building block of the blocked
    driver's tree schedule, where trailing updates are plain GEMMs with those
    small Qt tiles.

On a CUDA tensor each launches its hand-written kernel
(``csrc/ggr_panel_factor.cu``, ``csrc/ggr_panel.cu``); on a CPU tensor it
runs ``panel_factor_plain`` / ``batched_geqrt_plain``, the same function in
plain PyTorch.
"""
from __future__ import annotations

import functools

import torch

from . import _cuda
from .backend import count_resolution, dtype_name, resolve_precision, to_tile

__all__ = ["batched_geqrt", "batched_geqrt_plain", "panel_factor",
           "panel_factor_plain"]

# 1e-30 at EVERY dtype, f64 included — the kernels' constant, which differs
# from core.ggr's dtype-keyed table (1e-300 at f64).
_EPS = 1e-30


def _accum_dt(X: torch.Tensor, accum_dtype: str | None) -> torch.dtype:
    """Accumulation dtype for a kernel body: ``accum_dtype`` or X's own.

    ``None`` keeps everything at tile dtype.
    """
    return X.dtype if accum_dtype is None else getattr(torch, accum_dtype)


def _revcumsum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Reverse inclusive cumulative sum along ``dim``.

    A bfloat16 / float16 input is summed as the TPU kernels sum it (the
    reference's ``_revcumsum(native=False)``): the doubling ladder
    ``x[i] += x[i + d]`` for d = 1, 2, 4, ... below the length, zero past
    the end, every step rounded at the input's dtype (torch's elementwise
    add rounds each result).  ``cumsum`` would carry an f32 sum and round
    only its outputs.  Every other dtype is flip-cumsum-flip.
    """
    if x.dtype not in (torch.bfloat16, torch.float16):
        return x.flip(dim).cumsum(dim).flip(dim)
    dim %= x.ndim
    m = x.shape[dim]
    d = 1
    while d < m:
        zeros = x.new_zeros(x.shape[:dim] + (d,) + x.shape[dim + 1:])
        x = x + torch.cat([x.narrow(dim, d, m - d), zeros], dim)
        d *= 2
    return x


def _check_stack(x: torch.Tensor, n_pivots: int, block_b: int, what: str):
    if x.ndim != 3:
        raise ValueError(f"{what} expects a (B, rows, w) batch, got {tuple(x.shape)}")
    if block_b <= 0:
        raise ValueError(f"block_b must be positive, got {block_b}")
    if n_pivots < 0 or n_pivots > x.shape[2]:
        raise ValueError(f"n_pivots {n_pivots} out of range for width {x.shape[2]}")
    if not x.is_contiguous():
        raise ValueError(f"{what} needs a contiguous batch")


# each wrapper's CUDA source
_SOURCE = {"batched_update": "ggr_update", "batched_geqrt": "ggr_panel",
           "panel_factor": "ggr_panel_factor", "apply_factors": "ggr_apply"}


def _kernel_dtype_check(x: torch.Tensor, accum_dtype: str | None, what: str):
    """The (tile, accumulation) pairs of ``what``'s CUDA kernel: in every
    kernel float32 / float64 tiles at their own width, bfloat16 / float16
    tiles with float32 accumulation (the two named mixed policies) and
    float32 / bfloat16 / float16 tiles with float64 accumulation; in
    batched_update and batched_geqrt also bfloat16 / float16 tiles summed at
    their own width.  Any other pair raises ``NotImplementedError`` naming
    both dtypes (``_cuda.suffix``)."""
    try:
        _cuda.suffix(x.dtype, accum_dtype, _SOURCE[what])
    except NotImplementedError as e:
        raise NotImplementedError(f"{what}: {e}") from None


def _compute_size(x: torch.Tensor, accum_dtype: str | None) -> tuple[int, bool]:
    """(bytes a value of shared memory holds, narrow) for B1's and B2's
    kernels at x's tile dtype summed at ``accum_dtype``: the sums' dtype,
    except that a bf16 / f16 tile summed at its own width (narrow) keeps its
    rounded values in float, 4 bytes."""
    size = _accum_dt(x, accum_dtype).itemsize
    return (4, True) if size == 2 else (size, False)


def _launched(x: torch.Tensor, accum_dtype: str | None) -> tuple:
    """The (tile, accumulation) pair of a launch, as its shape record holds
    it: the tile dtype and the accumulation dtype's name."""
    return x.dtype, dtype_name(_accum_dt(x, accum_dtype))


def panel_factor_plain(panel: torch.Tensor, pivot0: int = 0,
                       accum_dtype: str | None = None):
    """Plain-PyTorch fused panel factorization of a (B, m, b) batch — the
    kernel's reference; returns (R, V, T), each (B, m, b).

    Column c is annihilated below pivot row ``pivot0 + c``.  Every column
    runs: a pivot on the last row is only sign-normalized, and a pivot past
    the end (or an all-zero active column) leaves the panel untouched with
    zero factors.  Only the active rows (from the pivot down) take part in the
    suffix sums, which equals the masked full-height form exactly.
    """
    B, m, b = panel.shape
    cd = panel.dtype
    ad = _accum_dt(panel, accum_dtype)
    X = panel.clone()
    V = torch.zeros_like(panel)
    T = torch.zeros_like(panel)
    for c in range(b):
        p = pivot0 + c
        if p >= m:
            continue  # v = 0, t = 0: no transform, zero factors
        A = X[:, p:]  # active rows, (B, n, b)
        v = A[:, :, c].to(ad)
        sigma = v.abs().amax(1, keepdim=True)  # safe-Givens scale
        vs = v / torch.where(sigma > 0, sigma, 1.0)
        ts = torch.sqrt(_revcumsum(vs * vs, 1))

        P = _revcumsum(vs[:, :, None] * A.to(ad), 1)  # inclusive suffix dots
        # exclusive suffix via shift (P - prod cancels catastrophically)
        S = torch.cat([P[:, 1:], torch.zeros_like(P[:, :1])], 1)
        tn = torch.cat([ts[:, 1:], torch.zeros_like(ts[:, :1])], 1)
        valid = tn > _EPS
        st = torch.where(ts > _EPS, ts, 1.0)
        stn = torch.where(valid, tn, 1.0)
        k = vs / (st * stn)
        l = stn / st

        t_piv = ts[:, 0]
        do_any = t_piv > _EPS
        pivot_new = to_tile(P[:, 0] / torch.where(do_any, t_piv, 1.0)[:, None], cd)
        det2 = k[:, :-1, None] * S[:, :-1] - l[:, :-1, None] * A[:, :-1].to(ad)
        det2 = torch.where(valid[:, :-1, None], to_tile(det2, cd), A[:, 1:])
        out = torch.cat([pivot_new[:, None], det2], 1)
        # annihilated column written exactly: sigma·t at the pivot, 0 below
        out[:, 0, c] = to_tile(sigma[:, 0], cd) * to_tile(ts[:, 0], cd)
        out[:, 1:, c] = 0
        X[:, p:] = torch.where(do_any[:, None, None], out, A)

        V[:, p:, c] = to_tile(vs, cd)
        T[:, :p, c] = to_tile(ts[:, :1], cd)  # the suffix sum runs over v's zeros
        T[:, p:, c] = to_tile(ts, cd)
    return X, V, T


def batched_geqrt_plain(tiles: torch.Tensor, n_pivots: int,
                        accum_dtype: str | None = None) -> torch.Tensor:
    """Plain-PyTorch GEQRT sweep of a (B, t, w) batch — the kernel's reference."""
    B, t, w = tiles.shape
    cd = tiles.dtype
    ad = _accum_dt(tiles, accum_dtype)
    rows = torch.arange(t, device=tiles.device)
    X = tiles
    for c in range(min(n_pivots, t)):
        v = torch.where(rows[None, :] >= c, X[:, :, c], 0.0).to(ad)
        sigma = v.abs().amax(1, keepdim=True)  # safe-Givens scale
        vs = v / torch.where(sigma > 0, sigma, 1.0)
        ts = torch.sqrt(_revcumsum(vs * vs, 1))

        P = _revcumsum(vs[:, :, None] * X.to(ad), 1)  # inclusive suffix dots
        # exclusive suffix via shift (P - prod cancels catastrophically)
        S = torch.cat([P[:, 1:], torch.zeros_like(P[:, :1])], 1)

        tn = torch.cat([ts[:, 1:], torch.zeros_like(ts[:, :1])], 1)
        valid = tn > _EPS
        st = torch.where(ts > _EPS, ts, 1.0)
        stn = torch.where(valid, tn, 1.0)
        k = vs / (st * stn)
        l = stn / st

        t_piv = ts[:, c]
        do_any = t_piv > _EPS
        pivot_new = to_tile(P[:, c] / torch.where(do_any, t_piv, 1.0)[:, None], cd)

        det2 = k[:, :-1, None] * S[:, :-1] - l[:, :-1, None] * X[:, :-1].to(ad)
        det2 = torch.where(valid[:, :-1, None], to_tile(det2, cd), X[:, 1:])
        out = torch.cat([X[:, :c], pivot_new[:, None], det2[:, c:]], 1)
        out = torch.where(do_any[:, None, None], out, X)

        # annihilated column written exactly: sigma·t at the pivot, 0 below
        newcol = torch.cat([out[:, :c, c], to_tile(sigma[:, 0] * t_piv, cd)[:, None],
                            torch.zeros_like(out[:, c + 1:, c])], 1)
        out[:, :, c] = torch.where(do_any[:, None], newcol, out[:, :, c])
        X = out
    return X


# The tile kernel's thread layout (csrc/ggr_panel.cu).  Chosen from a sweep on
# the card (tools/geqrt_sweep.py; PERF.md §6).
_GEQRT_THREADS = 512  # the kernel's launch bound


def _geqrt_smem(t: int, ws: int, itemsize: int, scratch: int = 0) -> int:
    """Shared memory of one tile (mirrors tile_elems in ggr_panel.cu): t
    coefficient records (4 elements each), the tile at row stride ws, sigma
    and t_0, then ``scratch`` elements (a narrow instance's suffix dots, t
    a thread)."""
    return (4 * t + t * ws + 2 + scratch) * itemsize


def _geqrt_threads(w: int) -> int:
    """G, the threads of a (t, w) tile's block: one a swept column (at most
    w - 1), whole warps, up to _GEQRT_THREADS."""
    return min(_GEQRT_THREADS, -(-max(1, w - 1) // 32) * 32)


def _geqrt_layout(t: int, w: int, itemsize: int, narrow: bool = False):
    """(G, ws) for a (t, w) tile: G threads a tile (one block), each walking
    whole columns, and the row stride ws in shared memory — from the shape,
    the dtype and the card's limits only, never the batch, so a tile's bits
    do not depend on its batch.  None when the tile does not fit one block's
    shared memory.

    A thread a swept column (at most w - 1, whole warps, up to
    _GEQRT_THREADS; wider tiles give a thread several columns), and an odd
    row stride (a column read free of bank conflicts) where it fits.  A
    ``narrow`` instance (bf16 / f16 tiles summed at their own width) also
    keeps t suffix dots a thread."""
    G = _geqrt_threads(w)
    scratch = t * G if narrow else 0
    for ws in (w | 1, w):
        if _geqrt_smem(t, ws, itemsize, scratch) <= _cuda.MAX_SMEM_BYTES:
            return G, ws
    return None


def _batched_geqrt_cuda(tiles: torch.Tensor, n_pivots: int,
                        accum_dtype: str | None) -> torch.Tensor:
    if tiles.device.type != "cuda":
        raise ValueError(f"batched_geqrt: unsupported device {tiles.device}")
    _kernel_dtype_check(tiles, accum_dtype, "batched_geqrt")
    B, t, w = tiles.shape
    size, narrow = _compute_size(tiles, accum_dtype)  # shared memory holds the sums
    layout = _geqrt_layout(t, w, size, narrow)
    if layout is None:
        scratch = t * _geqrt_threads(w) if narrow else 0
        raise ValueError(
            f"batched_geqrt: a ({t}, {w}) {dtype_name(tiles.dtype)} tile needs "
            f"{_geqrt_smem(t, w, size, scratch)} bytes of shared "
            f"memory; the kernel takes at most {_cuda.MAX_SMEM_BYTES}")
    out = torch.empty_like(tiles)
    if tiles.numel() == 0:
        return out
    _cuda.launch("ggr_panel", "ggr_batched_geqrt", [tiles, out], B, t, w, n_pivots,
                 *layout, accum=accum_dtype)
    batched_geqrt.launches += 1
    batched_geqrt.shapes.add((tuple(tiles.shape), n_pivots,
                              *_launched(tiles, accum_dtype)))
    return out


def batched_geqrt(tiles: torch.Tensor, n_pivots: int, block_b: int = 8,
                  precision=None) -> torch.Tensor:
    """Dense GEQRT sweep of a (B, t, w) tile batch, one fused launch.

    Each tile's first ``n_pivots`` columns are triangularized (pivot row c for
    column c); columns >= ``n_pivots`` ride along through the DET2 grids.
    Riding an identity block yields the explicit tile transform: for
    ``tiles = [T | I]`` the output is ``[R | Qt]`` with ``Qt @ T = R`` and
    ``Qt`` orthogonal.  All-zero tiles are exact fixed points (every divisor
    is eps-guarded), so padding tiles come back bit-identical with ``Qt = I``.

    The CUDA kernel runs one thread block per tile over the whole batch,
    laid out by ``_geqrt_layout`` from the tile's shape, so ``block_b`` (kept
    for parity with the JAX signature) sets no tiling; it must be positive.  ``precision`` selects tile compute dtype + in-kernel
    accumulation dtype (``None`` = tiles at their own dtype, same-width
    accumulation); on CUDA tensors the kernel takes the uniform f32 / f64
    policies, bf16 / f16 tiles with f32 accumulation, f32 / bf16 / f16
    tiles with f64 accumulation and bf16 / f16 tiles summed at their own
    width.  The launch count is ``batched_geqrt.launches``.
    """
    _check_stack(tiles, n_pivots, block_b, "batched_geqrt")
    accum = None
    if precision is not None:
        prec = resolve_precision(precision)
        tiles = to_tile(tiles, prec.compute)
        accum = prec.accum_dtype
    count_resolution(tiles)
    if tiles.device.type == "cpu":
        return batched_geqrt_plain(tiles, n_pivots, accum)
    return _batched_geqrt_cuda(tiles, n_pivots, accum)


batched_geqrt.launches = 0  # kernel launches, for tests and chip_smoke.py
batched_geqrt.shapes = set()  # (shape, n_pivots, dtype, accum name) of every launch


_PANEL_THREADS = 256  # mirrors kThreads in ggr_panel_factor.cu
_SLAB_ROWS = 128  # target slab height: rows of a panel one block holds
# scan / transpose-tile slots and reduction slots (kPart + kReduceSlots)
_PANEL_SLOTS = max(_PANEL_THREADS, 32 * 33) + 32


def _panel_smem(rows: int, b: int, itemsize: int, resident: bool) -> int:
    """Shared memory of one block of the panel kernel whose slabs hold at
    most ``rows`` rows (mirrors smem_bytes in ggr_panel_factor.cu): the slots,
    four per-column values, and when ``resident`` the slab (row stride b + 1)
    with its four vectors of rows + 2."""
    n = _PANEL_SLOTS + 4 * b
    if resident:
        n += 4 * (rows + 2) + rows * (b + 1)
    return n * itemsize


def _panel_blocks(m: int, b: int, itemsize: int, capacity) -> tuple[int, bool]:
    """(nblk, resident): the row slabs one (m, b) panel is split into.

    Slabs of about ``_SLAB_ROWS`` rows, each held in one block's shared
    memory for the whole factorization, and never more slabs than
    ``capacity(smem_bytes)`` blocks (occupancy x SMs at that much shared
    memory per block) can be co-resident: where the target height needs
    more, the slabs grow taller until they are.  A panel that capacity
    blocks cannot hold runs with its slabs in device memory (``resident``
    False).  The batch size takes no part: a panel's result does not depend on the
    batch it is factored in.  One slab (``nblk == 1``) runs as an ordinary
    launch, so it needs no co-residency.
    """
    want = -(-m // _SLAB_ROWS)
    fixed = _panel_smem(0, b, itemsize, True)
    fit = (_cuda.MAX_SMEM_BYTES - fixed) // ((b + 5) * itemsize)  # rows a block holds
    if fit < 1:  # a panel so wide that no row of it fits beside its values
        return min(m, want, capacity(_panel_smem(0, b, itemsize, False))), False
    need = min(m, -(-m // fit))  # the fewest slabs that fit
    nblk = min(m, max(want, need))
    while True:  # fewer, taller slabs until they are co-resident
        cap = capacity(_panel_smem(-(-m // nblk), b, itemsize, True)) if nblk > 1 else 1
        if nblk <= cap:
            return nblk, True
        if nblk == need:
            return min(m, want, capacity(_panel_smem(0, b, itemsize, False))), False
        nblk = max(need, cap)


def _work_elems(m: int, b: int, nblk: int, resident: bool, mixed: bool) -> int:
    """Scratch values of one panel (mirrors work_size in
    ggr_panel_factor.cu): the t and v/sigma planes (b, m), the exchange
    arrays, and with the slabs in device memory their vectors and, for a
    mixed instance, the slabs themselves (R holds the tile dtype)."""
    ws = 2 * b * m + nblk * (2 * b + 4)
    if not resident:
        ws += 4 * nblk * (-(-m // nblk) + 2) + (m * b if mixed else 0)
    return ws


_CAPACITY: dict = {}  # (dtype, accum, device, smem bytes) -> co-resident blocks


def _panel_capacity(x: torch.Tensor, smem: int, accum_dtype: str | None = None) -> int:
    """Blocks of the panel kernel's (x's dtype, ``accum_dtype``) instance
    co-resident on x's card at ``smem`` bytes each, queried from the kernel
    once per (pair, device, smem) and cached."""
    key = (x.dtype, accum_dtype, x.device.index, smem)
    if key not in _CAPACITY:
        _CAPACITY[key] = _cuda.query("ggr_panel_factor", "ggr_panel_factor_capacity",
                                     x, smem, accum=accum_dtype)
    return _CAPACITY[key]


def _panel_factor_cuda(panel: torch.Tensor, pivot0: int,
                       accum_dtype: str | None):
    if panel.device.type != "cuda":
        raise ValueError(f"panel_factor: unsupported device {panel.device}")
    _kernel_dtype_check(panel, accum_dtype, "panel_factor")
    B, m, b = panel.shape
    compute = _accum_dt(panel, accum_dtype)  # the slabs, sums and scratch
    size = compute.itemsize
    if _panel_smem(0, b, size, False) > _cuda.MAX_SMEM_BYTES:
        raise ValueError(f"panel_factor: a panel of width {b} needs more shared "
                         f"memory for its per-column values than a block's "
                         f"{_cuda.MAX_SMEM_BYTES} bytes")
    if m * b >= 2**31:
        raise ValueError(f"panel_factor: a ({m}, {b}) panel has 2^31 elements "
                         "or more; the kernel indexes it with 32-bit offsets")
    panel = panel.contiguous()
    R, V, T = (torch.empty_like(panel) for _ in range(3))
    if panel.numel() == 0:
        V.zero_()
        T.zero_()
        return R.copy_(panel), V, T
    capacity = functools.partial(_panel_capacity, panel, accum_dtype=accum_dtype)
    nblk, resident = _panel_blocks(m, b, size, capacity)
    cap = capacity(_panel_smem(-(-m // nblk), b, size, resident))
    ws = _work_elems(m, b, nblk, resident, compute != panel.dtype)
    if ws >= 2**31:
        raise ValueError(f"panel_factor: a ({m}, {b}) panel needs {ws} values of "
                         "scratch; the kernel indexes it with 32-bit offsets")
    work = torch.empty((B, ws), dtype=compute, device=panel.device)
    _cuda.launch("ggr_panel_factor", "ggr_panel_factor", [panel, R, V, T, work],
                 B, m, b, pivot0, nblk, int(resident), ws, cap, accum=accum_dtype)
    panel_factor.launches += 1
    panel_factor.shapes.add((tuple(panel.shape), pivot0, *_launched(panel, accum_dtype)))
    return R, V, T


def _panel_factor_meta(panel: torch.Tensor, pivot0: int, accum_dtype: str | None):
    """The kernel's (R, V, T) as meta tensors of their shapes and dtypes,
    nothing computed: the dry run's stand-in for a launch
    (``launch.dryrun``).  It tallies the launch the card would make and its
    operations (``core.counts.panel_flops``) in any open
    ``core.counts.kernel_tally``, and leaves ``launches`` and ``shapes`` as
    they are."""
    from repro_torch.core import counts

    _kernel_dtype_check(panel, accum_dtype, "panel_factor")
    if panel.numel():
        counts.tally_kernel("panel_factor", 1, counts.panel_flops(panel.shape, pivot0))
    return tuple(torch.empty_like(panel, memory_format=torch.contiguous_format)
                 for _ in range(3))


def panel_factor(panel: torch.Tensor, pivot0: int = 0, precision=None):
    """Fused GGR factorization of an (m, b) panel, or a (B, m, b) batch;
    returns (R, V, T) of the panel's shape.

    Column c is annihilated below pivot row ``pivot0 + c``; ``V[:, c]`` is
    the column scaled by its max-abs (zero above the pivot) and ``T[:, c]``
    its suffix norms (``t_pivot`` above the pivot) — the compact factors
    ``ggr_apply.apply_factors`` replays.  All b columns run, so a pivot on the
    last row is sign-normalized and one past the end is a no-op.  An all-zero
    panel comes back bitwise as it was.

    ``precision`` selects the panel's compute dtype and the in-kernel
    accumulation dtype (``None`` = the panel's own dtype throughout); on CUDA
    tensors the kernel takes the uniform f32 / f64 policies, bf16 / f16
    panels with f32 accumulation and f32 / bf16 / f16 panels with f64
    accumulation (laid out as an f64 panel of the same shape).  The CUDA kernel
    splits each panel by rows over co-resident blocks (``_panel_blocks``); a
    large batch may take several launches, and a call counts once in
    ``panel_factor.launches``.  A meta tensor computes nothing: the outputs'
    shapes come back and the call is tallied for the dry run
    (``_panel_factor_meta``).
    """
    if panel.ndim not in (2, 3):
        raise ValueError(f"panel_factor expects (m, b) or (B, m, b), got "
                         f"{tuple(panel.shape)}")
    if pivot0 < 0:
        raise ValueError(f"pivot0 must be non-negative, got {pivot0}")
    accum = None
    if precision is not None:
        prec = resolve_precision(precision)
        panel = to_tile(panel, prec.compute)
        accum = prec.accum_dtype
    batched = panel.ndim == 3
    x = panel if batched else panel[None]
    count_resolution(x)
    if x.device.type == "cpu":
        out = panel_factor_plain(x, pivot0, accum)
    elif x.device.type == "meta":
        out = _panel_factor_meta(x, pivot0, accum)
    else:
        out = _panel_factor_cuda(x, pivot0, accum)
    return out if batched else tuple(o[0] for o in out)


panel_factor.launches = 0  # kernel launches, for tests and chip_smoke.py
panel_factor.shapes = set()  # (shape, pivot0, dtype, accum name) of every launch
