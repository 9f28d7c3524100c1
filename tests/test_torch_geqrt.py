"""The tile GEQRT kernel's protocol (csrc/ggr_panel.cu) emulated on the CPU,
and its thread-layout rule.

``_tile_geqrt`` follows the kernel's order for one tile: per column step the
coefficient warp (its lanes, shuffle scan and carries; ggr_warp.cuh
coeff_chain), then each column right of the pivot walked bottom-up
(column_walk), with a fused multiply-add where the kernel's compiler
contracts one.  The layout sets only which thread walks which column, so one
order serves every layout the rule picks.  At f64 it is held against
``batched_geqrt_plain`` and the JAX kernel; at f32 against the f64 result.
The kernel itself is held against the plain version on the card in
tests/test_torch_cuda.py."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ggr_panel import batched_geqrt_pallas
from repro_torch.kernels import _cuda, ggr_panel

EPS = 1e-30


def _fma(a, b, c):
    """a * b + c rounded once, at the dtype of the operands: exact for f32
    (the product is exact in f64, and the sum is rounded twice only in rare
    halfway cases); at f64 the product is rounded too (no wider type here),
    which the f64 tolerances absorb."""
    if np.result_type(a, b, c) == np.float32:
        return np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    return a * b + c


def _lane_coeffs(v):
    """The coefficient warp for one active column v (n rows, n >= 1): None
    for a zero column (the step is skipped), else sigma, vs, t, k, l in the
    kernel's order (l = -1 where the rotation is invalid)."""
    dt = v.dtype.type
    n = len(v)
    sigma = np.abs(v).max()
    if sigma == 0:
        return None
    R = -(-n // 32)
    lanes = [(min(L * R, n), min(min(L * R, n) + R, n)) for L in range(32)]
    vs = v / sigma
    s = np.zeros(32, v.dtype)
    for L, (lo, hi) in enumerate(lanes):  # each lane's sum of squares, bottom-up
        for i in range(hi - 1, lo - 1, -1):
            s[L] = _fma(vs[i], vs[i], s[L])
    off = 1
    while off < 32:  # Hillis-Steele reverse inclusive scan over the lanes
        s = np.array([s[L] + s[L + off] if L + off < 32 else s[L] for L in range(32)],
                     v.dtype)
        off *= 2
    t = np.zeros(n, v.dtype)
    for L, (lo, hi) in enumerate(lanes):
        acc = s[L + 1] if L < 31 else dt(0)  # the carry: every lane below
        for i in range(hi - 1, lo - 1, -1):
            acc = _fma(vs[i], vs[i], acc)
            t[i] = np.sqrt(acc)
    tn = np.append(t[1:], dt(0))  # t of the next row, from its own lane
    valid = tn > EPS
    st = np.where(t > EPS, t, dt(1))
    stn = np.where(valid, tn, dt(1))
    return sigma, vs, t, vs / (st * stn), np.where(valid, stn / st, dt(-1))


def _tile_geqrt(X, n_piv):
    """One (t, w) tile through the kernel's protocol, at X's dtype: per
    column step the coefficient warp (a zero column skips the step), then
    every column right of the pivot walked bottom-up from its last row, every
    read seeing the step's old values; the pivot row keeps its values left of
    the pivot, the column is written sigma * t_0 at the pivot and zeros
    below.  The walks of the columns are independent, so they run side by
    side here."""
    t, w = X.shape
    Y = X.copy()
    for c in range(min(n_piv, t)):
        n = t - c
        coeffs = _lane_coeffs(Y[c:, c].copy())
        if coeffs is None or not coeffs[2][0] > EPS:
            continue  # do_any false: the tile stays as it is
        sigma, vs, ts, kk, ll = coeffs
        old = Y[c:, c + 1:].copy()
        P = np.zeros(w - c - 1, X.dtype)
        for r in range(n - 1, 0, -1):
            P = _fma(vs[r], old[r], P)
            if ll[r - 1] > 0:
                Y[c + r, c + 1:] = _fma(kk[r - 1], P, -(ll[r - 1] * old[r - 1]))
            else:
                Y[c + r, c + 1:] = old[r]
        P = _fma(vs[0], old[0], P)
        Y[c, c + 1:] = P / ts[0]
        Y[c, c] = sigma * ts[0]
        Y[c + 1:, c] = 0
    return Y


def _plain(X, n_piv):
    return ggr_panel.batched_geqrt_plain(torch.from_numpy(X)[None], n_piv)[0].numpy()


@pytest.mark.parametrize("t", [1, 2, 31, 33, 64, 65, 128])
@pytest.mark.parametrize("dw", [0, 1, "t", "t+1"])
@pytest.mark.parametrize("case", ["plain", "zero_column", "tiny", "huge"])
def test_tile_protocol_matches_plain(t, dw, case):
    """Widths from t to 2t + 1, every column a pivot while there are rows;
    the lanes' scan and carries, the walks and the skipped steps give the
    plain version's result to 1e-13 relative at f64; a column zero in every
    row skips its step; data x1e-30 and x1e30."""
    w = t + {"t": t, "t+1": t + 1}.get(dw, dw)
    X = np.random.default_rng(t * w).standard_normal((t, w))
    if case == "zero_column":
        X[:, w // 2] = 0.0
    X *= {"tiny": 1e-30, "huge": 1e30}.get(case, 1.0)
    got = _tile_geqrt(X, w)
    want = _plain(X, w)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13 * np.abs(want).max())


@pytest.mark.parametrize("t,w,n_piv", [(8, 16, 8), (12, 30, 16), (20, 24, 16)])
def test_tile_protocol_matches_the_jax_kernel(t, w, n_piv):
    """The same tiles through the JAX Pallas kernel (interpret mode): n_piv
    past the rows (16 of 12) stops at the last row."""
    X = np.random.default_rng(t + w).standard_normal((2, t, w))
    X[1, :, : t // 2] = 0.0  # zero pivot columns: skipped steps
    want = np.asarray(batched_geqrt_pallas(jnp.asarray(X), n_piv, interpret=True))
    for i in range(2):
        np.testing.assert_allclose(_tile_geqrt(X[i], n_piv), want[i], rtol=1e-12,
                                   atol=1e-12 * np.abs(want[i]).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["zero", "0|I", "zero_half"])
def test_tile_protocol_keeps_zero_columns_bitwise(dtype, kind):
    """The tree schedule pads with [0 | I] tiles: every pivot column is zero,
    so every step is skipped and the tile comes back bitwise as it was; so
    does an all-zero tile, and a tile whose panel is zero from row 8 down
    keeps those rows bitwise once the first 8 steps are done."""
    b = 16
    X = np.concatenate([np.zeros((b, b)), np.eye(b)], 1).astype(dtype)
    if kind == "zero":
        X[:] = 0
    got = _tile_geqrt(X, b)
    if kind == "zero_half":
        X[:8, :b] = np.random.default_rng(8).standard_normal((8, b))
        got = _tile_geqrt(X, b)
        assert np.array_equal(got[8:], X[8:])
        return
    assert np.array_equal(got.view(np.uint8), X.view(np.uint8))


def _near_dependent_tile(seed, delta):
    """A (64, 128) f32 tile whose column 62 lies within ``delta`` of the span
    of columns 0..61: the rotation of the last two rows at step 62 is set by
    a 2-vector of length about ``delta``, so its angle carries the rounding
    of the 62 steps before it, amplified by 1 / delta."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((64, 128))
    X[:, 62] = X[:, :62] @ rng.standard_normal(62) / np.sqrt(62) \
        + delta * rng.standard_normal(64)
    return X.astype(np.float32)


def _rel(got, want):
    return np.abs(got - want).max() / np.sqrt((want ** 2).mean())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f32_error_on_a_near_dependent_tile_is_its_conditioning(seed):
    """What made one random draw read 1.8e-3 from f64 (PERF.md §6): a tile
    whose first 63 columns are nearly dependent.  On such a tile the f64
    answer itself moves by more than 1e-4 of its rms when the input moves by
    f32's rounding (2^-24 relative), and every f32 order (the kernel's, the
    plain version's) lands within 30x that movement (the rounding of 62
    steps, not one), far above what either reads on a well-conditioned tile
    (below 1e-4)."""
    X = _near_dependent_tile(seed, 3e-4)
    want = _plain(X.astype(np.float64), 64)
    rng = np.random.default_rng(100 + seed)
    moved = max(_rel(_plain(X * (1 + 2.0 ** -24 * rng.standard_normal(X.shape)), 64),
                     want) for _ in range(3))
    assert moved > 1e-4
    assert _rel(_tile_geqrt(X, 64), want) <= 30 * moved
    assert _rel(_plain(X, 64), want) <= 30 * moved
    well = _near_dependent_tile(seed, 1.0)
    assert _rel(_tile_geqrt(well, 64), _plain(well.astype(np.float64), 64)) <= 1e-4


def test_f32_error_on_random_tiles_is_the_plain_versions():
    """Over 12 random (64, 128) f32 tiles the kernel's order lands as far
    from the f64 result as the plain version does: its worst within 2x the
    plain version's worst.  (One tile alone may read 2x either way: each
    order rounds differently.)"""
    kernel, plain = [], []
    for seed in range(12):
        X = np.random.default_rng(seed).standard_normal((64, 128)).astype(np.float32)
        want = _plain(X.astype(np.float64), 64)
        kernel.append(_rel(_tile_geqrt(X, 64), want))
        plain.append(_rel(_plain(X, 64), want))
    assert max(kernel) <= 2 * max(plain)


@pytest.mark.parametrize("t,w,itemsize,layout", [
    (64, 128, 4, (128, 129)),  # the tree's level-0 tiles: a thread a column
    (64, 128, 8, (128, 129)),
    (8, 16, 4, (32, 17)),
    (128, 257, 4, (256, 257)),
    (32, 1000, 4, (512, 1001)),  # a thread two columns
    (200, 286, 4, (288, 286)),  # no room for the odd stride
])
def test_geqrt_layout_choice(t, w, itemsize, layout):
    """The layouts the sweep on the card chose (PERF.md §6)."""
    assert ggr_panel._geqrt_layout(t, w, itemsize) == layout


@pytest.mark.parametrize("t,w", [(64, 128), (1, 1), (8, 16), (128, 257), (64, 1000),
                                 (1000, 50), (3000, 3), (200, 286), (20, 1024)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_geqrt_layout_fits_the_card(t, w, itemsize):
    """Whole warps, the kernel's thread bound and one block's shared memory,
    from the shape and the dtype alone: the batch takes no part."""
    layout = ggr_panel._geqrt_layout(t, w, itemsize)
    if layout is None:  # only a tile too large for shared memory has none
        assert ggr_panel._geqrt_smem(t, w, itemsize) > _cuda.MAX_SMEM_BYTES
        return
    G, ws = layout
    assert G % 32 == 0 and 32 <= G <= ggr_panel._GEQRT_THREADS and ws >= w
    assert ggr_panel._geqrt_smem(t, ws, itemsize) <= _cuda.MAX_SMEM_BYTES
    assert list(inspect.signature(ggr_panel._geqrt_layout).parameters) == [
        "t", "w", "itemsize"]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("w", [1, 2, 33, 128, 257, 1000, 1024])
def test_geqrt_layout_takes_what_the_parent_took(w, itemsize):
    """Every tile the parent kernel took (w <= 1024 threads, t w + 4 t + 33
    elements of shared memory) has a layout, up to the tallest."""
    t = 1
    while ((t + 1) * w + 4 * (t + 1) + 33) * itemsize <= _cuda.MAX_SMEM_BYTES:
        t += 1
    for rows in (1, t // 2 + 1, t):
        assert ggr_panel._geqrt_layout(rows, w, itemsize)
