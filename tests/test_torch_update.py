"""The row-append kernel's protocol (csrc/ggr_update.cu) emulated on the CPU,
and its thread-layout rule.

``_group_update`` follows the kernel's order for one problem: the
coefficient warp's lanes, its shuffle scan and carries, and each column's
bottom-up walk (the layout sets only which thread walks which column, so one
order serves every layout).  It is held against ``batched_update_plain`` at
f64, so the arithmetic the card runs has a check where there is no card.  The kernel itself is held against the plain
version on the card in tests/test_torch_cuda.py."""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels import _cuda, ggr_update
from repro_torch.testing import kernel_check

EPS = 1e-30


def _lane_coeffs(v):
    """The coefficient warp for one active column v (n rows): returns sigma,
    vs, t, k, l in the kernel's order (l = -1 where the rotation is invalid)."""
    n = len(v)
    R = -(-n // 32)
    lanes = [(min(L * R, n), min(min(L * R, n) + R, n)) for L in range(32)]
    sigma = float(np.abs(v).max(initial=0.0))
    vs = v / (sigma if sigma > 0 else 1.0)
    s = np.zeros(32)
    for L, (lo, hi) in enumerate(lanes):
        for i in range(hi - 1, lo - 1, -1):
            s[L] += vs[i] * vs[i]
    inc = s.copy()
    off = 1
    while off < 32:  # Hillis-Steele reverse inclusive scan over the lanes
        inc = np.array([inc[L] + inc[L + off] if L + off < 32 else inc[L]
                        for L in range(32)])
        off *= 2
    t = np.zeros(n)
    for L, (lo, hi) in enumerate(lanes):
        acc = inc[L + 1] if L < 31 else 0.0
        for i in range(hi - 1, lo - 1, -1):
            acc += vs[i] * vs[i]
            t[i] = np.sqrt(acc)
    tn = np.append(t[1:], 0.0)  # t of the next row, from its own lane
    valid = tn > EPS
    st = np.where(t > EPS, t, 1.0)
    stn = np.where(valid, tn, 1.0)
    return sigma, vs, t, vs / (st * stn), np.where(valid, stn / st, -1.0)


def _group_update(X, n_piv):
    """One (m, w) problem through the kernel's protocol: per column step the
    coefficient warp, then each column right of the pivot walked bottom-up
    from its last active row, every read seeing the step's old values (those
    left of the pivot are zero in every active row when R is upper
    triangular, and are not swept)."""
    m, w = X.shape
    n = m - n_piv + 1
    Y = X.copy()
    A = np.concatenate([X[:1], X[n_piv:]])  # active rows; row 0 is the pivot row
    for c in range(n_piv):
        A[0] = Y[c]
        sigma, vs, t, kk, ll = _lane_coeffs(A[:, c].copy())
        t0 = t[0]
        if not t0 > EPS:
            continue  # do_any false: the problem stays as it is
        old = A.copy()
        for j in range(c + 1, w):
            x = old[:, j]
            P = 0.0
            for r in range(n - 1, -1, -1):
                P = vs[r] * x[r] + P
                if r == 0:
                    A[0, j] = P / t0
                else:
                    A[r, j] = (kk[r - 1] * P - ll[r - 1] * x[r - 1]
                               if ll[r - 1] > 0 else x[r])
        A[0, c] = sigma * t0
        A[1:, c] = 0.0
        Y[c] = A[0]
    Y[n_piv:] = A[1:]
    return Y


def _stack(m, w, n_piv, seed):
    X = np.random.default_rng(seed).standard_normal((m, w))
    X[:n_piv, :n_piv] = np.triu(X[:n_piv, :n_piv])
    return X


# (m, w, n_piv): p + 1 = m - n_piv + 1 active rows
CASES = [
    (8, 9, 8),       # p+1 = 1: sign normalization only
    (16, 9, 8),      # p+1 = 9
    (40, 33, 32),    # serving append
    (39, 9, 8),      # p+1 = 32: one row per lane
    (40, 9, 8),      # p+1 = 33: two rows on lane 0
    (40, 12, 8),     # ... twelve columns
    (104, 65, 64),   # serving kalman, p+1 = 41
    (88, 24, 24),    # p+1 = 65
    (128, 192, 64),  # the tree coupling, p+1 = 65
    (136, 72, 8),    # p+1 = 129: past the lanes' registers (4 rows a lane)
    (200, 65, 64),   # p+1 = 137
    (300, 16, 4),    # p+1 = 297, 10 rows a lane
    (72, 41, 40),    # p+1 = 33, every column a pivot but one rhs
    (12, 1, 1),      # n_piv = 1, a one-column problem
]


@pytest.mark.parametrize("m,w,n_piv", CASES)
@pytest.mark.parametrize("case", ["plain", "zero_column", "tiny", "huge"])
def test_group_protocol_matches_plain(m, w, n_piv, case):
    """The lanes' scan and carries and the whole-column walks give the plain
    version's result to 1e-13 relative at f64; a column zero from its step
    on leaves the problem as it is at that step; data x1e-30 and x1e30."""
    X = _stack(m, w, n_piv, m * w)
    if case == "zero_column":  # zero in every row, so in every rotation
        X[:, n_piv // 2] = 0.0
    X *= {"tiny": 1e-30, "huge": 1e30}.get(case, 1.0)
    got = _group_update(X, n_piv)
    want = ggr_update.batched_update_plain(torch.from_numpy(X)[None], n_piv)[0].numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13 * np.abs(want).max())


@pytest.mark.parametrize("m,w,n_piv", [(16, 9, 8), (104, 65, 64), (200, 65, 64),
                                       (40, 12, 8)])
def test_group_protocol_keeps_a_zero_problem_bitwise_zero(m, w, n_piv):
    got = _group_update(np.zeros((m, w)), n_piv)
    assert np.array_equal(got.view(np.int64), np.zeros((m, w), dtype=np.int64))


@pytest.mark.parametrize("below", [False, True])
def test_group_protocol_takes_r_upper_triangular(below):
    """The contract the kernel relies on: R upper triangular.  There it gives
    the plain version's result; an entry below R's diagonal is a different
    input, on which the kernel (sweeping only the columns right of each
    pivot) and the plain version (sweeping every column) part."""
    m, w, n_piv = 16, 9, 8
    X = _stack(m, w, n_piv, 3)
    if below:
        X[5, 2] = 1.0
    got = _group_update(X, n_piv)
    want = ggr_update.batched_update_plain(torch.from_numpy(X)[None], n_piv)[0].numpy()
    close = np.allclose(got, want, rtol=1e-13, atol=1e-13 * np.abs(want).max())
    assert close is not below


@pytest.mark.parametrize("m,w,n_piv,itemsize,layout", [
    (40, 33, 32, 4, (32, 8, 33, 2)),      # serving append: a warp a problem
    (104, 65, 64, 4, (64, 4, 65, 2)),     # serving kalman: two warps
    (128, 192, 64, 4, (192, 1, 193, 2)),  # tree coupling: a thread a column
    (128, 192, 64, 8, (192, 1, 193, 2)),
    (200, 65, 64, 4, (64, 4, 65, 2)),     # a tall active set: as kalman
])
def test_update_layout_choice(m, w, n_piv, itemsize, layout):
    """The layouts the sweep on the card chose (PERF.md §6), each of them
    emulated above."""
    assert ggr_update._update_layout(m, w, n_piv, itemsize) == layout
    assert (m, w, n_piv) in CASES


@pytest.mark.parametrize("m,w,n_piv", [(40, 33, 32), (104, 65, 64), (128, 192, 64),
                                       (12, 1, 1), (200, 65, 64), (12, 9, 8),
                                       (9, 1024, 8), (300, 16, 4), (20, 700, 8)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_update_layout_fits_the_card(m, w, n_piv, itemsize):
    """Whole warps, the kernel's thread bound and one block's shared memory
    a block, a named barrier for each group of more than one warp, and the
    batch takes no part in the choice.  At 4 bytes also a narrow instance's
    layout (bf16 / f16 tiles summed at their own width), its suffix-dot
    scratch (n a thread) in the shared memory."""
    for narrow in (False, True) if itemsize == 4 else (False,):
        G, PB, ws, nbuf = ggr_update._update_layout(m, w, n_piv, itemsize, narrow)
        assert G % 32 == 0 and 32 <= G
        assert G * PB <= ggr_update._KERNEL_THREADS
        assert PB <= (32 if G == 32 else ggr_update._NAMED_BARRIERS)
        assert ws >= w and nbuf in (1, 2)
        n = m - n_piv + 1
        smem = PB * ggr_update._smem_elems(n, ws, nbuf, n * G if narrow else 0) * itemsize
        assert smem <= _cuda.MAX_SMEM_BYTES
    assert list(inspect.signature(ggr_update._update_layout).parameters) == [
        "m", "w", "n_pivots", "itemsize", "narrow"]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("w", [1, 33, 257, 1000, 1024])
def test_update_layout_takes_what_the_parent_took(w, itemsize):
    """Every problem whose active set fit the parent kernel's shared memory
    ((p+1) w + 4 (p+1) + 33 elements) has a layout, up to the tallest."""
    n_piv = min(w, 8)
    n = 1
    while ((n + 1) * w + 4 * (n + 1) + 33) * itemsize <= _cuda.MAX_SMEM_BYTES:
        n += 1
    for rows in (2, n // 2 + 1, n):
        assert ggr_update._update_layout(n_piv + rows - 1, w, n_piv, itemsize)


@pytest.mark.parametrize("row", [0, 63, 64, 127])
def test_one_wrong_row_of_the_tree_coupling_output_fails_the_check(row):
    """chip_smoke.py's rule (max|err| / rms(out) within rel_bound, from
    repro_torch.testing.kernel_check) refuses a (64, 128, 192) f32 output
    with one row of one problem wrong — here that row of another problem —
    and passes the output rounded to f32 from f64."""
    X = np.stack([_stack(128, 192, 64, s) for s in range(64)])
    want = ggr_update.batched_update_plain(torch.from_numpy(X), 64)
    got = want.float()
    bound = kernel_check.rel_bound("batched_update", 128, 192, "float32")

    def rel(o):
        return float((o.double() - want).abs().max() / want.square().mean().sqrt())

    assert rel(got) <= bound
    got[5, row] = got[6, row]
    assert rel(got) > 100 * bound
