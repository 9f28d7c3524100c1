"""Port parity for the fused schedule: the plain versions of the panel and
apply kernels against the JAX Pallas kernels in interpret mode, the fused
drivers (``tsqrt``, ``ggr_qr_pallas``, ``ggr_triangularize_blocked(schedule=
"fused")``) against their JAX counterparts, and the explicit-Q tile
primitives and ``kernels.ref`` oracles against the JAX package — same numpy
inputs made from a seed.  The CUDA kernels are held against the plain
versions in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocked as jblocked
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import blocked
from repro_torch.kernels import apply_panel, ggr_qr_pallas, panel_qr, ref, tsqrt
from repro_torch.kernels import ggr_apply, ggr_panel
from repro_torch.kernels.backend import degraded_mode

# the JAX kernel tests' shapes and tolerances (tests/test_kernels.py),
# scaled by max(1, m // 16)
SHAPES = [(8, 4), (32, 8), (64, 16), (128, 32), (96, 8)]
DTYPES = [np.float32, np.float64]
TOL = {np.float32: 5e-5, np.float64: 1e-11}


def _rand(shape, seed, dtype):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(out, ref_, tol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref_), atol=tol, rtol=tol)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ panel kernel
@pytest.mark.parametrize("pivot0", [0, 4, 13])
@pytest.mark.parametrize("m,b", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_panel_factor_plain_matches_jax_kernel(m, b, dtype, pivot0):
    pan = _rand((m, b), m + b + pivot0, dtype)
    want = jops.panel_qr(jnp.asarray(pan), pivot0=pivot0, interpret=True)
    got = panel_qr(_t(pan), pivot0=pivot0)
    tol = TOL[dtype] * max(1, m // 16)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(pan).dtype
        _close(g.numpy(), w, tol)


def test_panel_factor_zero_column_and_pivots_past_the_end():
    """A zero column leaves the panel as it is at that step; a pivot on the
    last row is sign-normalized and one past the end is a no-op."""
    pan = _rand((32, 8), 9, np.float32)
    pan[:, 3] = 0.0
    for pivot0 in (0, 28):  # 28: pivots 28..35 of 32 rows
        want = jops.panel_qr(jnp.asarray(pan), pivot0=pivot0, interpret=True)
        got = panel_qr(_t(pan), pivot0=pivot0)
        assert all(bool(g.isfinite().all()) for g in got)
        for g, w in zip(got, want):
            _close(g.numpy(), w, 1e-4)
    R, V, T = panel_qr(torch.zeros((16, 4), dtype=torch.float64))
    assert not R.any() and not V.any() and not T.any()


def test_panel_factor_batch_equals_per_panel_loop():
    pans = _t(_rand((3, 40, 8), 10, np.float64))
    R, V, T = ggr_panel.panel_factor(pans, pivot0=5)
    for i in range(3):
        for a, b in zip((R[i], V[i], T[i]), ggr_panel.panel_factor(pans[i], pivot0=5)):
            assert torch.equal(a, b)


def _slab_factor(pan, pivot0, nblk):
    """Emulation of the CUDA kernel's decomposition (csrc/ggr_panel_factor.cu)
    for one (m, b) panel: nblk row slabs, each factored on its own, which per
    column exchange only (A) the max-abs of their active rows, (B) the sum of
    squares of their scaled active rows, and (C) their partial suffix dots
    over the columns right of c, their old bottom row and its k and l (the
    halo of the slab below).  t_p is reduced from the B partials in one fixed
    order, the same in every slab, and the owner of the pivot row uses it."""
    m, b = pan.shape
    eps = 1e-30
    bounds = [(k * m // nblk, (k + 1) * m // nblk) for k in range(nblk)]
    X = [pan[lo:hi].copy() for lo, hi in bounds]
    V, T = np.zeros_like(pan), np.zeros_like(pan)
    sig, tps = np.zeros(b), np.zeros(b)
    for c in range(b):
        p = pivot0 + c
        if p >= m:
            break
        a0 = [max(p, lo) for lo, _ in bounds]
        act = [X[k][a0[k] - lo:] for k, (lo, _) in enumerate(bounds)]  # views
        # A. sigma
        sigma = max(float(np.abs(a[:, c]).max(initial=0.0)) for a in act)
        scale = sigma if sigma > 0 else 1.0
        # B. suffix norms from the slabs' partial sums of squares
        vs = [a[:, c] / scale for a in act]
        exB = [float(np.sum(v * v)) for v in vs]
        tp = np.sqrt(sum(exB))  # one fixed order for every slab
        ts, t_hi = [], []
        for k, v in enumerate(vs):
            below = sum(exB[k + 1:])
            t = np.sqrt(below + np.cumsum((v * v)[::-1])[::-1])
            if bounds[k][0] <= p < bounds[k][1]:
                t[p - a0[k]] = tp
            ts.append(t)
            t_hi.append(np.sqrt(below))
            V[a0[k]:bounds[k][1], c] = v
            T[a0[k]:bounds[k][1], c] = t
        T[:p, c] = tp
        sig[c], tps[c] = sigma, tp
        if not tp > eps:
            continue  # every slab agrees: the panel stays as it is
        # C. coefficients, partial dots, bottom rows and their k, l
        kl = []
        for k, t in enumerate(ts):
            tn = np.append(t[1:], t_hi[k])
            valid = tn > eps
            st = np.where(t > eps, t, 1.0)
            stn = np.where(valid, tn, 1.0)
            kl.append((vs[k] / (st * stn), np.where(valid, stn / st, -1.0)))
        dots = [vs[k] @ a[:, c + 1:] for k, a in enumerate(act)]
        bottom = [(X[k][-1, c + 1:].copy(), kl[k][0][-1] if len(vs[k]) else 0.0,
                   kl[k][1][-1] if len(vs[k]) else 0.0) for k in range(nblk)]
        for k, a in enumerate(act):
            n = len(vs[k])
            if not n:
                continue
            old = a[:, c + 1:].copy()
            P = sum(dots[k + 1:], np.zeros(b - c - 1))
            for i in range(n - 1, -1, -1):  # bottom-up from the carry
                P = vs[k][i] * old[i] + P
                r = a0[k] + i
                if r == p:
                    a[i, c + 1:] = P / tp
                    break
                if i:
                    x_up, k_up, l_up = old[i - 1], kl[k][0][i - 1], kl[k][1][i - 1]
                else:  # the halo: slab k-1's old bottom row, k and l
                    x_up, k_up, l_up = bottom[k - 1]
                a[i, c + 1:] = k_up * P - l_up * x_up if l_up > 0 else old[i]
    R = np.concatenate(X)
    for c in range(b):
        p = pivot0 + c
        if p < m and tps[c] > eps:
            R[p, c] = sig[c] * tps[c]
            R[p + 1:, c] = 0
    return R, V, T


@pytest.mark.parametrize("m,b,pivot0,nblk,case", [
    (64, 8, 0, 1, "plain"), (64, 8, 0, 3, "plain"), (64, 8, 0, 64, "plain"),
    (33, 8, 0, 33, "plain"),        # one row per slab
    (50, 8, 20, 3, "plain"),        # pivots in the second slab
    (97, 16, 30, 7, "plain"),       # uneven slabs, pivots crossing their edges
    (40, 8, 36, 5, "plain"),        # pivots on the last row and past the end
    (64, 8, 4, 3, "zero_column"),   # column 5 is zero from its step on
    (64, 8, 5, 3, "tiny"), (64, 8, 5, 3, "huge"),  # data scaled by 1e-30, 1e30
])
def test_slab_protocol_matches_plain(m, b, pivot0, nblk, case):
    """The kernel's row split, its three exchanges per column and the halo
    give the plain version's R, V and T to 1e-13 relative at f64."""
    pan = _rand((m, b), m * b + nblk, np.float64)
    if case == "zero_column":
        pan[pivot0:, 5] = 0.0
    pan *= {"tiny": 1e-30, "huge": 1e30}.get(case, 1.0)
    got = _slab_factor(pan, pivot0, nblk)
    want = ggr_panel.panel_factor_plain(_t(pan)[None], pivot0)
    for g, w in zip(got, want):
        w = w[0].numpy()
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, w, rtol=1e-13, atol=1e-13 * np.abs(w).max())


@pytest.mark.parametrize("nblk", [1, 3, 33])
def test_slab_protocol_keeps_a_zero_panel_bitwise_zero(nblk):
    pan = np.zeros((33, 8))
    for out in _slab_factor(pan, 2, nblk):
        assert np.array_equal(out.view(np.int64), np.zeros((33, 8), dtype=np.int64))


def _h100_capacity(per_sm=2048 // ggr_panel._PANEL_THREADS):
    """Co-resident blocks on 132 SMs of 228 KB shared memory (1 KB reserved
    per block), at most ``per_sm`` blocks each (threads or registers): the
    card's occupancy rule, for CPU tests."""
    return lambda smem: 132 * min(per_sm, 233472 // (smem + 1024))


@pytest.mark.parametrize("m,b,itemsize,per_sm,nblk,resident", [
    (40, 8, 8, 8, 1, True), (128, 64, 4, 8, 1, True),  # small frames: one block
    (256, 64, 4, 8, 2, True),
    (4096, 64, 4, 8, 32, True), (8192, 64, 4, 8, 64, True), (4096, 64, 8, 8, 32, True),
    (4097, 64, 4, 8, 33, True),
    (65536, 64, 4, 8, 512, True),
    (65536, 64, 4, 2, 264, True),     # two blocks an SM: fewer, taller slabs
    (65536, 64, 8, 8, 512, False),    # 32 MiB: slabs in device memory
    (600, 300, 4, 2, 5, True),        # wider than a block's 256 threads
    (64, 6000, 8, 2, 1, False),       # no row fits beside the column values
])
def test_panel_blocks_choice(m, b, itemsize, per_sm, nblk, resident):
    cap = _h100_capacity(per_sm)
    assert ggr_panel._panel_blocks(m, b, itemsize, cap) == (nblk, resident)


@pytest.mark.parametrize("m", [1, 7, 300, 4096, 5000, 20000, 40000, 65536, 200000])
@pytest.mark.parametrize("b,itemsize", [(8, 4), (64, 4), (64, 8), (256, 8),
                                        (1024, 8), (6000, 8)])
@pytest.mark.parametrize("per_sm", [2, 8])
def test_panel_blocks_fit_the_card(m, b, itemsize, per_sm):
    """Every slab fits a block's shared memory or the device-memory case is
    chosen; nblk never exceeds the rows or the co-resident capacity; the
    batch takes no part in the choice."""
    import inspect

    cap = _h100_capacity(per_sm)
    nblk, resident = ggr_panel._panel_blocks(m, b, itemsize, cap)
    assert 1 <= nblk <= m
    smem = ggr_panel._panel_smem(-(-m // nblk), b, itemsize, resident)
    assert smem <= ggr_panel._cuda.MAX_SMEM_BYTES
    assert nblk == 1 or nblk <= cap(smem)
    if not resident:  # too tall for capacity blocks, even at the tallest slabs
        fit = next((r for r in range(m, 0, -1)
                    if ggr_panel._panel_smem(r, b, itemsize, True)
                    <= ggr_panel._cuda.MAX_SMEM_BYTES), None)
        if fit is not None:  # else too wide for one row beside its values
            need = -(-m // fit)
            assert need > cap(ggr_panel._panel_smem(-(-m // need), b, itemsize, True))
    assert list(inspect.signature(ggr_panel._panel_blocks).parameters) == [
        "m", "b", "itemsize", "capacity"]


# ------------------------------------------------------------ apply kernel
@pytest.mark.parametrize("m,b", [(16, 4), (64, 8), (128, 16)])
@pytest.mark.parametrize("w", [8, 32, 64, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_factors_plain_matches_jax_kernel(m, b, w, dtype):
    """w = 40 is not a multiple of block_w = 32: the JAX kernel needs a
    dividing block (8), the port masks."""
    pan = _rand((m, b), 5, dtype)
    C = _rand((m, w), 6, dtype)
    _, V, T = jref.ref_panel_factor(jnp.asarray(pan))
    jbw = min(32, w) if w % min(32, w) == 0 else 8
    want = jops.apply_panel(V, T, jnp.asarray(C), block_w=jbw, interpret=True)
    got = apply_panel(_t(np.asarray(V)), _t(np.asarray(T)), _t(C), block_w=32)
    _close(got.numpy(), want, TOL[dtype] * max(1, m // 16))


@pytest.mark.parametrize("pivot0", [4, 13])
def test_apply_factors_pivot_offsets_match_jax(pivot0):
    pan = _rand((48, 8), 7, np.float64)
    C = _rand((48, 12), 8, np.float64)
    _, V, T = jops.panel_qr(jnp.asarray(pan), pivot0=pivot0, interpret=True)
    want = jops.apply_panel(V, T, jnp.asarray(C), pivot0=pivot0, block_w=4,
                            interpret=True)
    got = apply_panel(_t(np.asarray(V)), _t(np.asarray(T)), _t(C), pivot0=pivot0)
    _close(got.numpy(), want, 1e-11 * 3)
    assert np.array_equal(got.numpy()[:pivot0], C[:pivot0])  # rows above untouched


def test_apply_factors_in_place_on_a_strided_view_and_batch():
    pans = _t(_rand((2, 30, 4), 11, np.float64))
    frame = _t(_rand((2, 30, 20), 12, np.float64))
    _, V, T = ggr_panel.panel_factor(pans)
    want = torch.stack([ggr_apply.apply_factors(V[i], T[i], frame[i, :, 9:])
                        for i in range(2)])
    view = frame[:, :, 9:]
    out = ggr_apply.apply_factors(V, T, view, out=view)
    assert out.data_ptr() == view.data_ptr()
    assert torch.equal(frame[:, :, 9:], want)
    with pytest.raises(ValueError):
        ggr_apply.apply_factors(V, T, frame, block_w=0)
    with pytest.raises(ValueError):
        ggr_apply.apply_factors(V, T, frame[:, :20])


def _pipeline_apply(V, T, C, pivot0):
    """Scalar emulation of the CUDA kernel's order (csrc/ggr_apply.cu).

    Transform q is pipeline stage q.  It reads its column bottom-up and, on
    reading row r, emits row r + 1: the DET2 value below its pivot, P_p / t_p
    at the pivot, the row as it was above it.  A flush token after row
    pivot0 emits the last row.  Stage q reads what stage q - 1 emitted on the
    previous tick, so at tick tau it works on the stream's element
    e = tau - 2q; every stage takes its step in one tick, last stage first.
    """
    B, m, b = V.shape
    w = C.shape[2]
    out = C.copy()
    r0 = min(pivot0, m)
    n0 = m - r0
    eps = 1e-30
    for i in range(B):
        v, t = V[i], T[i]
        P = np.zeros((b, w))
        prev = np.zeros((b, w))  # the stage's previous input
        emit = np.zeros((b, w))  # what the stage emitted on the last tick
        for tau in range(n0 + 2 * b - 1):
            for q in range(b - 1, -1, -1):
                e = tau - 2 * q
                r = m - 1 - e  # the row this stage reads; r0 - 1: the flush
                if e < 0 or r < r0 - 1:
                    continue  # not started, or done
                if q:
                    x = emit[q - 1].copy()
                else:
                    x = C[i, r] if r >= r0 else np.zeros(w)
                p = pivot0 + q
                y = prev[q].copy()
                if e and p < m and t[p, q] > eps:
                    if r + 1 == p:
                        y = P[q] / t[p, q]
                    elif r >= p and t[r + 1, q] > eps:
                        st = t[r, q] if t[r, q] > eps else 1.0
                        stn = t[r + 1, q]
                        y = (v[r, q] / (st * stn)) * P[q] - (stn / st) * x
                emit[q] = y
                if r >= p:
                    P[q] = v[r, q] * x + P[q]
                prev[q] = x
                if q == b - 1 and e:
                    out[i, r + 1] = y
    return out


@pytest.mark.parametrize("B,m,b,w,pivot0,degenerate", [
    (2, 20, 4, 5, 0, False), (1, 17, 8, 3, 3, False),
    (1, 12, 8, 4, 6, False),   # b > m - pivot0: pivots past the last row
    (2, 24, 8, 6, 2, True),    # t_p = 0 at a mid-panel pivot
    (1, 9, 3, 2, 0, True)])
def test_pipeline_order_equals_plain_apply(B, m, b, w, pivot0, degenerate):
    """The kernel's streaming order (one stage per transform, a flush token)
    computes exactly what apply_factors_plain does, at f64."""
    pans = _rand((B, m, b), m + b + pivot0, np.float64)
    _, V, T = ggr_panel.panel_factor_plain(_t(pans), pivot0)
    if degenerate:
        c = b // 2
        T[:, pivot0 + c, c] = 0.0
    C = _rand((B, m, w), m + w, np.float64)
    want = ggr_apply.apply_factors_plain(V, T, _t(C), pivot0).numpy()
    got = _pipeline_apply(V.numpy(), T.numpy(), C, pivot0)
    assert np.array_equal(got, want)


def test_pipeline_order_keeps_a_zero_problem_bitwise_zero():
    V = np.zeros((2, 16, 8))
    C = np.zeros((2, 16, 5))
    got = _pipeline_apply(V, V, C, 3)
    assert np.array_equal(got.view(np.int64), np.zeros_like(got, dtype=np.int64))
    want = ggr_apply.apply_factors_plain(_t(V), _t(V), _t(C), 3).numpy()
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


def _rotation_apply(V, T, C, pivot0):
    """Emulation of the arithmetic the card runs (csrc/ggr_apply.cu, the
    two-coefficient form): each stage carries the scaled suffix dot Q =
    P_{r+1} / t_{r+1} and, on reading row r with the pair (a, c) that
    coeff_kernel writes for it, emits row r + 1 as a Q - c x and updates
    Q <- a x + c Q; a = v_r / t_r, c = t_{r+1} / t_r below the pivot, (1, +0)
    on the row above it (the pivot row is Q), and c = -0.0 flags a pass (the
    stage emits its previous input and Q <- a x, dropping c Q).  Stage q's
    output stream, bottom-up, is stage q + 1's input, closed by a flush zero."""
    B, m, b = V.shape
    out = C.copy()
    r0 = min(pivot0, m)
    eps = 1e-30
    for i in range(B):
        stream = C[i, r0:][::-1].copy()  # rows m-1 .. r0, bottom-up
        for q in range(b):
            p = pivot0 + q
            live = p < m and T[i, p, q] > eps
            Q = np.zeros(C.shape[2])
            xp = np.zeros(C.shape[2])
            emitted = []
            for e, x in enumerate(list(stream) + [np.zeros(C.shape[2])]):
                r = m - 1 - e  # r0 - 1: the flush
                a, c = 0.0, -0.0
                if live and r >= p:
                    t = T[i, r, q]
                    tn = T[i, r + 1, q] if r + 1 < m else 0.0
                    st = t if t > eps else 1.0
                    a = V[i, r, q] / st
                    if tn > eps:
                        c = tn / st
                elif live and r == p - 1:
                    a, c = 1.0, 0.0
                y = xp if np.signbit(c) else a * Q - c * x
                Q = a * x + c * Q
                xp = x
                if e:
                    emitted.append(y)
            stream = np.array(emitted)
        out[i, r0:] = stream[::-1]
    return out


@pytest.mark.parametrize("scale", [1.0, 1e-10, 1e-20, 1e-31])
@pytest.mark.parametrize("B,m,b,w,pivot0,degenerate", [
    (2, 20, 4, 5, 0, False), (1, 64, 8, 5, 0, False), (1, 17, 8, 3, 3, False),
    (1, 12, 8, 4, 6, False),   # b > m - pivot0: pivots past the last row
    (2, 24, 8, 6, 2, True),    # t_p = 0 at a mid-panel pivot
    (1, 9, 3, 2, 0, True)])
def test_rotation_arithmetic_matches_plain_apply(B, m, b, w, pivot0, degenerate, scale):
    """The card's two-coefficient rotation on Q = P / t, with passes flagged
    by c = -0.0, gives apply_factors_plain's result to 1e-13 relative at f64,
    with the panel and C scaled from 1 down to 1e-31."""
    pans = _rand((B, m, b), m + b + pivot0, np.float64) * scale
    _, V, T = ggr_panel.panel_factor_plain(_t(pans), pivot0)
    if degenerate:
        c = b // 2
        T[:, pivot0 + c, c] = 0.0
    C = _rand((B, m, w), m + w, np.float64) * scale
    want = ggr_apply.apply_factors_plain(V, T, _t(C), pivot0).numpy()
    got = _rotation_apply(V.numpy(), T.numpy(), C, pivot0)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13 * np.abs(want).max())


def test_rotation_arithmetic_keeps_a_zero_problem_bitwise_zero():
    V = np.zeros((2, 16, 8))
    C = np.zeros((2, 16, 5))
    got = _rotation_apply(V, V, C, 3)
    assert np.array_equal(got.view(np.int64), np.zeros_like(got, dtype=np.int64))


# ------------------------------------------------------------ fused drivers
def test_tsqrt_matches_jax_and_numpy():
    rng = np.random.default_rng(8)
    R_top = np.triu(rng.standard_normal((8, 8))).astype(np.float32)
    B = rng.standard_normal((24, 8)).astype(np.float32)
    want = jops.tsqrt(jnp.asarray(R_top), jnp.asarray(B), interpret=True)
    got = tsqrt(_t(R_top), _t(B))
    for g, w in zip(got, want):
        _close(g.numpy(), w, 5e-5 * 2)
    Rnp = np.linalg.qr(np.concatenate([R_top, B]), mode="r")
    np.testing.assert_allclose(np.abs(got[0].numpy()), np.abs(Rnp), atol=1e-4)


@pytest.mark.parametrize("m,n,panel", [(32, 32, 8), (64, 32, 16), (128, 64, 32)])
def test_ggr_qr_pallas_matches_jax(m, n, panel):
    A = _rand((m, n), m + n, np.float32)
    want = np.asarray(jops.ggr_qr_pallas(jnp.asarray(A), panel=panel, interpret=True))
    got = ggr_qr_pallas(_t(A), panel=panel).numpy()
    _close(got, want, 5e-5 * max(1, m // 16))
    Rnp = np.linalg.qr(A.astype(np.float64), mode="r")
    np.testing.assert_allclose(np.abs(got[:n]), np.abs(Rnp), atol=5e-3)
    with pytest.raises(ValueError):
        ggr_qr_pallas(_t(A), panel=panel + 1)


FUSED_CASES = [
    (70, 37, 30, 16, np.float64),   # m != n, non-multiples, 7 rhs columns ride
    (100, 45, 45, 16, np.float64),  # pure QR of a non-multiple square-ish block
    (40, 61, 20, 8, np.float64),    # wide: more columns than rows
    (70, 37, 30, 16, np.float32),
    (129, 65, 65, 64, np.float64),  # two phases, one row past a tile multiple
]


@pytest.mark.parametrize("m,w,n_piv,tile,dtype", FUSED_CASES)
def test_fused_schedule_matches_jax(m, w, n_piv, tile, dtype):
    X = _rand((m, w), m + w, dtype)
    want = np.asarray(jblocked.ggr_triangularize_blocked(
        jnp.asarray(X), n_piv, tile=tile, schedule="fused", interpret=True))
    got = blocked.ggr_triangularize_blocked(_t(X), n_piv, tile=tile,
                                            schedule="fused")
    tol = TOL[dtype] * max(1, m // 16)
    _close(got.numpy(), want, tol)


@pytest.mark.parametrize("m,w,n_piv,tile,dtype", FUSED_CASES)
def test_tree_and_fused_give_the_same_r(m, w, n_piv, tile, dtype):
    """Two orthogonal reductions of one matrix: |R| agrees to roundoff."""
    X = _t(_rand((m, w), m + w + 1, dtype))
    k = min(m, n_piv)
    tree = blocked.ggr_triangularize_blocked(X, n_piv, tile=tile, schedule="tree")
    fused = blocked.ggr_triangularize_blocked(X, n_piv, tile=tile, schedule="fused")
    tol = TOL[dtype] * max(1, m // 16)
    # the last pivot row's sign is set by roundoff in either schedule
    _close(torch.triu(fused[:k, :n_piv]).abs().numpy(),
           torch.triu(tree[:k, :n_piv]).abs().numpy(), tol)


def test_fused_batch_equals_per_problem_loop_with_one_launch_per_panel(monkeypatch):
    """B problems share one panel_factor call and one apply_factors call per
    panel; the batched result equals a loop of single-problem calls bit for
    bit.  A pure QR's last panel has no apply."""
    Xb = _t(_rand((3, 70, 37), 4, np.float64))
    calls = {"panel": 0, "apply": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(blocked, "panel_factor", counting("panel", ggr_panel.panel_factor))
    monkeypatch.setattr(blocked, "apply_factors", counting("apply", ggr_apply.apply_factors))
    out = blocked.ggr_triangularize_blocked(Xb, 30, tile=16, schedule="fused")
    assert calls == {"panel": 2, "apply": 2}  # 30 pivots -> 2 panels of 16
    loop = torch.stack([blocked.ggr_triangularize_blocked(x, 30, tile=16,
                                                          schedule="fused")
                        for x in Xb])
    assert torch.equal(out, loop)
    calls.update(panel=0, apply=0)
    blocked.ggr_qr_blocked(Xb[:, :64, :32], tile=16, schedule="fused")
    assert calls == {"panel": 2, "apply": 1}


def test_fused_mixed_precision_matches_jax():
    X = _rand((64, 40), 7, np.float32)
    got = blocked.ggr_triangularize_blocked(_t(X), 32, tile=16, schedule="fused",
                                            precision="bf16")
    assert got.dtype == torch.bfloat16
    want = np.asarray(jblocked.ggr_triangularize_blocked(
        jnp.asarray(X), 32, tile=16, schedule="fused", interpret=True,
        precision="bf16").astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=5e-2 * np.abs(want).max())


@pytest.mark.parametrize("policy", ["bf16", "mixed_f16"])
def test_kernel_plain_versions_mixed_precision_match_jax(policy):
    pan = _rand((64, 16), 31, np.float32)
    C = _rand((64, 24), 32, np.float32)
    want = jops.panel_qr(jnp.asarray(pan), interpret=True, precision=policy)
    got = panel_qr(_t(pan), precision=policy)
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, atol=2e-2 * np.abs(w).max())
    wa = jops.apply_panel(want[1], want[2], jnp.asarray(C), interpret=True,
                          precision=policy)
    ga = apply_panel(got[1], got[2], _t(C), precision=policy)
    wa = np.asarray(wa.astype(jnp.float32))
    np.testing.assert_allclose(ga.float().numpy(), wa, atol=2e-2 * np.abs(wa).max())


# ------------------------------------------------- explicit-Q tile primitives
@pytest.mark.parametrize("m,b", [(16, 8), (24, 24), (9, 12)])
def test_ggr_geqrt_matches_jax(m, b):
    tile = _rand((m, b), m * b, np.float64)
    Rw, Qw = jblocked.ggr_geqrt(jnp.asarray(tile))
    R, Qt = blocked.ggr_geqrt(_t(tile))
    _close(R.numpy(), Rw, 1e-11)
    _close(Qt.numpy(), Qw, 1e-11)
    np.testing.assert_allclose((Qt @ _t(tile)).numpy(), R.numpy(), atol=1e-11)


def test_ggr_tsqrt_matches_jax():
    rng = np.random.default_rng(3)
    R_top = np.triu(rng.standard_normal((8, 8)))
    B = rng.standard_normal((8, 8))
    Rw, Qw = jblocked.ggr_tsqrt(jnp.asarray(R_top), jnp.asarray(B))
    R, Qt = blocked.ggr_tsqrt(_t(R_top), _t(B))
    _close(R.numpy(), Rw, 1e-11)
    _close(Qt.numpy(), Qw, 1e-11)


@pytest.mark.parametrize("m,n,tile", [(64, 64, 16), (96, 32, 32)])
def test_qr_blocked_reference_matches_jax(m, n, tile):
    A = _rand((m, n), m + n, np.float64)
    want = np.asarray(jblocked.ggr_qr_blocked_reference(jnp.asarray(A), tile=tile))
    got = blocked.ggr_qr_blocked_reference(_t(A), tile=tile).numpy()
    _close(got, want, 1e-11 * max(1, m // 16))
    R = blocked.ggr_qr_blocked(_t(A), tile=tile, schedule="fused").numpy()
    np.testing.assert_allclose(np.abs(R), np.abs(got), atol=1e-11)
    with pytest.raises(ValueError):
        blocked.ggr_qr_blocked_reference(_t(A[:, :n - 1]), tile=tile)


# -------------------------------------------------------------- ref oracles
@pytest.mark.parametrize("dtype", DTYPES)
def test_ref_oracles_match_jax(dtype):
    rng = np.random.default_rng(21)
    v = rng.standard_normal(24).astype(dtype)
    X = rng.standard_normal((24, 6)).astype(dtype)
    tol = TOL[dtype] * 2
    for g, w in zip(ref.ref_suffix_stats(_t(v), _t(X)),
                    jref.ref_suffix_stats(jnp.asarray(v), jnp.asarray(X))):
        _close(g.numpy(), w, tol)
    k, l = rng.standard_normal(24).astype(dtype), rng.standard_normal(24).astype(dtype)
    _close(ref.ref_det2_grid(_t(k), _t(l), _t(X), _t(X)).numpy(),
           jref.ref_det2_grid(jnp.asarray(k), jnp.asarray(l), jnp.asarray(X),
                              jnp.asarray(X)), tol)
    pan = rng.standard_normal((24, 6)).astype(dtype)
    for pivot0 in (0, 5):
        got = ref.ref_panel_factor(_t(pan), pivot0)
        want = jref.ref_panel_factor(jnp.asarray(pan), pivot0)
        for g, w in zip(got, want):
            _close(g.numpy(), w, tol)
        C = rng.standard_normal((24, 10)).astype(dtype)
        _close(ref.ref_apply_factors(got[1], got[2], _t(C), pivot0).numpy(),
               jref.ref_apply_factors(want[1], want[2], jnp.asarray(C), pivot0), tol)
    A = rng.standard_normal((20, 8)).astype(dtype)
    A[:, 5] = A[:, 2]  # a repeated column: rank 7
    Rg, pg = ref.ref_pivoted_panel_factor(_t(A))
    Rw, pw = jref.ref_pivoted_panel_factor(jnp.asarray(A))
    assert pg.tolist() == np.asarray(pw).tolist()
    _close(np.abs(Rg.numpy())[:7], np.abs(np.asarray(Rw))[:7], tol * 10)


def test_plain_versions_match_the_ref_oracles():
    """The kernels' plain versions against the core.ggr oracles of this port
    (1e-11 in f64: two summation orders of one function)."""
    pan = _t(_rand((40, 8), 22, np.float64))
    C = _t(_rand((40, 5), 23, np.float64))
    for pivot0 in (0, 3, 32):
        got = panel_qr(pan, pivot0=pivot0)
        want = ref.ref_panel_factor(pan, pivot0)
        for g, w in zip(got, want):
            _close(g.numpy(), w.numpy(), 1e-11 * 3)
        _close(apply_panel(got[1], got[2], C, pivot0=pivot0).numpy(),
               ref.ref_apply_factors(got[1], got[2], C, pivot0).numpy(), 1e-11 * 3)


# ---------------------------------------------------------- schedule routing
def test_fused_runs_under_degraded_mode_and_matches_jax():
    X = _rand((48, 20), 5, np.float64)
    want = np.asarray(jblocked.ggr_triangularize_blocked(
        jnp.asarray(X), 20, tile=8, schedule="fused", interpret=True))
    with degraded_mode(schedule="fused"):
        got = blocked.ggr_triangularize_blocked(_t(X), 20, tile=8)
    _close(got.numpy(), want, 1e-11 * 3)


def test_cpu_calls_launch_nothing():
    counters = [ggr_panel.panel_factor, ggr_apply.apply_factors,
                ggr_panel.batched_geqrt]
    before = [f.launches for f in counters]
    X = _t(_rand((40, 24), 6, np.float32))
    blocked.ggr_qr_blocked(X, tile=8, schedule="fused")
    ggr_qr_pallas(X, panel=8)
    assert [f.launches for f in counters] == before
