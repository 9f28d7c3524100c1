"""The CUDA kernels on the card: each held against its plain PyTorch version.

The card tests carry the ``gpu`` marker and skip without a CUDA device.  This
file imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import blocked
from repro_torch.kernels import (Precision, _cuda, batched_geqrt, batched_update,
                                 ggr_qr_pallas)
from repro_torch.kernels import ggr_apply, ggr_panel, ggr_update
from repro_torch.launch import serve_qr
from repro_torch.testing import kernel_check as kc

# kernel vs plain version, each output on its own: the worst error over that
# output's rms within kc.rel_bound() (the table chip_smoke.py holds the
# kernels to); bf16 / f16 tiles run with f32 accumulation on
# kc.condition_-ed data, against the plain version at the same pair, and
# hold the parts of their outputs the algorithm determines (_worst_rel)
rel_bound, _rel_err = kc.rel_bound, kc.rel_err
# the tile dtypes the kernels take: f32 / f64 at their own width, and the
# mixed ones, each with its named policy (f32 accumulation)
MIXED = {getattr(torch, tile): policy for tile, policy in kc.POLICY.items()}
DTYPES = [torch.float32, torch.float64, *MIXED]


def _accum(dtype):
    """The accumulation dtype's name of a tile dtype's kernel (the plain
    version's ``accum_dtype``: None is the tile dtype itself)."""
    return "float32" if dtype in MIXED else None


def _worst_rel(name, param, got, want):
    """max|err| / rms of each output (f32 / f64) or of each part a bf16 /
    f16 kernel's algorithm determines (kc.determined), the worst."""
    got, want = ((got, want) if isinstance(got, tuple) else ((got,), (want,)))
    if got[0].dtype in MIXED:
        got, want = kc.determined(name, param, got), kc.determined(name, param, want)
    return max(_rel_err(a, b) for a, b in zip(got, want))


def _mixed_data(x, name, param):
    """A mixed case's inputs well conditioned, as the main path's states
    are (kc.condition_); f32 / f64 cases keep their Gaussian data."""
    return kc.condition_(x, name, param) if x.dtype in MIXED else x


def test_cpu_tensors_never_reach_the_cuda_binding(monkeypatch):
    """The tensor's device decides: CPU tensors take the plain version and
    never touch nvcc or the ctypes binding."""
    def refuse(*a, **k):
        raise AssertionError("CUDA binding reached from a CPU tensor")

    monkeypatch.setattr(_cuda, "launch", refuse)
    monkeypatch.setattr(_cuda, "build", refuse)
    X = torch.randn(3, 7, 5, dtype=torch.float64)
    X[:, :4, :4] = torch.triu(X[:, :4, :4])
    assert torch.equal(batched_update(X, 4), ggr_update.batched_update_plain(X, 4))
    assert torch.equal(batched_geqrt(X, 4), ggr_panel.batched_geqrt_plain(X, 4))
    R, V, T = ggr_panel.panel_factor(X, pivot0=1)
    for a, b in zip((R, V, T), ggr_panel.panel_factor_plain(X, 1)):
        assert torch.equal(a, b)
    assert torch.equal(ggr_apply.apply_factors(V, T, X, pivot0=1),
                       ggr_apply.apply_factors_plain(V, T, X, 1))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels compile and run only there")
    return torch.device("cuda")


def _stack(g, card, B, m, w, n_piv, dtype):
    X = torch.randn((B, m, w), generator=g, device=card, dtype=dtype)
    X[:, :n_piv, :n_piv] = torch.triu(X[:, :n_piv, :n_piv])
    _mixed_data(X, "batched_update", n_piv)
    X[0] = 0
    return X


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,m,w,n_piv", [(2, 12, 9, 8), (67, 40, 33, 32),
                                         (7, 104, 65, 64), (5, 128, 192, 64),
                                         (2, 128, 192, 64), (32, 128, 192, 64),
                                         (3, 200, 65, 64), (2, 12, 1, 1),
                                         (2, 12, 1000, 8), (2, 600, 9, 8)])
def test_batched_update_kernel_matches_plain(card, dtype, B, m, w, n_piv):
    """Problem 0 is all zero and every other one random, so each case holds
    at least one real problem.  (2, 128, 192) is the tree's last coupling
    round (one problem) beside the zero one, (32, 128, 192) its first;
    (3, 200, 65) has p+1 = 137 active rows, (2, 12, 1) one pivot and one
    column, (2, 12, 1000) a width near the 1024 threads of a block (a
    mixed instance holds two elements of the next pivot row in registers),
    (2, 600, 9) one pivot buffer.  bf16 / f16 tiles run with f32
    accumulation, the launch recorded at that pair and the result at the
    tile dtype."""
    g = torch.Generator(device=card).manual_seed(B + m)
    X = _stack(g, card, B, m, w, n_piv, dtype)
    n0 = batched_update.launches
    out = batched_update(X, n_piv, precision=MIXED.get(dtype))
    assert batched_update.launches == n0 + 1
    assert ((B, m, w), n_piv, dtype, _accum(dtype) or str(dtype)[6:]) in \
        batched_update.shapes
    assert out.dtype == dtype
    ref = ggr_update.batched_update_plain(X, n_piv, _accum(dtype))
    assert _worst_rel("batched_update", n_piv, out, ref) <= rel_bound("batched_update", m, w,
                                                                        dtype)
    assert _bits_zero(out[0])  # the zero problem comes back bitwise zero


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, *MIXED])
@pytest.mark.parametrize("m,w,n_piv", [(40, 33, 32), (104, 65, 64), (128, 192, 64)])
def test_batched_update_result_does_not_depend_on_the_batch(card, m, w, n_piv, dtype):
    """40 problems at the serving append, serving kalman and tree-coupling
    shapes: each equals itself launched alone, bit for bit, wherever it sits
    in the batch (the serving and solver contracts of batched == sequential
    rest on this), at f32 tiles and at bf16 / f16 tiles with f32 sums."""
    g = torch.Generator(device=card).manual_seed(m + w)
    X = _stack(g, card, 40, m, w, n_piv, dtype)
    pol = MIXED.get(dtype)
    got = batched_update(X, n_piv, precision=pol)
    for i in range(40):
        assert torch.equal(got[i], batched_update(X[i:i + 1], n_piv, precision=pol)[0])
    assert torch.equal(got[7:20], batched_update(X[7:20], n_piv, precision=pol))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,t,w,n_piv", [(2, 8, 16, 8), (67, 64, 128, 64),
                                         (9, 20, 24, 16), (4, 12, 30, 16),
                                         (3, 65, 131, 65), (3, 128, 200, 128),
                                         (2, 33, 40, 0), (2, 24, 900, 24),
                                         (2, 1, 1, 1), (3, 300, 20, 20)])
def test_batched_geqrt_kernel_matches_plain(card, dtype, B, t, w, n_piv):
    """Tile 0 is all zero and comes back bitwise; 65 and 128 active rows put
    two and four rows on a lane of the coefficient warp; n_piv = 0 copies
    (bitwise); 900 columns give a thread two; 300 rows, more than the warp
    holds in registers (three passes through the records), with n_piv = w.
    bf16 / f16 tiles run with f32 accumulation."""
    g = torch.Generator(device=card).manual_seed(B + t)
    X = _mixed_data(torch.randn((B, t, w), generator=g, device=card, dtype=dtype),
                    "batched_geqrt", n_piv)
    X[0] = 0
    n0 = batched_geqrt.launches
    out = batched_geqrt(X, n_piv, precision=MIXED.get(dtype))
    assert batched_geqrt.launches == n0 + 1
    assert out.dtype == dtype
    ref = ggr_panel.batched_geqrt_plain(X, n_piv, _accum(dtype))
    assert _worst_rel("batched_geqrt", n_piv, out, ref) <= rel_bound("batched_geqrt", t, w,
                                                                       dtype)
    assert torch.equal(out[0], X[0])
    if n_piv == 0:
        assert torch.equal(out, X)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(MIXED))
def test_batched_geqrt_mixed_on_the_trees_tiles(card, dtype):
    """The tree's (64, 64, 128) [pan | I] tiles at bf16 / f16: within
    rel_bound of the plain version, the [0 | I] tiles bitwise as they were
    (0 and 1 are exact in both), and each tile's bits independent of its
    batch."""
    g = torch.Generator(device=card).manual_seed(65)
    X = _tree_tiles(g, card, 64, 64, dtype)
    pol = MIXED[dtype]
    out = batched_geqrt(X, 64, precision=pol)
    assert _worst_rel("batched_geqrt", 64, out,
                      ggr_panel.batched_geqrt_plain(X, 64, "float32")) <= rel_bound(
        "batched_geqrt", 64, 128, dtype)
    assert torch.equal(out[32:], X[32:])
    for i in (0, 17, 63):
        assert torch.equal(out[i], batched_geqrt(X[i:i + 1], 64, precision=pol)[0])


def _tree_tiles(g, card, B, b, dtype):
    """[pan | I] tiles as the tree schedule builds them, the second half
    [0 | I] (row tiles past the matrix)."""
    pan = _mixed_data(torch.randn((B, b, b), generator=g, device=card, dtype=dtype),
                      "batched_geqrt", b)
    pan[B // 2:] = 0
    eye = torch.eye(b, device=card, dtype=dtype).expand(B, b, b)
    return torch.cat([pan, eye], 2).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-13)])
def test_batched_geqrt_on_the_trees_tiles(card, dtype, tol):
    """(64, 64, 128) [pan | I] tiles, half [0 | I], as the tree QR's first
    panel: each output within rel_bound of the plain version; Qt orthogonal
    (max |Qt Qt^T - I|) and Qt T = R (||Qt T - R|| / ||T||) within tol, a few
    times 64 rows' worth of rounding (64 x 6e-8 f32, 64 x 1.1e-16 f64), which
    holds whatever the tiles' conditioning; the [0 | I] tiles bitwise as they
    were."""
    g = torch.Generator(device=card).manual_seed(64)
    X = _tree_tiles(g, card, 64, 64, dtype)
    out = batched_geqrt(X, 64)
    assert _rel_err(out, ggr_panel.batched_geqrt_plain(X, 64)) <= rel_bound(
        "batched_geqrt", 64, 128, dtype)
    assert torch.equal(out[32:], X[32:])
    R, Qt, T = (z[:32].double() for z in (out[:, :, :64], out[:, :, 64:], X[:, :, :64]))
    eye = torch.eye(64, device=card, dtype=torch.float64)
    assert float((Qt @ Qt.transpose(1, 2) - eye).abs().max()) <= tol
    assert float(torch.linalg.norm(Qt @ T - R) / torch.linalg.norm(T)) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("data", ["random", "tree"])
def test_batched_geqrt_result_does_not_depend_on_the_batch(card, data):
    """40 (64, 128) tiles, random or the tree's own: each equals itself
    launched alone, bit for bit, wherever it sits in the batch."""
    g = torch.Generator(device=card).manual_seed(40)
    X = (_tree_tiles(g, card, 40, 64, torch.float32) if data == "tree"
         else torch.randn((40, 64, 128), generator=g, device=card))
    got = batched_geqrt(X, 64)
    for i in range(40):
        assert torch.equal(got[i], batched_geqrt(X[i:i + 1], 64)[0])
    assert torch.equal(got[7:20], batched_geqrt(X[7:20], 64))


def _bits_zero(x):
    itype = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
    return bool((x.view(itype) == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,m,b,pivot0", [(1, 8, 4, 0), (3, 48, 8, 13),
                                          (2, 4096, 64, 0), (1, 1500, 32, 700),
                                          (2, 40, 8, 36), (1, 10000, 8, 0),
                                          (3, 128, 64, 0), (1, 4097, 64, 0),
                                          (1, 5000, 24, 300), (1, 65536, 64, 0),
                                          (1, 600, 300, 0), (2, 300, 520, 0)])
def test_panel_factor_kernel_matches_plain(card, dtype, B, m, b, pivot0):
    """Tall frames split into many row slabs (the exchanges between blocks,
    the halo) and each slab into row chunks; (3, 128, 64) runs on one block
    per panel; 4097 and 5000 rows give slabs of uneven heights, and pivot0 =
    300 puts the pivots inside the second slab; pivot0 = 36 of 40 rows runs
    pivots onto the last row and past the end; 65536 rows f64 (32 MiB) keep
    the slabs in device memory; widths 300 and 520 sweep their columns in
    two and three groups of the block's 256 threads.  bf16 / f16 panels run
    with f32 accumulation.  Each of R, V, T is held on its own scale, its
    rms, so one wrong row of a tall panel shows."""
    g = torch.Generator(device=card).manual_seed(B + m + b)
    X = _mixed_data(torch.randn((B + 1, m, b), generator=g, device=card, dtype=dtype),
                    "panel_factor", pivot0)
    X[0] = 0
    n0 = ggr_panel.panel_factor.launches
    got = ggr_panel.panel_factor(X, pivot0=pivot0, precision=MIXED.get(dtype))
    assert ggr_panel.panel_factor.launches == n0 + 1
    want = ggr_panel.panel_factor_plain(X, pivot0, _accum(dtype))
    assert _worst_rel("panel_factor", pivot0, got, want) <= rel_bound("panel_factor", m, b,
                                                                       dtype)
    for a in got:
        assert a.dtype == dtype
        assert _bits_zero(a[0])  # the zero panel comes back bitwise zero


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(MIXED))
def test_panel_factor_mixed_keeps_device_slabs_in_the_scratch(card, dtype):
    """A (1, 140000, 64) bf16 / f16 panel: more rows than the co-resident
    blocks hold in shared memory at f32, so its slabs live in device memory,
    in the scratch buffer (R holds the tile dtype): each of R, V, T within
    rel_bound of the plain version, the zero panel bitwise zero."""
    g = torch.Generator(device=card).manual_seed(140065)
    X = torch.randn((2, 140000, 64), generator=g, device=card, dtype=dtype)
    X[0] = 0
    cap = lambda smem: ggr_panel._panel_capacity(X, smem, "float32")  # noqa: E731
    assert not ggr_panel._panel_blocks(140000, 64, 4, cap)[1]
    got = ggr_panel.panel_factor(X, precision=MIXED[dtype])
    want = ggr_panel.panel_factor_plain(X, 0, "float32")
    assert _worst_rel("panel_factor", 0, got, want) <= rel_bound("panel_factor", 140000, 64,
                                                                  dtype)
    for a in got:
        assert a.dtype == dtype
        assert _bits_zero(a[0])


@pytest.mark.gpu
def test_panel_factor_result_does_not_depend_on_the_batch(card):
    """40 fused frames need several cooperative launches (sub-batches); each
    panel's R, V and T equal that panel factored alone, bit for bit."""
    g = torch.Generator(device=card).manual_seed(40)
    X = torch.randn((40, 4096, 64), generator=g, device=card)
    n0 = ggr_panel.panel_factor.launches
    got = ggr_panel.panel_factor(X)
    assert ggr_panel.panel_factor.launches == n0 + 1
    for i in range(40):
        for a, w in zip(got, ggr_panel.panel_factor(X[i])):
            assert torch.equal(a[i], w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,m,b,w,pivot0", [(1, 16, 4, 8, 0), (2, 96, 8, 45, 5),
                                            (1, 4096, 64, 300, 0),
                                            (2, 2000, 16, 70, 900),
                                            (1, 40, 8, 9, 35), (1, 8192, 8, 20, 0),
                                            (1, 700, 24, 37, 0), (2, 515, 33, 21, 3),
                                            (1, 400, 130, 10, 2)])
def test_apply_factors_kernel_matches_plain(card, dtype, B, m, b, w, pivot0):
    """b = 24 leaves lanes of the warp idle and b = 33 fills one stage of a
    lane's second pair; widths 37 and 21 end inside a block's columns and b =
    130 takes two launches (128 transforms each at most).  bf16 / f16
    factors and columns run with f32 accumulation."""
    g = torch.Generator(device=card).manual_seed(B + m + w)
    pans = _mixed_data(torch.randn((B + 1, m, b), generator=g, device=card, dtype=dtype),
                       "apply_factors", (b, pivot0))
    pans[0] = 0
    _, V, T = ggr_panel.panel_factor_plain(pans, pivot0, _accum(dtype))
    C = torch.randn((B + 1, m, w), generator=g, device=card, dtype=dtype)
    C[0] = 0
    pol = MIXED.get(dtype)
    n0 = ggr_apply.apply_factors.launches
    got = ggr_apply.apply_factors(V, T, C, pivot0=pivot0, precision=pol)
    assert ggr_apply.apply_factors.launches == n0 + -(-b // 128)
    assert got.dtype == dtype
    want = ggr_apply.apply_factors_plain(V, T, C, pivot0, _accum(dtype))
    assert _worst_rel("apply_factors", (b, pivot0), got, want) <= rel_bound(
        "apply_factors", m, w, dtype)
    assert _bits_zero(got[0])
    # in place on a strided view of a wider frame: the same values
    frame = torch.zeros((B + 1, m, w + 7), device=card, dtype=dtype)
    frame[:, :, 7:] = C
    view = frame[:, :, 7:]
    ggr_apply.apply_factors(V, T, view, pivot0=pivot0, precision=pol, out=view)
    assert torch.equal(view, got) and not frame[:, :, :7].any()


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["bf16", "mixed_f16"])
@pytest.mark.parametrize("schedule", ["tree", "fused"])
def test_blocked_qr_mixed_on_the_card_is_bitwise_the_same_under_auto(card, precision,
                                                                     schedule):
    """ggr_qr_blocked at a mixed policy on the card: R at the tile dtype,
    the schedule's kernels launched at the pair, "auto" bitwise "fused", and
    the gram residual within the reference's budget."""
    from repro_torch.testing import error_budget, gram_residual

    A = torch.from_numpy(np.random.default_rng(5).standard_normal((300, 130))).float()
    n0 = {f: f.launches for f in (batched_update, batched_geqrt, ggr_panel.panel_factor,
                                  ggr_apply.apply_factors)}
    R = blocked.ggr_qr_blocked(A.to(card), tile=32, schedule=schedule, precision=precision)
    tile = torch.bfloat16 if precision == "bf16" else torch.float16
    assert R.dtype == tile
    launched = [f for f, n in n0.items() if f.launches > n]
    assert set(launched) == ({batched_geqrt, batched_update} if schedule == "tree" else
                             {ggr_panel.panel_factor, ggr_apply.apply_factors})
    for f in launched:
        assert {(s[2], s[3]) for s in f.shapes} >= {(tile, "float32")}
    if schedule == "fused":
        auto = blocked.ggr_qr_blocked(A.to(card), tile=32, precision=precision)
        assert torch.equal(R, auto)
    assert gram_residual(A.double().numpy(), R.float().cpu().numpy()) < error_budget(
        tile, "gram_residual", 300, 130)


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ["tree", "fused"])
def test_blocked_qr_on_the_card_matches_the_cpu(card, schedule):
    A = torch.from_numpy(np.random.default_rng(3).standard_normal((300, 130)))
    counters = (ggr_panel.panel_factor, ggr_apply.apply_factors)
    n0 = [f.launches for f in counters]
    R = blocked.ggr_qr_blocked(A.to(card), tile=32, schedule=schedule)
    launched = [f.launches - n for f, n in zip(counters, n0)]
    assert launched == ([5, 4] if schedule == "fused" else [0, 0])
    Rc = blocked.ggr_qr_blocked(A, tile=32, schedule=schedule)
    np.testing.assert_allclose(R.cpu().numpy(), Rc.numpy(), atol=1e-10)
    Rp = ggr_qr_pallas(A[:, :128].to(card), panel=32)
    np.testing.assert_allclose(np.abs(Rp.cpu().numpy()),
                               np.abs(ggr_qr_pallas(A[:, :128], panel=32).numpy()),
                               atol=1e-10)


@pytest.mark.gpu
def test_auto_is_the_fused_schedule_on_the_card(card):
    """``"auto"`` on a CUDA tensor runs the fused schedule, as the reference
    does where its kernels compile: the same R bit for bit, through
    panel_factor and apply_factors and no batched_geqrt."""
    A = torch.from_numpy(np.random.default_rng(4).standard_normal((300, 130))).to(card)
    counters = (ggr_panel.panel_factor, ggr_apply.apply_factors, batched_geqrt)
    n0 = [f.launches for f in counters]
    R = blocked.ggr_qr_blocked(A, tile=32)
    assert [f.launches - n for f, n in zip(counters, n0)] == [5, 4, 0]
    assert torch.equal(R, blocked.ggr_qr_blocked(A, tile=32, schedule="fused"))


# (kernel, shape, param) of the main path, cut in batch, each with a part of
# at least kc.READ_ENTRIES entries: the serving append and kalman sweeps and
# the tree coupling (B1), the tree's level 0 (B2), the fused QR's panel (B3)
# and its trailing columns (B4)
ROUNDING_CASES = [("batched_update", (2048, 40, 33), 32),
                  ("batched_update", (1024, 104, 65), 64),
                  ("batched_update", (16, 128, 192), 64),
                  ("batched_geqrt", (32, 64, 128), 64),
                  ("panel_factor", (1, 4096, 64), 0),
                  ("apply_factors", (1, 4096, 1024), (64, 0))]


def _mixed_case(card, name, shape, param, dtype):
    """(kernel(), x, plain(z, accum)) of a mixed case (kc.mixed_inputs)."""
    g = torch.Generator(device=card).manual_seed(sum(shape))
    x, plain, factors = kc.mixed_inputs(name, shape, param, dtype, g)
    pol = MIXED[dtype]
    if name == "apply_factors":
        return (lambda: ggr_apply.apply_factors(*factors, x, param[1], precision=pol), x,
                plain)
    kernel = {"batched_update": batched_update, "batched_geqrt": batched_geqrt,
              "panel_factor": ggr_panel.panel_factor}[name]
    return lambda: kernel(x, param, precision=pol), x, plain


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(MIXED))
@pytest.mark.parametrize("name,shape,param", ROUNDING_CASES)
def test_mixed_kernel_rounds_its_state_at_every_step(card, name, shape, param, dtype):
    """Each part of a bf16 / f16 kernel's outputs (kc.parts) lies as far
    from the exact result (the plain version in f64) as the plain version
    at the same pair, within kc.ROUNDING: the state rounded to the tile
    dtype at every step.  The f32 plain version rounded once to the tile
    dtype, the result of a kernel that keeps its state in f32, fails the
    same check."""
    kernel, x, plain = _mixed_case(card, name, shape, param, dtype)

    def parts(r):
        return kc.parts(name, param, r if isinstance(r, tuple) else (r,))

    ref, exact = parts(plain(x, "float32")), parts(plain(x.double(), None))
    stepped, ratios = kc.per_step(parts(kernel()), ref, exact)
    assert ratios and stepped, ratios
    once = tuple(o.to(dtype) for o in parts(plain(x.float(), None)))
    fooled, once_ratios = kc.per_step(once, ref, exact)
    assert not fooled, once_ratios


# the wide pairs' cases, chip_smoke.py's: B1 at the serving append, kalman
# and tree-coupling shapes, B2 at tree level 0 and on the tree's own tiles,
# B3 at the fused QR's and lstsq's panel frames, B4 at their trailing
# columns (the share the rule holds is a statistic of many problems)
WIDE_CASES = [("batched_update", (8192, 40, 33), 32, "random"),
              ("batched_update", (8192, 104, 65), 64, "random"),
              ("batched_update", (64, 128, 192), 64, "random"),
              ("batched_geqrt", (128, 64, 128), 64, "random"),
              ("batched_geqrt", (64, 64, 128), 64, "tree"),
              ("panel_factor", (1, 4096, 64), 0, "random"),
              ("panel_factor", (1, 8192, 64), 0, "random"),
              ("apply_factors", (1, 4096, 4032), (64, 0), "random"),
              ("apply_factors", (1, 8192, 964), (64, 0), "random")]


def _wide_inputs(card, name, shape, param, data, tile, seed):
    """Gaussian inputs of ``shape`` as chip_smoke.py's wide cases take them:
    B1's top rows upper triangular, the tree's [pan | I] / [0 | I] tiles,
    bf16 / f16 tiles conditioned (kc.condition_); for B4, C and the
    factors (V, T) of a Gaussian (B, m, b) panel at (tile, float64), else
    the input and None."""
    g = torch.Generator(device=card).manual_seed(seed)
    B, m, w = shape
    if data == "tree":
        pan = torch.randn((B, m, m), generator=g, device=card, dtype=tile)
        if tile in MIXED:
            kc.condition_(pan, name, param)
        pan[B // 2:] = 0
        return torch.cat([pan, torch.eye(m, device=card, dtype=tile).expand(B, m, m)],
                         2), None
    x = torch.randn(shape, generator=g, device=card, dtype=tile)
    if name == "batched_update":
        x[:, :param, :param] = torch.triu(x[:, :param, :param])
    if name == "apply_factors":
        b, pivot0 = param
        pan = torch.randn((B, m, b), generator=g, device=card, dtype=tile)
        if tile in MIXED:
            kc.condition_(pan, name, param)
        _, V, T = ggr_panel.panel_factor_plain(pan, pivot0, "float64")
        return x, (V, T)
    return (kc.condition_(x, name, param) if tile in MIXED else x), None


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [torch.float32, *MIXED])
@pytest.mark.parametrize("name,shape,param,data", WIDE_CASES)
def test_wide_kernel_passes_the_wide_rule(card, name, shape, param, data, tile):
    """f64 sums (every kernel): over kc.WIDE_DRAWS draws, the share of
    entries bitwise equal to the plain version at (tile, float64) at least
    kc.WIDE_EQUAL and max|err| / rms within kc.wide_bound (kc.wide_held);
    the (tile, float32) instance on the same inputs, a kernel that sums in
    f32, fails the rule."""
    fn = {"batched_update": batched_update, "batched_geqrt": batched_geqrt,
          "panel_factor": ggr_panel.panel_factor,
          "apply_factors": ggr_apply.apply_factors}[name]
    plain = {"batched_update": ggr_update.batched_update_plain,
             "batched_geqrt": ggr_panel.batched_geqrt_plain,
             "panel_factor": ggr_panel.panel_factor_plain,
             "apply_factors": ggr_apply.apply_factors_plain}[name]
    dn = str(tile).removeprefix("torch.")
    wide, ctrl = Precision(dn, "float64", dn), Precision(dn, "float32", dn)
    _, m, w = shape
    # B4 takes its factors and its pivot0 (param[1]); the others take param
    arg = param[1] if name == "apply_factors" else param
    reads, ctrls = [], []
    for seed in range(kc.WIDE_DRAWS):
        x, factors = _wide_inputs(card, name, shape, param, data, tile, seed)
        pre = factors or ()
        n0 = fn.launches
        out, ref = fn(*pre, x, arg, precision=wide), plain(*pre, x, arg, "float64")
        outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
        assert fn.launches == n0 + 1 and (shape, param, tile, "float64") in fn.shapes
        assert all(o.dtype == tile for o in outs)
        reads.append(kc.wide_reading(name, param, tile, outs, refs))
        c = fn(*pre, x, arg, precision=ctrl)
        ctrls.append(kc.wide_reading(name, param, tile, c if isinstance(c, tuple) else (c,),
                                     refs))
    assert kc.wide_held(name, m, w, tile, reads), reads
    assert not kc.wide_held(name, m, w, tile, ctrls), ctrls


# B1's and B2's narrow pairs (bf16 / f16 tiles summed at their own width) at
# the main path's shapes: chip_smoke.py's phase 3 and phase 14 (h)
NARROW_CASES = [c for c in WIDE_CASES if c[0] in ("batched_update", "batched_geqrt")]


@pytest.mark.gpu
@pytest.mark.parametrize("tile", list(MIXED))
@pytest.mark.parametrize("name,shape,param,data", NARROW_CASES)
def test_narrow_kernel_passes_the_wide_rule_at_its_share(card, name, shape, param, data,
                                                        tile):
    """bf16 / f16 tiles summed at their own width (B1, B2): over
    kc.WIDE_DRAWS draws, the share of entries bitwise equal to the plain
    version at (tile, tile) at least kc.NARROW_EQUAL and max|err| / rms
    within kc.wide_bound; the (tile, float32) instance on the same inputs
    fails the rule."""
    fn = {"batched_update": batched_update, "batched_geqrt": batched_geqrt}[name]
    plain = {"batched_update": ggr_update.batched_update_plain,
             "batched_geqrt": ggr_panel.batched_geqrt_plain}[name]
    dn = str(tile).removeprefix("torch.")
    narrow, ctrl = Precision(dn, dn, dn), Precision(dn, "float32", dn)
    _, m, w = shape
    reads, ctrls = [], []
    for seed in range(kc.WIDE_DRAWS):
        x, _ = _wide_inputs(card, name, shape, param, data, tile, seed)
        n0 = fn.launches
        out, ref = fn(x, param, precision=narrow), plain(x, param, dn)
        assert fn.launches == n0 + 1 and (shape, param, tile, dn) in fn.shapes
        assert out.dtype == tile
        reads.append(kc.wide_reading(name, param, tile, (out,), (ref,)))
        ctrls.append(kc.wide_reading(name, param, tile, (fn(x, param, precision=ctrl),),
                                     (ref,)))
    assert kc.wide_held(name, m, w, tile, reads, dn), reads
    assert not kc.wide_held(name, m, w, tile, ctrls, dn), ctrls


@pytest.mark.gpu
@pytest.mark.parametrize("tile", list(MIXED))
def test_tree_qr_at_a_narrow_pair_on_the_card(card, tile):
    """The tree QR at Precision(t, t, t) launches B1 and B2 only, at (t, t),
    R at t and finite, its Gram residual within 0.5-2x of the same call on
    a CPU copy (the plain versions); the fused schedule and "auto" raise
    NotImplementedError naming both dtypes, with no launch."""
    from repro_torch.testing import gram_residual

    dn = str(tile).removeprefix("torch.")
    prec = Precision(dn, dn, dn)
    g = torch.Generator(device=card).manual_seed(3)
    M = torch.randn((256, 256), generator=g, device=card)
    kernels = (batched_update, batched_geqrt, ggr_panel.panel_factor, ggr_apply.apply_factors)
    for fn in kernels:
        fn.launches = 0
        fn.shapes.clear()
    R = blocked.ggr_qr_blocked(M, schedule="tree", precision=prec)
    assert R.dtype == tile and bool(R.isfinite().all())
    assert batched_update.launches > 0 and batched_geqrt.launches > 0
    assert all(fn.launches == 0 for fn in kernels[2:])
    assert {sh[2:] for fn in kernels[:2] for sh in fn.shapes} == {(tile, dn)}
    A = M.double().cpu().numpy()
    cpu = blocked.ggr_qr_blocked(M.cpu(), schedule="tree", precision=prec)
    ratio = (gram_residual(A, R.double().cpu().numpy())
             / gram_residual(A, cpu.double().numpy()))
    assert 0.5 <= ratio <= 2.0, ratio
    for schedule in ("fused", "auto"):
        with pytest.raises(NotImplementedError, match=f"{dn} tiles with {dn} accumulation"):
            blocked.ggr_qr_blocked(M, schedule=schedule, precision=prec)
    assert all(fn.launches == 0 for fn in kernels[2:])


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [torch.float32, *MIXED])
def test_wide_panel_with_its_slabs_in_device_memory(card, tile):
    """B3 at (tile, float64) on a (1, 65536, 64) panel, too tall for its
    f64 slabs to be co-resident on the card: the kernel keeps them in
    ``work`` (the non-resident branch) and each draw's R, V and T are within
    kc.wide_bound of the plain version at the same pair (kc.wide_accurate)."""
    from functools import partial

    shape = (1, 65536, 64)
    dn = str(tile).removeprefix("torch.")
    x = torch.zeros(shape, device=card, dtype=tile)
    capacity = partial(ggr_panel._panel_capacity, x, accum_dtype="float64")
    assert not ggr_panel._panel_blocks(65536, 64, 8, capacity)[1]
    reads = []
    for seed in range(2):
        x, _ = _wide_inputs(card, "panel_factor", shape, 0, "random", tile, seed)
        n0 = ggr_panel.panel_factor.launches
        out = ggr_panel.panel_factor(x, 0, precision=Precision(dn, "float64", dn))
        ref = ggr_panel.panel_factor_plain(x, 0, "float64")
        assert ggr_panel.panel_factor.launches == n0 + 1
        assert (shape, 0, tile, "float64") in ggr_panel.panel_factor.shapes
        assert all(o.dtype == tile for o in out)
        reads.append(kc.wide_reading("panel_factor", 0, tile, out, ref))
    assert kc.wide_accurate("panel_factor", 65536, 64, tile, reads), reads


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [torch.float32, *MIXED])
def test_blocked_qr_wide_on_the_card_meets_the_budgets(card, tile):
    """ggr_qr_blocked of a 256^2 matrix at (tile, float64) on the card: the
    fused schedule launches B3 and B4 at the pair and no other kernel, R at
    the tile dtype within the reference's budgets wherever meaningful (the
    gram residual always), and ``"auto"`` is the same run bit for bit."""
    from repro_torch.testing import budget_is_meaningful, error_budget, factorization_errors

    dn = str(tile).removeprefix("torch.")
    prec = Precision(dn, "float64", dn)
    A = np.random.default_rng(8).standard_normal((256, 256)).astype(np.float32)
    counters = (batched_update, batched_geqrt, ggr_panel.panel_factor,
                ggr_apply.apply_factors)
    n0 = [f.launches for f in counters]
    for f in counters:
        f.shapes.clear()
    R = blocked.ggr_qr_blocked(torch.from_numpy(A).to(card), schedule="fused",
                               precision=prec)
    assert [f.launches - n > 0 for f, n in zip(counters, n0)] == [False, False, True, True]
    assert {(s[2], s[3]) for f in counters for s in f.shapes} == {(tile, "float64")}
    assert R.dtype == tile
    A = A.astype(np.float64)
    cond = float(np.linalg.cond(A))
    errs = factorization_errors(A, R.double().cpu().numpy(), R_ref=np.linalg.qr(A)[1])
    held = {k: v for k, v in errs.items()
            if k == "gram_residual" or budget_is_meaningful(dn, k, 256, 256, cond)}
    assert "gram_residual" in held
    for k, v in held.items():
        assert v < error_budget(dn, k, 256, 256, cond), (k, v)
    auto = blocked.ggr_qr_blocked(torch.from_numpy(A).float().to(card), precision=prec)
    assert torch.equal(R, auto)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_narrow_from_double_rounds_as_the_plain_versions(card, dtype):
    """ggr_common.cuh's narrow from double, the wide kernels' every store,
    on tie values: bitwise the plain versions' ``to_tile`` (float16 once
    rounded, bfloat16 through float32 as torch and XLA round it)."""
    from repro_torch.kernels.backend import to_tile

    ties = kc.tie_values().to(card)
    got, want = kc.narrow_on_card(ties, dtype), to_tile(ties, dtype)
    itype = torch.int16 if dtype != torch.float32 else torch.int32
    assert torch.equal(got.view(itype), want.view(itype))
    if dtype == torch.float16:  # one rounding, where torch's cast rounds twice
        assert not torch.equal(got.view(itype), ties.to(dtype).view(itype))


@pytest.mark.gpu
def test_seq_parallel_dry_run_step_under_this_torch(card):
    """One olmo-1b train step at smoke width with sequence parallelism on a
    fake 2x2 mesh (``lower_cell``) runs under this installation's torch
    (under torch 2.11 the row-parallel products' backward refused to
    flatten a sequence-split gradient), with reduce-scatter and all-gather
    recorded."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeConfig

    cfg = get_config("olmo-1b", smoke=True)
    *_, rec = dryrun.lower_cell("olmo-1b", ShapeConfig("smoke_train", 32, 16, "train"),
                                False, seq_parallel=True, cfg_override=cfg,
                                mesh_shape=((2, 2), ("data", "model")))
    assert rec.collectives["reduce-scatter"] > 0 and rec.collectives["all-gather"] > 0
    assert rec.flops > 0


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(card):
    """bf16 / f16 tiles run with f32 accumulation (the named policies), and
    f32 / bf16 / f16 tiles with f64 accumulation, in every kernel (zeros
    in, zeros out at the tile dtype); tiles summed at their own bf16 / f16
    width run in B1 and B2 and raise NotImplementedError naming both dtypes
    in B3 and B4."""
    X = torch.zeros((2, 12, 9), device=card)
    wide = [Precision(t, "float64", t) for t in ("float32", "bfloat16", "float16")]
    for fn in (batched_update, batched_geqrt):
        for tile, pol in MIXED.items():
            out = fn(X, 8, precision=pol)
            assert out.dtype == tile and _bits_zero(out)
        for prec in wide:
            out = fn(X, 8, precision=prec)
            assert out.dtype == prec.compute and _bits_zero(out)
        for tile in MIXED:  # summed at the tile's own width
            out = fn(X.to(tile), 8)
            assert out.dtype == tile and _bits_zero(out)
    big = torch.zeros((1, 240, 256), device=card, dtype=torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        batched_geqrt(big, 64)
    with pytest.raises(ValueError, match="threads"):
        batched_update(torch.zeros((1, 9, 1100), device=card), 8)
    pan = torch.zeros((64, 8), device=card)
    for tile, pol in MIXED.items():
        assert all(o.dtype == tile and _bits_zero(o)
                   for o in ggr_panel.panel_factor(pan, precision=pol))
        out = ggr_apply.apply_factors(pan, pan, pan, precision=pol)
        assert out.dtype == tile and _bits_zero(out)
    for prec in wide:
        assert all(o.dtype == prec.compute and _bits_zero(o)
                   for o in ggr_panel.panel_factor(pan, precision=prec))
        out = ggr_apply.apply_factors(pan, pan, pan, precision=prec)
        assert out.dtype == prec.compute and _bits_zero(out)
    with pytest.raises(NotImplementedError, match="bfloat16 tiles with bfloat16"):
        ggr_panel.panel_factor(pan.to(torch.bfloat16))
    for tile in MIXED:
        name = str(tile).removeprefix("torch.")
        with pytest.raises(NotImplementedError, match=f"{name} tiles with {name}"):
            ggr_panel.panel_factor(pan.to(tile))
        with pytest.raises(NotImplementedError, match=f"{name} tiles with {name}"):
            ggr_apply.apply_factors(pan.to(tile), pan.to(tile), pan.to(tile))
    with pytest.raises(ValueError, match="must share a dtype"):
        ggr_apply.apply_factors(pan.bfloat16(), pan.bfloat16(), pan)
    with pytest.raises(ValueError, match="shared memory"):  # no width limit but this
        ggr_panel.panel_factor(torch.zeros((4, 7000), device=card, dtype=torch.float64))
    # the kernel streams each column, so a frame of any height runs: here
    # 60000 rows f32, more than one column holds in shared memory
    g = torch.Generator(device=card).manual_seed(6)
    _, V, T = ggr_panel.panel_factor_plain(
        torch.randn((1, 60000, 4), generator=g, device=card), 0)
    tall = torch.randn((1, 60000, 3), generator=g, device=card)
    want = ggr_apply.apply_factors_plain(V, T, tall, 0)[0]
    got = ggr_apply.apply_factors(V[0], T[0], tall[0])
    assert _rel_err(got, want) <= rel_bound("apply_factors", 60000, 3, torch.float32)


@pytest.mark.gpu
def test_server_on_the_card_matches_the_cpu(card):
    reqs = serve_qr.make_workload(num=24, n=8, rows=4, k=1, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        srv = serve_qr.QRServer(device=dev)
        tickets = serve_qr._submit_all(srv, reqs)
        srv.flush()
        srv.drain()
        out[dev] = [serve_qr._as_tuple(srv.result(t)) for t in tickets]
    for a, b in zip(out["cpu"], out["cuda"]):
        for x, y in zip(a, b):
            assert y.device.type == "cuda"
            np.testing.assert_allclose(y.cpu().double().numpy(), x.double().numpy(),
                                       atol=1e-4 * max(1.0, float(x.abs().max())))


# ------------------------------------------- the instrumented slice on the card
@pytest.mark.gpu
def test_sketch_lstsq_on_the_card_matches_its_cpu_run(card):
    """The sketch QR runs the fused schedule's kernels on the card; the
    CountSketch sums every bucket in row order on both devices, so the sketch
    is the same bits, and the solve agrees with the CPU run."""
    from repro_torch import ranks

    g = torch.Generator().manual_seed(7)
    A = torch.randn((4096, 160), generator=g, dtype=torch.float64)
    A = A * torch.logspace(0, -6, 160, dtype=torch.float64)
    b = torch.randn(4096, generator=g, dtype=torch.float64)
    S_cpu = ranks.countsketch(A, 640, seed=3)
    S_card = ranks.countsketch(A.to(card), 640, seed=3)
    assert torch.equal(S_card.cpu(), S_cpu)
    assert torch.equal(ranks.countsketch(A.to(card), 640, seed=3), S_card)
    n0 = (ggr_panel.panel_factor.launches, ggr_apply.apply_factors.launches)
    fit = ranks.sketch_lstsq(A.to(card), b.to(card), iters=50, tol=1e-12, seed=3)
    assert ggr_panel.panel_factor.launches > n0[0]
    assert ggr_apply.apply_factors.launches > n0[1]
    ref = ranks.sketch_lstsq(A, b, iters=50, tol=1e-12, seed=3)
    assert fit.x.device.type == "cuda"
    np.testing.assert_allclose(fit.R.cpu().numpy(), ref.R.numpy(), rtol=0,
                               atol=1e-11 * float(ref.R.abs().max()))
    np.testing.assert_allclose(fit.x.cpu().numpy(), ref.x.numpy(), atol=1e-8, rtol=1e-5)
    assert float(fit.resid) == pytest.approx(float(ref.resid), rel=1e-8)
    again = ranks.sketch_lstsq(A.to(card), b.to(card), iters=50, tol=1e-12, seed=3)
    assert torch.equal(again.R, fit.R) and torch.equal(again.x, fit.x)


@pytest.mark.gpu
def test_factor_health_of_a_card_batch_copies_one_factor(card, monkeypatch):
    from repro_torch import obs
    from repro_torch.obs import health

    seen = []
    real = health.condition_estimate
    monkeypatch.setattr(health, "condition_estimate",
                        lambda R, iters=6: seen.append(R) or real(R, iters))
    g = torch.Generator(device=card).manual_seed(8)
    R = torch.triu(torch.randn((64, 12, 12), generator=g, device=card, dtype=torch.float64))
    R.diagonal(dim1=-2, dim2=-1).copy_(torch.linspace(1.0, 2.0, 12, device=card))
    R[37, 4, 4] = 1e-7  # the worst ratio
    with obs.collecting() as reg:
        obs.factor_health(R, "unit")
    assert len(seen) == 1 and seen[0].shape == (12, 12)
    assert torch.equal(seen[0], R[37])
    assert reg.find("unit.r_diag_min").value == pytest.approx(1e-7)
    cpu = obs.MetricsRegistry()
    with obs.collecting(cpu):
        obs.factor_health(R.cpu(), "unit")
    for name in ("r_diag_min", "r_diag_max", "r_cond_estimate"):
        assert reg.find(f"unit.{name}").value == cpu.find(f"unit.{name}").value


@pytest.mark.gpu
def test_device_timer_blocks_on_card_results(card):
    from repro_torch import obs

    x = torch.randn((2048, 2048), device=card)
    with obs.device_timer() as t:
        t.stop({"y": [x @ x]})
    assert t.blocked and t.seconds > 0.0
    assert obs.block_ready(x) is True and obs.block_ready(x.cpu()) is False


@pytest.mark.gpu
def test_guard_integrity_and_metrics_on_the_card(card, tmp_path):
    from repro_torch import obs, ranks, solvers

    rls = solvers.RecursiveLS(n=4, delta=1e-10)
    state = rls.init(torch.float64, device=card)
    rows = torch.as_tensor(np.random.default_rng(10).standard_normal((6, 4)), device=card)
    for r in rows:
        state = rls.observe(state, r, r.sum().reshape(1))
    bad = (1.5 / float(rls.residual_gram(state, rows[0]))) ** 0.5 * rows[0]
    kept = rls.forget(state, bad, bad.sum().reshape(1), guard=ranks.DowndateGuard(1e-6, "refuse"))
    assert torch.equal(kept.R, state.R) and torch.equal(kept.d, state.d)
    with obs.collecting() as reg:
        damped = rls.forget(state, bad, bad.sum().reshape(1), guard=ranks.DowndateGuard())
    assert bool(damped.R.isfinite().all())
    assert reg.find("solvers.downdate_guard_trips").value == 1
    with pytest.raises(FloatingPointError):
        rls.forget(state, bad, bad.sum().reshape(1), guard=ranks.DowndateGuard(mode="raise"))
    assert solvers.state_integrity(damped) == (True, "ok")
    assert not solvers.state_integrity(damped, max_cond=1.0)[0]
    cpu = state._replace(R=state.R.cpu(), d=state.d.cpu(), count=state.count.cpu())
    assert float(ranks.cond_estimate(state.R).cond) == pytest.approx(
        float(ranks.cond_estimate(cpu.R).cond), rel=1e-10)
    # the serving flush on the card under a collector records the contract
    reqs = serve_qr.make_workload(num=24, n=8, rows=4, k=1, device="cpu")
    srv = serve_qr.QRServer(device="cuda")
    with obs.collecting() as reg:
        serve_qr._submit_all(srv, reqs)
        srv.flush()
        srv.drain()
    assert obs.missing_families(obs.snapshot(reg)) == []
    assert reg.find("kernels.interpret_resolutions", mode="compiled").value >= 1


# -------------------------------------- the fault-tolerant slice on the card
def _bits(a, b) -> bool:
    a, b = serve_qr._as_tuple(a), serve_qr._as_tuple(b)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_resilient_server_equals_plain_on_the_card(card):
    reqs = serve_qr.make_workload(num=64, n=8, rows=4, k=1, device="cuda")
    plain = serve_qr.QRServer(device="cuda")
    resil = serve_qr.QRServer(device="cuda", resilient=True)
    out = {}
    for name, srv in (("plain", plain), ("resilient", resil)):
        n0 = ggr_update.batched_update.launches
        tickets = serve_qr._submit_all(srv, reqs)
        srv.flush()
        srv.drain()
        out[name] = ([srv.result(t) for t in tickets],
                     ggr_update.batched_update.launches - n0)
    assert out["plain"][1] == out["resilient"][1] > 0
    for a, b in zip(out["plain"][0], out["resilient"][0]):
        assert _bits(a, b)
    provs = resil._engine.dispatcher.provenance.values()
    assert {(p.rung, p.attempts) for ps in provs for p in ps} == {("native", 1)}


@pytest.mark.gpu
def test_nan_lane_through_the_kernel_is_quarantined(card):
    """precheck off: a NaN request runs through batched_update, its lane
    comes back non-finite, the post-check quarantines it, and the others
    (re-dispatched at the original padded width) keep their bits."""
    from repro_torch.serve import ContinuousBatcher, PoisonedError, ResilientDispatcher

    reqs = [r for r in serve_qr.make_workload(num=96, n=8, rows=4, k=1, device="cuda")
            if r[0] == "append" and len(r) == 5]
    bad = list(reqs)
    R = bad[5][1].copy()
    R[2, 3] = np.nan
    bad[5] = ("append", R, *bad[5][2:])
    res = {}
    for name, rs in (("clean", reqs), ("bad", bad)):
        eng = ContinuousBatcher(ResilientDispatcher(device="cuda", precheck=False,
                                                    max_batch=256))
        n0 = ggr_update.batched_update.launches
        tickets = [eng.submit(*r) for r in rs]
        eng.flush()
        res[name] = (eng, tickets, ggr_update.batched_update.launches - n0)
    assert res["bad"][2] == 2 and res["clean"][2] == 1  # the kernel ran it twice
    eng, tickets, _ = res["bad"]
    for i, (t, tc) in enumerate(zip(tickets, res["clean"][1])):
        if i == 5:
            with pytest.raises(PoisonedError):
                eng.result(t)
        else:
            assert _bits(eng.result(t), res["clean"][0].result(tc))


@pytest.mark.gpu
def test_real_out_of_memory_is_transient(card):
    from repro_torch.serve import classify_failure

    with pytest.raises(torch.OutOfMemoryError) as ei:
        torch.empty(1 << 50, dtype=torch.uint8, device=card)
    assert classify_failure(ei.value) == "transient"


@pytest.mark.gpu
def test_vault_restores_onto_the_card(card, tmp_path):
    from repro_torch import solvers
    from repro_torch.serve import IntegrityError, StateVault

    rls = solvers.RecursiveLS(n=6)
    state = rls.init(torch.float64, device=card)
    rows = torch.as_tensor(np.random.default_rng(11).standard_normal((12, 6)), device=card)
    vault = StateVault(root=str(tmp_path), interval=4, keep=3)
    saved = {}
    for i, r in enumerate(rows):
        state = rls.observe(state, r, r.sum().reshape(1))
        if vault.snapshot("rls", state):
            saved[i + 1] = state
    assert sorted(saved) == [4, 8, 12]
    newest = tmp_path / "rls" / "step_00000012" / "leaves.npz"
    with np.load(newest) as f:
        leaves = dict(f)
    leaves[".R"][0, 0] = np.nan
    np.savez(newest, **leaves)
    got, step = vault.restore_latest("rls", like=state)
    assert step == 8 and got.R.device.type == "cuda"
    for a, b in zip(got, saved[8]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for s in (4, 8):
        path = tmp_path / "rls" / f"step_{s:08d}" / "leaves.npz"
        with np.load(path) as f:
            leaves = dict(f)
        leaves[".d"][-1] = np.inf
        np.savez(path, **leaves)
    with pytest.raises(IntegrityError):
        vault.restore_latest("rls", like=state)


# --------------------------------------------- the sharded slice on the card
def _card_mesh():
    from repro_torch.parallel import BatchMesh

    return BatchMesh((torch.device("cuda", 0),) * 4)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 7, 67])
def test_sharded_append_on_the_card_is_bitwise(card, B):
    """Four shards on cuda:0: one B1 launch a shard, each problem's bits as
    in the single-device launch."""
    from repro_torch.solvers import qr_append_rows_batched

    g = torch.Generator(device=card).manual_seed(50 + B)
    R = torch.triu(torch.randn((B, 32, 32), generator=g, device=card))
    U, d, Y = (torch.randn(s, generator=g, device=card)
               for s in ((B, 8, 32), (B, 32, 1), (B, 8, 1)))
    n0 = batched_update.launches
    sharded = qr_append_rows_batched(R, U, d, Y, mesh=_card_mesh())
    assert batched_update.launches - n0 == 4
    assert _bits(sharded, qr_append_rows_batched(R, U, d, Y))


@pytest.mark.gpu
def test_sharded_kalman_on_the_card_is_bitwise(card):
    from repro_torch.solvers import kf_step_batched

    """B = 11 filters with shared models: 32 on the mesh, 16 alone."""
    g = torch.Generator(device=card).manual_seed(72)
    B, n, w, p = 11, 4, 2, 2
    R, d, F, H, z, G = (torch.randn(s, generator=g, device=card, dtype=torch.float64)
                        for s in ((B, n, n), (B, n), (n, n), (p, n), (B, p), (n, w)))
    R = torch.triu(R) + 2.0 * torch.eye(n, device=card, dtype=torch.float64)
    F = torch.eye(n, device=card, dtype=torch.float64) + 0.1 * F
    Qi = torch.eye(w, device=card, dtype=torch.float64)
    for dtype in (torch.float64, torch.float32):
        ops = [x.to(dtype) for x in (R, d, F, Qi, H, z, G)]
        assert _bits(kf_step_batched(*ops, mesh=_card_mesh()), kf_step_batched(*ops))


@pytest.mark.gpu
def test_sharded_server_on_the_card_is_bitwise(card):
    """A 19-request mix (odd groups: every one pads wider on the mesh):
    append and kalman bitwise, the lstsq kinds within 1e-6."""
    reqs = serve_qr.make_workload(num=19, n=6, rows=3, k=1, seed=53, device="cuda")
    out = {}
    for name, mesh in (("sharded", _card_mesh()), ("single", None)):
        srv = serve_qr.QRServer(device="cuda", mesh=mesh)
        tickets = serve_qr._submit_all(srv, reqs)
        assert srv.flush() == len(reqs)
        srv.drain()
        out[name] = [srv.result(t) for t in tickets]
    for r, a, b in zip(reqs, out["sharded"], out["single"]):
        if r[0] in ("append", "kalman"):
            assert _bits(a, b), r[0]
        else:
            for x, y in zip(a, b):
                torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


# ------------------------------------ the distributed slice on the card
def _card_rank_cases() -> dict:
    """On one of 2 gloo ranks: the three distributed functions on cuda:0
    tensors and on the same CPU tensors, and the B3/B4 launches the card
    calls made."""
    import torch.distributed as dist

    from repro_torch.core import distributed

    torch.cuda.set_device(0)
    P, r = dist.get_world_size(), dist.get_rank()
    gen = torch.Generator().manual_seed(61)
    A = torch.randn((256, 128), generator=gen, dtype=torch.float64)
    Bt = torch.randn((512, 64), generator=gen, dtype=torch.float64)
    perm, _ = distributed.cyclic_perm(128, P, 32)
    shards = {"logical": A[:, 64 * r:64 * (r + 1)],
              "cyclic": A[:, torch.as_tensor(perm[64 * r:64 * (r + 1)])]}
    rows = Bt[256 * r:256 * (r + 1)]
    out = {}
    launches = (ggr_panel.panel_factor.launches, ggr_apply.apply_factors.launches)
    for dev in ("cuda", "cpu"):
        for layout, X in shards.items():
            out[f"qr/{layout}/{dev}"] = distributed.distributed_ggr_qr_1d(
                X.to(dev), panel=32, layout=layout).cpu()
        out[f"tsqr/{dev}"] = distributed.tsqr(rows.to(dev)).cpu()
        out[f"orth/{dev}"] = distributed.distributed_orthogonalize(rows.to(dev)).cpu()
        if dev == "cuda":
            out["launches"] = (ggr_panel.panel_factor.launches - launches[0],
                               ggr_apply.apply_factors.launches - launches[1])
    return out


@pytest.mark.gpu
def test_distributed_functions_on_two_gloo_ranks_of_the_card(card):
    """Two gloo ranks share cuda:0: B3 and B4 launch in the ranks, and each
    result is the one the same ranks give on CPU tensors (plain versions)."""
    from repro_torch.testing.spawn import spawn_ranks

    for res in spawn_ranks(_card_rank_cases, 2, timeout_s=300):
        assert min(res["launches"]) > 0
        for key in ("qr/logical", "qr/cyclic", "tsqr", "orth"):
            got, want = res[f"{key}/cuda"], res[f"{key}/cpu"]
            assert (got - want).abs().max() <= 1e-10 * want.abs().max(), key


@pytest.mark.gpu
def test_orthant_step_on_the_card_matches_the_cpu(card):
    """One Orthant step on a (2, 512, 256) stack: the fused schedule's
    kernels against the port's own CPU run."""
    from repro_torch.optim import orthant

    gen = torch.Generator().manual_seed(62)
    params = {"w": torch.randn((2, 512, 256), generator=gen) * 0.05,
              "b": torch.randn(256, generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
    n0 = ggr_panel.panel_factor.launches
    out = {}
    for dev in ("cuda", "cpu"):
        p = {k: v.to(dev) for k, v in params.items()}
        new, state = orthant.update({k: v.to(dev) for k, v in grads.items()},
                                    orthant.init(p), p, lr=0.02)
        out[dev] = {k: v.cpu() for k, v in new.items()}
    assert ggr_panel.panel_factor.launches > n0
    for k in params:
        want = out["cpu"][k]
        assert (out["cuda"][k] - want).abs().max() <= 1e-4 * want.abs().max(), k


# ------------------------------------------------------------ the LM serving path
_LM_ARCHS = ("olmo-1b", "mixtral-8x22b", "zamba2-1.2b", "xlstm-125m",
             "phi-3-vision-4.2b", "seamless-m4t-large-v2")


def _lm_init(cfg, gen):
    from repro_torch.models import encdec, transformer

    init = encdec.init_encdec if cfg.family == "encdec" else transformer.init_lm
    return init(cfg, gen)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", _LM_ARCHS)
def test_lm_decode_matches_prefill_on_the_card(card, arch):
    """Smoke size at float32 compute: 24 decode steps against one prefill
    (the 16-slot SWA ring wraps; MoE drops no token), within 1e-4 of the
    logits' rms."""
    from repro_torch.configs import get_config
    from repro_torch.testing.lm_check import decode_vs_prefill, no_drop_f32

    cfg = no_drop_f32(get_config(arch, smoke=True))
    gen = torch.Generator(device=card).manual_seed(17)
    params = _lm_init(cfg, gen)
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=gen, device=card)
    frames = (torch.randn((2, 6, cfg.d_model), generator=gen, device=card)
              if cfg.family == "encdec" else None)
    with torch.inference_mode():
        assert decode_vs_prefill(cfg, params, toks, frames) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmo-1b", "zamba2-1.2b", "xlstm-125m", "arctic-480b"])
def test_lm_bf16_decode_on_the_card(card, arch):
    """8 decode steps at the default bfloat16 compute: finite logits and a
    cache of ``cache_spec``'s shapes and dtypes on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import serve

    cfg = get_config(arch, smoke=True)
    gen = torch.Generator(device=card).manual_seed(18)
    params = _lm_init(cfg, gen)
    cache = serve.init_cache(cfg, 2, 32, device=card)
    tok = torch.zeros((2,), dtype=torch.int32, device=card)
    with torch.inference_mode():
        for i in range(8):
            logits, cache = serve.decode_step(params, cache, tok, i, cfg)
            tok = logits.argmax(-1).int()
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all())
    for k, s in serve.cache_spec(cfg, 2, 32).items():
        assert tuple(cache[k].shape) == s.shape and cache[k].dtype == s.dtype
        assert cache[k].device.type == "cuda"


# ------------------------------------------------------------ the LM training path
def _train_case(arch="olmo-1b", seq=64, batch=4):
    """A smoke config at float32 compute and its CPU params and batch: 256
    uniform tokens, more distinct ones than the widths (128), so that an
    Orthant direction after one step is not set by roundoff (a momentum of
    lower rank; the synthetic stream's random walk visits fewer tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.testing.lm_check import no_drop_f32

    cfg = no_drop_f32(get_config(arch, smoke=True))
    g = torch.Generator().manual_seed(24)
    params = _lm_init(cfg, g)
    toks = torch.randint(0, cfg.vocab, (batch, seq + 1), generator=g, dtype=torch.int32)
    return cfg, params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_to(v, dev) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree.to(dev)


def _leaves(tree):
    from repro_torch.checkpoint.ckpt import _walk

    return {"/".join(p): x for p, x in _walk(tree)}


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["adamw", "orthant"])
def test_train_step_on_the_card_matches_the_cpu(card, optimizer):
    """One smoke olmo-1b ``train_step`` (float32 compute) on the card
    against the port's CPU run: loss and grad_norm within 1e-5 relative;
    each leaf's update (p0 - p1) / lr and each state leaf within 1e-4 of
    its rms of the CPU run's, over the elements the step determines
    (``repro_torch.testing.step_check``: AdamW where |m| >= 1e-3 of rms,
    Orthant's leading columns up to its momentum's rank), every parameter
    within 2.5·lr; Orthant launches the fused schedule's kernels, AdamW
    none."""
    from repro_torch.testing.step_check import (leading_columns, rms_gap, sign_determined,
                                                update_of)
    from repro_torch.train import make_train_step

    cfg, params, batch = _train_case()
    lr = 1e-3
    opt_init, step = make_train_step(cfg, optimizer=optimizer, lr=lr)
    out = {}
    n0 = ggr_apply.apply_factors.launches
    for dev in ("cuda", "cpu"):
        p = _to(params, dev)
        out[dev] = _to(step(p, opt_init(p), _to(batch, dev)), "cpu")
    launched = ggr_apply.apply_factors.launches - n0
    assert launched > 0 if optimizer == "orthant" else launched == 0
    for k in ("loss", "grad_norm"):
        want = float(out["cpu"][2][k])
        assert abs(float(out["cuda"][2][k]) - want) <= 1e-5 * abs(want), k
    p0, got, want = _leaves(params), _leaves(out["cuda"][0]), _leaves(out["cpu"][0])
    got_s, want_s = _leaves(out["cuda"][1]), _leaves(out["cpu"][1])
    gaps = {}
    for k, p in p0.items():
        mom = want_s[(".m/" if optimizer == "adamw" else ".momentum/") + k].numpy()
        mask = (leading_columns(mom)[0] if optimizer == "orthant" and p.ndim >= 2
                and min(p.shape[-2:]) > 1 else sign_determined(mom))
        gaps[k] = rms_gap(update_of(p0[k], got[k], lr), update_of(p0[k], want[k], lr), mask)
    for k in want_s:
        if not k.endswith(".step"):
            gaps[k] = rms_gap(got_s[k], want_s[k])
    worst = max(gaps.items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-4, worst
    for k in want:
        assert (got[k] - want[k]).abs().max() <= 2.5 * lr, k


@pytest.mark.gpu
def test_the_data_stream_has_the_same_bits_on_the_card(card):
    from repro_torch.data import SyntheticTokens

    data = SyntheticTokens(50304, 256, 8, seed=3)
    for step in (0, 1, 977):
        on_card, on_cpu = data.batch_at(step), data.batch_at(step, device="cpu")
        assert on_card["tokens"].device.type == "cuda"
        for k in on_cpu:
            assert torch.equal(on_card[k].cpu(), on_cpu[k]), (step, k)


@pytest.mark.gpu
def test_trainer_resumes_bitwise_on_the_card(card, tmp_path):
    """Smoke olmo-1b (bfloat16 compute) with Orthant: saved at step 2 and
    resumed by a new ``Trainer(resume=True)``, step 3 gives the same loss,
    params and optimizer state bits as the uninterrupted run."""
    from repro_torch.configs import get_config
    from repro_torch.train import Trainer

    cfg = get_config("olmo-1b", smoke=True)
    kw = dict(optimizer="orthant", seq_len=64, global_batch=4, lr=1e-3)
    whole = Trainer(cfg, **kw)
    want = whole.run(3)
    Trainer(cfg, ckpt_dir=str(tmp_path), ckpt_every=2, **kw).run(2)
    again = Trainer(cfg, ckpt_dir=str(tmp_path), resume=True, **kw)
    assert again.step_num == 2 and again.run(3) == want[2:]
    for a, b in ((whole.params, again.params), (whole.opt_state, again.opt_state)):
        b = _leaves(b)
        for k, x in _leaves(a).items():
            assert torch.equal(x, b[k]), k
    assert all(t["fwd_bwd_ms"] > 0 and t["opt_ms"] > 0 for t in again.step_times)


def _mesh_rank(shape, optimizer: str, steps: int) -> dict:
    """On a rank of a (data, model) mesh on cuda:0: smoke olmo-1b trained
    ``steps`` steps on 256 uniform tokens a step (float32 compute for a mesh
    of several ranks, the config's bfloat16 on 1x1) beside the one-device
    Trainer on this rank; each run's state after each step as global arrays
    on the host, and the mesh run's B3/B4 launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.testing.lm_check import no_drop_f32
    from repro_torch.testing.mesh_check import UniformBatches, flat_global
    from repro_torch.train import Trainer

    torch.cuda.set_device(0)
    cfg = get_config("olmo-1b", smoke=True)
    cfg = cfg if shape == (1, 1) else no_drop_f32(cfg)
    kw = dict(optimizer=optimizer, seq_len=32, global_batch=8, lr=1e-3)
    out = {}
    n0 = ggr_apply.apply_factors.launches
    for name, mesh in (("mesh", make_debug_mesh(*shape)), ("one", None)):
        tr = Trainer(cfg, mesh=mesh, **kw)
        tr.data = UniformBatches(cfg.vocab, 32, 8)
        out[name] = {"p0": flat_global(tr.params), "states": {}, "losses": []}
        for step in range(1, steps + 1):
            out[name]["losses"] += tr.run(step)
            out[name]["states"][step] = flat_global({"params": tr.params, "opt": tr.opt_state})
        if name == "mesh":
            out["launches"] = ggr_apply.apply_factors.launches - n0
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["adamw", "orthant"])
def test_a_1x1_nccl_mesh_is_bitwise_the_one_device_trainer(card, optimizer):
    """One NCCL rank: the mesh Trainer's losses and every leaf of its state
    after each step have the one-device Trainer's bits."""
    from repro_torch.testing.spawn import spawn_ranks

    res = spawn_ranks(_mesh_rank, 1, (1, 1), optimizer, 2, backend="nccl", timeout_s=300)[0]
    assert res["mesh"]["losses"] == res["one"]["losses"]
    for step in (1, 2):
        got, want = res["mesh"]["states"][step], res["one"]["states"][step]
        assert sorted(got) == sorted(want)
        assert [k for k in want if not np.array_equal(got[k], want[k])] == [], step
    assert (res["launches"] > 0) == (optimizer == "orthant")


@pytest.mark.gpu
def test_a_2x2_gloo_mesh_on_the_card_matches_one_device(card):
    """Four gloo ranks share cuda:0 (their all-gathers through
    ``parallel.collectives``): an Orthant step within the one-step rule of
    the one-device step, B3/B4 launched on every rank."""
    from repro_torch.testing.mesh_check import held_per_step
    from repro_torch.testing.spawn import spawn_ranks

    ranks = spawn_ranks(_mesh_rank, 4, (2, 2), "orthant", 1, timeout_s=600)
    assert all(r["launches"] > 0 for r in ranks)
    mesh, one = ranks[0]["mesh"], ranks[0]["one"]
    for step, r in held_per_step(one["p0"], mesh["states"], one["states"], 1e-3, "orthant"):
        assert r["update"][1] <= 1e-4 and r["state"][1] <= 1e-4, (step, r)
    assert np.allclose(mesh["losses"], one["losses"], rtol=1e-5)
