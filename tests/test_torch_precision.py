"""Mixed precision in the port on the CPU, held against the reference's
``tests/test_precision.py``: bf16 / f16 tiles with f32 accumulation through
the blocked schedules, the kernels' plain versions, the solvers, the
serving layer and a Kalman fleet, at small sizes and with no sharded case;
then the host side of the CUDA kernels' (tile, accumulation) pairs.

Tolerances: the reference's own budgets (``error_budget``, ``8 eps`` for a
served state, the NIS band), plus the port's distance from the JAX package
on the same inputs: 4 eps(dtype) relative Frobenius for the blocked R (read
at <= 1.3 eps on the reference's graded suite: the two round the state at
the same points and part where an f32 sum in another order rounds to the
other side of a tile value), 4e-3 of max(1, |ref|) for the f16 kernel
parity (the bf16 bound of ``tests/test_torch_kernels.py``, 3e-2, scaled by
f16's 8x smaller eps).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.blocked import ggr_triangularize_blocked as ggr_blocked_ref
from repro.kernels.ggr_panel import batched_geqrt_pallas
from repro.kernels.ggr_update import batched_update_pallas
from repro_torch.core.blocked import ggr_triangularize_blocked
from repro_torch.kernels import (Precision, _cuda, batched_geqrt, batched_update,
                                 panel_qr)
from repro_torch.kernels import ggr_apply, ggr_panel, ggr_update
from repro_torch.launch.serve_qr import QRServer
from repro_torch.launch.serve_qr import _submit_all as serve_qr_submit_all
from repro_torch.launch.serve_qr import make_workload as serve_qr_make_workload
from repro_torch.serve import Dispatcher
from repro_torch.solvers import qr_append_rows_batched
from repro_torch.testing import (budget_is_meaningful, dtype_eps, error_budget,
                                 factorization_errors, fleet_nis, graded_matrix,
                                 gram_residual, matrix_suite)

POLICIES = {"bf16": "bfloat16", "mixed_f16": "float16"}
PARITY_EPS = 4.0  # port vs reference blocked R, relative Frobenius, in eps(dtype)

_CASES = list(matrix_suite(shapes=((96, 80),), seed=7))
_EXTRA = list(matrix_suite(shapes=((64, 48),), conds=(1e0, 1e8), seed=21))


# ------------------------------------------------------------- graded suites

@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("schedule", ["tree", "fused"])
@pytest.mark.parametrize("case", _CASES + _EXTRA, ids=lambda c: c.name)
def test_blocked_mixed_meets_budgets(case, schedule, policy):
    """The reference's graded-suite test at bf16 and f16 tiles: R at the
    tile dtype, every meaningful metric within its budget and the gram
    residual always meaningful."""
    dt = POLICIES[policy]
    m, n = case.A.shape
    R = ggr_triangularize_blocked(torch.from_numpy(case.A).float(), tile=32,
                                  schedule=schedule, precision=policy)
    assert R.dtype == getattr(torch, dt)
    errs = factorization_errors(case.A, R.double().numpy(),
                                R_ref=np.linalg.qr(case.A)[1])
    for metric, value in errs.items():
        if budget_is_meaningful(dt, metric, m, n, case.cond):
            assert value < error_budget(dt, metric, m, n, case.cond), (metric, value)
    assert budget_is_meaningful(dt, "gram_residual", m, n, case.cond)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("schedule", ["tree", "fused"])
def test_blocked_mixed_matches_the_reference(schedule, policy):
    """The same f32 input through the JAX package's blocked schedule (its
    kernels in interpret mode) and the port's: R within PARITY_EPS eps
    relative Frobenius."""
    A = _CASES[0].A
    ref = ggr_blocked_ref(jnp.asarray(A, jnp.float32), tile=32, schedule=schedule,
                          precision=policy)
    ref = np.triu(np.asarray(ref.astype(jnp.float32), np.float64))
    got = ggr_triangularize_blocked(torch.from_numpy(A).float(), tile=32,
                                    schedule=schedule, precision=policy)
    got = np.triu(got.double().numpy())
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= PARITY_EPS * dtype_eps(POLICIES[policy]), rel


def test_mixed_accumulation_beats_all_bf16():
    """f32 sums are the point of the policy: an all-bf16 policy must be
    measurably worse (the reference's discrimination test)."""
    A = graded_matrix(96, 80, 1.0, seed=7)
    A32 = torch.from_numpy(A).float()
    mixed = gram_residual(A, ggr_triangularize_blocked(A32, precision="bf16").double())
    broken = gram_residual(A, ggr_triangularize_blocked(
        A32, precision=Precision("bfloat16", "bfloat16", "bfloat16")).double())
    assert mixed * 1.5 < broken, (mixed, broken)


# ------------------------------------------------------------- kernel layer

@pytest.mark.parametrize("policy", list(POLICIES))
def test_panel_qr_mixed_budget(policy):
    A = graded_matrix(64, 16, 1e2, seed=31)
    R, V, T = panel_qr(torch.from_numpy(A).float(), precision=policy)
    assert R.dtype == V.dtype == T.dtype == getattr(torch, POLICIES[policy])
    assert gram_residual(A, R.double()) < error_budget(POLICIES[policy],
                                                       "gram_residual", 64, 16)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_batched_geqrt_mixed_budget(policy):
    tiles = np.stack([graded_matrix(32, 16, 10.0 ** i, seed=40 + i) for i in range(4)])
    out = batched_geqrt(torch.from_numpy(tiles).float(), n_pivots=16, precision=policy)
    assert out.dtype == getattr(torch, POLICIES[policy])
    for b in range(4):
        assert gram_residual(tiles[b], out[b].double()) < error_budget(
            POLICIES[policy], "gram_residual", 32, 16), b


@pytest.mark.parametrize("policy", list(POLICIES))
def test_batched_update_mixed_budget(policy):
    rng = np.random.default_rng(50)
    n, p = 16, 8
    stacked = np.stack([
        np.concatenate([np.triu(rng.standard_normal((n, n))) + 2 * np.eye(n),
                        rng.standard_normal((p, n))])
        for _ in range(3)])
    out = batched_update(torch.from_numpy(stacked).float(), n_pivots=n, precision=policy)
    assert out.dtype == getattr(torch, POLICIES[policy])
    for b in range(3):
        assert gram_residual(stacked[b], out[b].double()) < error_budget(
            POLICIES[policy], "gram_residual", n + p, n), b


@pytest.mark.parametrize("policy", list(POLICIES))
def test_qr_append_mixed_carries_compute_dtype(policy):
    rng = np.random.default_rng(60)
    B, n, p = 5, 8, 3
    Rb = torch.from_numpy(np.triu(rng.standard_normal((B, n, n))) + 2 * np.eye(n)).float()
    Ub = torch.from_numpy(rng.standard_normal((B, p, n))).float()
    Rn = qr_append_rows_batched(Rb, Ub, precision=policy)
    dt = POLICIES[policy]
    assert Rn.dtype == getattr(torch, dt)
    Rf = qr_append_rows_batched(Rb, Ub)
    for b in range(B):
        stacked = np.concatenate([Rb[b].numpy(), Ub[b].numpy()])
        assert gram_residual(stacked, Rn[b].double()) < error_budget(
            dt, "gram_residual", n + p, n), b
    rel = float(torch.linalg.norm(Rn.double() - Rf.double()) / torch.linalg.norm(Rf.double()))
    assert rel < 8 * dtype_eps(dt)


def _update_stack(rng, B, n_piv, p, w):
    X = rng.standard_normal((B, n_piv + p, w))
    X[:, :n_piv, :n_piv] = np.triu(X[:, :n_piv, :n_piv])
    X[0] = 0.0
    return X.astype(np.float32)


@pytest.mark.parametrize("which", ["update", "geqrt"])
def test_f16_plain_versions_match_the_jax_kernels(which):
    """batched_update / batched_geqrt at f16 tiles with f32 sums: the plain
    versions against the JAX kernels in interpret mode, the same policy on
    both sides, the zero problem bitwise zero (bf16:
    tests/test_torch_kernels.py)."""
    policy, tol = "f16", 4e-3
    rng = np.random.default_rng(3)
    if which == "update":
        X, n_piv = _update_stack(rng, 7, 8, 4, 9), 8
        ref = batched_update_pallas(jnp.asarray(X), n_piv, interpret=True,
                                    precision=policy)
        out = batched_update(torch.from_numpy(X), n_piv, precision=policy)
    else:
        X = rng.standard_normal((7, 8, 16)).astype(np.float32)
        X[0] = 0.0
        n_piv = 8
        ref = batched_geqrt_pallas(jnp.asarray(X), n_piv, interpret=True,
                                   precision=policy)
        out = batched_geqrt(torch.from_numpy(X), n_piv, precision=policy)
    assert out.dtype == torch.float16
    ref = np.asarray(ref.astype(jnp.float32))
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol * scale)
    assert not out[0].any()


# ------------------------------------------------------------------ serving

def test_bf16_storage_doubles_dispatch_block():
    d = Dispatcher(block_b=8, device="cpu")
    assert d.block_b_for("float32") == 8
    assert d.block_b_for("bfloat16") == 16
    assert d.block_b_for("float16") == 16
    assert d.padded_chunk(3, "append", "bfloat16") == 16
    assert d.padded_chunk(17, "append", "bfloat16") == 32


@pytest.mark.parametrize("policy", [None, "f32", "bf16"])
def test_server_bf16_storage_round_trip(policy):
    """bf16 (R, d) states come back as bf16 whatever the compute policy, and
    within 8 eps(bf16) of the f32-served state (the reference's rule)."""
    rng = np.random.default_rng(70)
    n, p = 8, 3
    R = np.triu(rng.standard_normal((n, n))) + 2 * np.eye(n)
    U = rng.standard_normal((p, n))
    server = QRServer(device="cpu", precision=policy)
    t16 = server.submit_append(torch.from_numpy(R).bfloat16(),
                               torch.from_numpy(U).bfloat16())
    t32 = server.submit_append(R.astype(np.float32), U.astype(np.float32))
    server.flush()
    server.drain()
    R16, R32 = server.result(t16), server.result(t32)
    assert R16.dtype == torch.bfloat16 and R32.dtype == torch.float32
    rel = float(torch.linalg.norm(R16.double() - R32.double())
                / torch.linalg.norm(R32.double()))
    assert rel < 8 * dtype_eps("bfloat16"), rel


# ------------------------------------------------------------------- kalman

def test_kalman_fleet_bf16_nis_consistent():
    """A bf16-state fleet stays innovation-consistent: each mean NIS within
    (0.7 p, 1.3 p), the reference's band and case (B=4, T=100, seed 3)."""
    p = 2
    nis = fleet_nis(B=4, n=4, w=4, p=p, T=100, seed=3, precision="bf16", device="cpu")
    assert np.all(0.7 * p < nis) and np.all(nis < 1.3 * p), nis


# ------------------------------------------------- the CUDA kernels' pairs

@pytest.mark.parametrize("tile,accum,suffix,source", [
    (torch.bfloat16, "float32", "bf16_f32", None),
    (torch.float16, torch.float32, "f16_f32", None),
    (torch.float32, None, "f32", None), (torch.float32, "float32", "f32", None),
    (torch.float64, "float64", "f64", None),
    (torch.float32, "float64", "f32_f64", "ggr_update"),
    (torch.bfloat16, torch.float64, "bf16_f64", "ggr_update"),
    (torch.float16, "float64", "f16_f64", "ggr_panel"),
    (torch.float32, "float64", "f32_f64", "ggr_panel_factor"),
    (torch.bfloat16, torch.float64, "bf16_f64", "ggr_panel_factor"),
    (torch.float16, "float64", "f16_f64", "ggr_panel_factor"),
    (torch.float32, torch.float64, "f32_f64", "ggr_apply"),
    (torch.bfloat16, "float64", "bf16_f64", "ggr_apply"),
    (torch.float16, torch.float64, "f16_f64", "ggr_apply"),
    (torch.bfloat16, torch.bfloat16, "bf16", "ggr_update"),
    (torch.bfloat16, "bfloat16", "bf16", "ggr_panel"),
    (torch.float16, None, "f16", "ggr_update"),
    (torch.float16, "float16", "f16", "ggr_panel")])
def test_cuda_suffix_of_each_pair(tile, accum, suffix, source):
    """Every source has the same seven pairs, the wide ones (f64 sums)
    included, and B1's and B2's sources also the narrow ones (bf16 / f16
    tiles summed at their own width): the C functions' suffix, and the
    check of the wrapper of ``source`` (None: every wrapper) admits the
    pair."""
    assert _cuda.suffix(tile, accum) == suffix
    wrappers = {"ggr_update": ["batched_update"], "ggr_panel": ["batched_geqrt"],
                "ggr_panel_factor": ["panel_factor"], "ggr_apply": ["apply_factors"],
                None: ["batched_update", "batched_geqrt", "panel_factor", "apply_factors"]}
    for fn in wrappers[source]:
        ggr_panel._kernel_dtype_check(torch.zeros(2, dtype=tile), accum, fn)


@pytest.mark.parametrize("tile,accum", [
    pytest.param(torch.bfloat16, None, id="tile3-None"),
    pytest.param(torch.float16, "float16", id="tile4-float16"),
    pytest.param(torch.float64, "float32", id="tile5-float32")])
def test_pairs_without_a_kernel_raise_naming_both_dtypes(tile, accum):
    """f64 tiles with f32 sums have no CUDA kernel: the binding and every
    wrapper's check raise NotImplementedError naming both dtypes.  bf16 /
    f16 tiles summed at their own width have one in B1 and B2 only: their
    wrappers' checks pass and resolve the C entry point (suffix "bf16" /
    "f16"), and B3's and B4's raise, naming both dtypes and the kernels
    that take the pair."""
    acc = str(accum or tile).removeprefix("torch.")
    what = f"{str(tile).removeprefix('torch.')} tiles with {acc} accumulation"
    narrow = tile in (torch.bfloat16, torch.float16)
    if narrow:
        for fn in ("batched_update", "batched_geqrt"):
            ggr_panel._kernel_dtype_check(torch.zeros(2, dtype=tile), accum, fn)
            assert _cuda.suffix(tile, accum, ggr_panel._SOURCE[fn]) == {
                "bfloat16": "bf16", "float16": "f16"}[acc]
        raising = ("panel_factor", "apply_factors")
    else:
        with pytest.raises(NotImplementedError, match=what):
            _cuda.suffix(tile, accum)
        raising = ("batched_update", "batched_geqrt", "panel_factor", "apply_factors")
    for fn in raising:
        with pytest.raises(NotImplementedError,
                           match=f"{fn}: no CUDA kernel for {what}") as err:
            ggr_panel._kernel_dtype_check(torch.zeros(2, dtype=tile), accum, fn)
        if narrow:
            assert "batched_update and batched_geqrt also take" in str(err.value)


class _OnTheCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, so a wrapper's host
    side (its checks, layout, buffers) runs here up to the launch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture
def launches(monkeypatch):
    """The CUDA binding stubbed out: each launch is recorded as (C function
    prefix, the dtypes of its tensors, its integer arguments, its accum),
    each capacity query answers as 132 SMs of 8 blocks would, and buffers
    asked for on the card are made on the CPU."""
    calls = []
    empty = torch.empty

    def launch(source, prefix, tensors, *dims, accum=None):
        _cuda.suffix(tensors[0].dtype, accum, source)  # the pair has a C entry point
        calls.append((prefix, [t.dtype for t in tensors], dims, accum))

    def query(source, prefix, x, smem, accum=None):
        calls.append((prefix, [x.dtype], (smem,), accum))
        return 132 * min(8, _cuda.MAX_SMEM_BYTES // max(smem, 1))

    monkeypatch.setattr(_cuda, "launch", launch)
    monkeypatch.setattr(_cuda, "query", query)
    monkeypatch.setattr(ggr_panel, "_CAPACITY", {})
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k: empty(*a, **k))
    return calls


@pytest.mark.parametrize("tile", [torch.bfloat16, torch.float16])
def test_a_mixed_tile_is_launched_with_the_layout_of_an_f32_tile(tile, launches):
    """The kernels hold the state and the sums in shared memory at the
    accumulation dtype, so each wrapper lays out a bf16 / f16 tile with f32
    sums as an f32 tile, not by its 2-byte storage: at shapes where the two
    differ, B1's (G, PB, ws, nbuf), B2's (G, ws) and B3's (blocks,
    resident) are the f32 ones, B3's capacity query and scratch and B4's
    coefficients are f32, and each launch names the (tile, float32) pair."""
    def on_card(*shape):
        return torch.Tensor._make_subclass(_OnTheCard, torch.zeros(shape, dtype=tile))

    m, w, n_piv = 600, 9, 8
    assert ggr_update._update_layout(m, w, n_piv, 2) != ggr_update._update_layout(
        m, w, n_piv, 4)
    ggr_update._batched_update_cuda(on_card(2, m, w), n_piv, "float32")
    prefix, dtypes, dims, accum = launches.pop()
    assert (prefix, dtypes, accum) == ("ggr_batched_update", [tile, tile], "float32")
    assert dims[4:] == ggr_update._update_layout(m, w, n_piv, 4)

    t, w = 120, 480
    assert ggr_panel._geqrt_layout(t, w, 2) != ggr_panel._geqrt_layout(t, w, 4)
    ggr_panel._batched_geqrt_cuda(on_card(2, t, w), t, "float32")
    prefix, dtypes, dims, accum = launches.pop()
    assert (prefix, dtypes, accum) == ("ggr_batched_geqrt", [tile, tile], "float32")
    assert dims[4:] == ggr_panel._geqrt_layout(t, w, 4)

    m, b = 140000, 64
    launches.clear()
    ggr_panel._panel_factor_cuda(on_card(1, m, b), 0, "float32")
    *queries, (prefix, dtypes, dims, accum) = launches
    assert queries and all(q[1:] == ([tile], q[2], "float32") for q in queries)
    assert (prefix, dtypes, accum) == ("ggr_panel_factor", [tile] * 4 + [torch.float32],
                                       "float32")

    def capacity(smem):
        return 132 * min(8, _cuda.MAX_SMEM_BYTES // max(smem, 1))

    assert ggr_panel._panel_blocks(m, b, 2, capacity) != ggr_panel._panel_blocks(
        m, b, 4, capacity)
    assert (dims[4], bool(dims[5])) == ggr_panel._panel_blocks(m, b, 4, capacity)

    launches.clear()
    V = on_card(1, 300, 16)
    ggr_apply._apply_factors_cuda(V, V, on_card(1, 300, 40), 0, "float32", None)
    (prefix, dtypes, dims, accum), = launches
    assert (prefix, dtypes, accum) == ("ggr_apply_factors", [tile] * 4 + [torch.float32],
                                       "float32")


@pytest.mark.parametrize("tile", [torch.float32, torch.bfloat16, torch.float16])
def test_a_wide_pair_is_launched_with_the_layout_of_an_f64_tile(tile, launches):
    """f64 sums: every kernel lays a tile out as an f64 tile (shared memory
    and scratch at 8 bytes a value) and launches the (tile, float64)
    instance: B1's and B2's layouts, B3's (blocks, resident) and scratch
    those of an f64 panel of the same shape, its capacity queried at the
    pair, B4's coefficients in f64; a B2 tile that fits at 4 bytes but not
    at 8 raises the ValueError naming the bytes, with no launch."""
    def on_card(*shape, dtype=tile):
        return torch.Tensor._make_subclass(_OnTheCard, torch.zeros(shape, dtype=dtype))

    m, w, n_piv = 600, 9, 8
    assert ggr_update._update_layout(m, w, n_piv, 8) != ggr_update._update_layout(
        m, w, n_piv, 4)
    ggr_update._batched_update_cuda(on_card(2, m, w), n_piv, "float64")
    prefix, dtypes, dims, accum = launches.pop()
    assert (prefix, dtypes, accum) == ("ggr_batched_update", [tile, tile], "float64")
    assert dims[4:] == ggr_update._update_layout(m, w, n_piv, 8)

    t, w = 64, 128
    ggr_panel._batched_geqrt_cuda(on_card(2, t, w), t, "float64")
    prefix, dtypes, dims, accum = launches.pop()
    assert (prefix, dtypes, accum) == ("ggr_batched_geqrt", [tile, tile], "float64")
    assert dims[4:] == ggr_panel._geqrt_layout(t, w, 8)
    t, w = 100, 300
    assert ggr_panel._geqrt_layout(t, w, 4) and not ggr_panel._geqrt_layout(t, w, 8)
    with pytest.raises(ValueError, match=f"needs {ggr_panel._geqrt_smem(t, w, 8)} bytes"):
        ggr_panel._batched_geqrt_cuda(on_card(2, t, w), t, "float64")
    assert not launches

    # a frame whose slabs fit in shared memory at 4 bytes a value, not at 8
    m, b = 65536, 64

    def capacity(smem):
        return 132 * min(8, _cuda.MAX_SMEM_BYTES // max(smem, 1))

    assert ggr_panel._panel_blocks(m, b, 4, capacity) != ggr_panel._panel_blocks(
        m, b, 8, capacity)
    ggr_panel._panel_factor_cuda(on_card(1, m, b, dtype=torch.float64), 0, None)
    *_, (_, _, f64_dims, _) = launches
    launches.clear()
    ggr_panel._panel_factor_cuda(on_card(1, m, b), 0, "float64")
    *queries, (prefix, dtypes, dims, accum) = launches
    assert queries and all(q[1:] == ([tile], q[2], "float64") for q in queries)
    assert (prefix, dtypes, accum) == ("ggr_panel_factor", [tile] * 4 + [torch.float64],
                                       "float64")
    nblk, resident = dims[4], bool(dims[5])
    assert (nblk, resident) == ggr_panel._panel_blocks(m, b, 8, capacity)
    assert dims[:6] == f64_dims[:6] and dims[7] == f64_dims[7]  # same blocks and capacity
    # the scratch: an f64 panel's, and the slabs (R holds the tile dtype)
    assert dims[6] == ggr_panel._work_elems(m, b, nblk, resident, True) == (
        f64_dims[6] + (0 if resident else m * b))

    launches.clear()
    V = on_card(1, 300, 16)
    ggr_apply._apply_factors_cuda(V, V, on_card(1, 300, 40), 0, "float64", None)
    (prefix, dtypes, dims, accum), = launches
    assert (prefix, dtypes, accum) == ("ggr_apply_factors", [tile] * 4 + [torch.float64],
                                       "float64")


@pytest.fixture
def routed(launches, monkeypatch):
    """``launches``, with each kernel's plain version, when a wrapper runs
    it on a CPU tensor, first taking the same tensor reported on the card
    through the wrapper's CUDA host side (its checks, layout and the stubbed
    launch): a CPU run of a path records the launches the card would make,
    and goes on with the plain version's results.  The launch counts and
    shape records are restored after the test."""
    def via_card(mod, plain_name, cuda_fn):
        plain = getattr(mod, plain_name)

        def routed_plain(*args):
            card = [torch.Tensor._make_subclass(_OnTheCard, a)
                    if isinstance(a, torch.Tensor) else a for a in args]
            if mod is ggr_apply:
                cuda_fn(*card, None)  # out=None
            else:
                cuda_fn(*card)
            return plain(*args)

        monkeypatch.setattr(mod, plain_name, routed_plain)

    for fn in (batched_update, batched_geqrt, ggr_panel.panel_factor,
               ggr_apply.apply_factors):
        monkeypatch.setattr(fn, "launches", fn.launches)
        monkeypatch.setattr(fn, "shapes", set())
    via_card(ggr_update, "batched_update_plain", ggr_update._batched_update_cuda)
    via_card(ggr_panel, "batched_geqrt_plain", ggr_panel._batched_geqrt_cuda)
    via_card(ggr_panel, "panel_factor_plain", ggr_panel._panel_factor_cuda)
    via_card(ggr_apply, "apply_factors_plain", ggr_apply._apply_factors_cuda)
    return launches


@pytest.mark.parametrize("tile", [torch.bfloat16, torch.float16])
def test_a_narrow_pair_launches_only_b1_and_b2(tile, routed):
    """At Precision(t, t, t) the tree QR launches B2 and B1 only, and a
    QRServer flush of appends and kalman steps stored at t launches B1
    only, every launch the C function of the (t, t) pair (suffix "bf16" /
    "f16"), laid out as a narrow instance: 4-byte values and the suffix-dot
    scratch."""
    dn = str(tile).removeprefix("torch.")
    sfx = {"bfloat16": "bf16", "float16": "f16"}[dn]
    prec = Precision(dn, dn, dn)

    def held(records, prefixes):
        assert {r[0] for r in records} == set(prefixes), records
        for prefix, dtypes, dims, accum in records:
            source = "ggr_update" if prefix == "ggr_batched_update" else "ggr_panel"
            assert dtypes == [tile, tile] and accum == dn
            assert _cuda.suffix(tile, accum, source) == sfx
            B, m, w, n_piv, *layout = dims
            want = (ggr_update._update_layout(m, w, n_piv, 4, True) if source == "ggr_update"
                    else ggr_panel._geqrt_layout(m, w, 4, True))
            assert tuple(layout) == want

    A = torch.from_numpy(graded_matrix(96, 80, 1.0, seed=7)).float()
    R = ggr_triangularize_blocked(A, schedule="tree", precision=prec)
    assert R.dtype == tile
    held(routed, ("ggr_batched_geqrt", "ggr_batched_update"))
    routed.clear()

    reqs = [(r[0], *(torch.as_tensor(x).to(tile) for x in r[1:]))
            for r in serve_qr_make_workload(num=24, n=8, rows=4, k=1, device="cpu")
            if r[0] in ("append", "kalman")]
    srv = QRServer(device="cpu", precision=prec)
    tickets = serve_qr_submit_all(srv, reqs)
    srv.flush()
    srv.drain()
    assert all(srv.result(t)[0].dtype == tile for t in tickets)
    held(routed, ("ggr_batched_update",))


def test_a_mixed_panel_in_device_memory_keeps_its_slabs_in_the_scratch():
    """The panel kernel's scratch (mirrors work_size in the CUDA source): a
    mixed panel whose slabs live in device memory keeps them in the scratch
    too (R holds the tile dtype), m * b values more; resident slabs cost
    nothing more."""
    m, b, nblk = 140000, 64, 200
    for resident in (True, False):
        base = ggr_panel._work_elems(m, b, nblk, resident, False)
        extra = ggr_panel._work_elems(m, b, nblk, resident, True) - base
        assert extra == (0 if resident else m * b)
    assert ggr_panel._work_elems(m, b, nblk, True, False) == 2 * b * m + nblk * (2 * b + 4)


def gram_readings(sizes) -> None:
    """``python tests/test_torch_precision.py gram N ...``: the gram residual
    of an N x N f32 Gaussian (numpy seed 0) factored at bf16 / f16 tiles
    with f32 sums under each schedule, by the JAX package (its kernels in
    interpret mode) and by the port (its plain versions): whether a gap
    between the schedules is the algorithm's."""
    import sys
    import time

    for n in sizes:
        A = np.random.default_rng(0).standard_normal((n, n)).astype(np.float32)
        for policy in POLICIES:
            row = []
            for schedule in ("fused", "tree"):
                t0 = time.perf_counter()
                ref = ggr_blocked_ref(jnp.asarray(A), tile=64, schedule=schedule,
                                      precision=policy)
                ref = np.asarray(ref.astype(jnp.float32), np.float64)
                got = ggr_triangularize_blocked(torch.from_numpy(A), tile=64,
                                                schedule=schedule, precision=policy)
                row.append(f"{schedule} JAX {gram_residual(A, ref):.3e} port "
                           f"{gram_residual(A, got.double().numpy()):.3e}")
                print(f"  ({time.perf_counter() - t0:.1f} s)", file=sys.stderr)
            print(f"{n}x{n} {policy}: " + "; ".join(row), flush=True)


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["gram"]:
        gram_readings([int(v) for v in sys.argv[2:]])
