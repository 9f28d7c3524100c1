"""The CUDA kernels on the card: each held against its plain PyTorch version.

The card tests carry the ``gpu`` marker and skip without a CUDA device.  This
file imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import blocked
from repro_torch.kernels import _cuda, batched_geqrt, batched_update, ggr_qr_pallas
from repro_torch.kernels import ggr_apply, ggr_panel, ggr_update
from repro_torch.launch import serve_qr

# kernel vs plain version, each output on its own: the worst error over that
# output's rms (so one wrong row of a tall output shows) within rel_bound(),
# as in chip_smoke.py: a per-kernel, per-dtype constant (f32, f64) grown with
# the rows of a problem (B1, B2), the column steps an entry sees (B3) or the
# square root of the rows a suffix dot runs over (B4)
REL = {"batched_update": (7.5e-4, 1e-12), "batched_geqrt": (1e-3, 3e-12),
       "panel_factor": (3e-4, 3e-12), "apply_factors": (2e-4, 3e-13)}


def rel_bound(name, m, w, dtype):
    grow = {"batched_update": m / 64, "batched_geqrt": m / 64,
            "panel_factor": w / 64, "apply_factors": (m / 4096) ** 0.5}[name]
    return REL[name][dtype == torch.float64] * max(1.0, grow)


def _rel_err(got, want):
    rms = float(want.double().square().mean().sqrt())
    err = float((got - want).abs().max())
    return err / rms if rms > 0 else (0.0 if err == 0 else float("inf"))


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
    X[0] = 0
    return X


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,m,w,n_piv", [(2, 12, 9, 8), (67, 40, 33, 32),
                                         (7, 104, 65, 64), (5, 128, 192, 64),
                                         (2, 128, 192, 64), (32, 128, 192, 64),
                                         (3, 200, 65, 64), (2, 12, 1, 1),
                                         (2, 12, 1000, 8)])
def test_batched_update_kernel_matches_plain(card, dtype, B, m, w, n_piv):
    """Problem 0 is all zero and every other one random, so each case holds
    at least one real problem.  (2, 128, 192) is the tree's last coupling
    round (one problem) beside the zero one, (32, 128, 192) its first;
    (3, 200, 65) has p+1 = 137 active rows, (2, 12, 1) one pivot and one
    column, (2, 12, 1000) a width near the 1024 threads of a block."""
    g = torch.Generator(device=card).manual_seed(B + m)
    X = _stack(g, card, B, m, w, n_piv, dtype)
    n0 = batched_update.launches
    out = batched_update(X, n_piv)
    assert batched_update.launches == n0 + 1
    ref = ggr_update.batched_update_plain(X, n_piv)
    assert _rel_err(out, ref) <= rel_bound("batched_update", m, w, dtype)
    bits = out[0].view(torch.int32 if dtype == torch.float32 else torch.int64)
    assert bool((bits == 0).all())  # the zero problem comes back bitwise zero


@pytest.mark.gpu
@pytest.mark.parametrize("m,w,n_piv", [(40, 33, 32), (104, 65, 64), (128, 192, 64)])
def test_batched_update_result_does_not_depend_on_the_batch(card, m, w, n_piv):
    """40 problems at the serving append, serving kalman and tree-coupling
    shapes: each equals itself launched alone, bit for bit, wherever it sits
    in the batch (the serving and solver contracts of batched == sequential
    rest on this)."""
    g = torch.Generator(device=card).manual_seed(m + w)
    X = _stack(g, card, 40, m, w, n_piv, torch.float32)
    got = batched_update(X, n_piv)
    for i in range(40):
        assert torch.equal(got[i], batched_update(X[i:i + 1], n_piv)[0])
    assert torch.equal(got[7:20], batched_update(X[7:20], n_piv))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,t,w,n_piv", [(2, 8, 16, 8), (67, 64, 128, 64),
                                         (9, 20, 24, 16), (4, 12, 30, 16),
                                         (3, 65, 131, 65), (3, 128, 200, 128),
                                         (2, 33, 40, 0), (2, 24, 900, 24),
                                         (2, 1, 1, 1), (3, 300, 20, 20)])
def test_batched_geqrt_kernel_matches_plain(card, dtype, B, t, w, n_piv):
    """Tile 0 is all zero and comes back bitwise; 65 and 128 active rows put
    two and four rows on a lane of the coefficient warp; n_piv = 0 copies;
    900 columns give a thread two; 300 rows, more than the warp holds in
    registers (three passes through the records), with n_piv = w."""
    g = torch.Generator(device=card).manual_seed(B + t)
    X = torch.randn((B, t, w), generator=g, device=card, dtype=dtype)
    X[0] = 0
    n0 = batched_geqrt.launches
    out = batched_geqrt(X, n_piv)
    assert batched_geqrt.launches == n0 + 1
    ref = ggr_panel.batched_geqrt_plain(X, n_piv)
    assert _rel_err(out, ref) <= rel_bound("batched_geqrt", t, w, dtype)
    assert torch.equal(out[0], X[0])


def _tree_tiles(g, card, B, b, dtype):
    """[pan | I] tiles as the tree schedule builds them, the second half
    [0 | I] (row tiles past the matrix)."""
    pan = torch.randn((B, b, b), generator=g, device=card, dtype=dtype)
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
    return bool((x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)
                 == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
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
    two and three groups of the block's 256 threads.  Each of R, V, T is
    held on its own scale, its rms, so one wrong row of a tall panel shows."""
    g = torch.Generator(device=card).manual_seed(B + m + b)
    X = torch.randn((B + 1, m, b), generator=g, device=card, dtype=dtype)
    X[0] = 0
    n0 = ggr_panel.panel_factor.launches
    got = ggr_panel.panel_factor(X, pivot0=pivot0)
    assert ggr_panel.panel_factor.launches == n0 + 1
    want = ggr_panel.panel_factor_plain(X, pivot0)
    for a, w in zip(got, want):
        assert _rel_err(a, w) <= rel_bound("panel_factor", m, b, dtype)
        assert _bits_zero(a[0])  # the zero panel comes back bitwise zero


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,m,b,w,pivot0", [(1, 16, 4, 8, 0), (2, 96, 8, 45, 5),
                                            (1, 4096, 64, 300, 0),
                                            (2, 2000, 16, 70, 900),
                                            (1, 40, 8, 9, 35), (1, 8192, 8, 20, 0),
                                            (1, 700, 24, 37, 0), (2, 515, 33, 21, 3),
                                            (1, 400, 130, 10, 2)])
def test_apply_factors_kernel_matches_plain(card, dtype, B, m, b, w, pivot0):
    """b = 24 leaves lanes of the warp idle and b = 33 fills one stage of a
    lane's second pair; widths 37 and 21 end inside a block's columns and b =
    130 takes two launches (128 transforms each at most)."""
    g = torch.Generator(device=card).manual_seed(B + m + w)
    pans = torch.randn((B + 1, m, b), generator=g, device=card, dtype=dtype)
    pans[0] = 0
    _, V, T = ggr_panel.panel_factor_plain(pans, pivot0)
    C = torch.randn((B + 1, m, w), generator=g, device=card, dtype=dtype)
    C[0] = 0
    n0 = ggr_apply.apply_factors.launches
    got = ggr_apply.apply_factors(V, T, C, pivot0=pivot0)
    assert ggr_apply.apply_factors.launches == n0 + -(-b // 128)
    want = ggr_apply.apply_factors_plain(V, T, C, pivot0)
    assert _rel_err(got, want) <= rel_bound("apply_factors", m, w, dtype)
    assert _bits_zero(got[0])
    # in place on a strided view of a wider frame: the same values
    frame = torch.zeros((B + 1, m, w + 7), device=card, dtype=dtype)
    frame[:, :, 7:] = C
    view = frame[:, :, 7:]
    ggr_apply.apply_factors(V, T, view, pivot0=pivot0, out=view)
    assert torch.equal(view, got) and not frame[:, :, :7].any()


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


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(card):
    X = torch.zeros((2, 12, 9), device=card)
    for fn in (batched_update, batched_geqrt):
        with pytest.raises(NotImplementedError):
            fn(X, 8, precision="bf16")
        with pytest.raises(NotImplementedError):
            fn(X.half(), 8)
    big = torch.zeros((1, 240, 256), device=card, dtype=torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        batched_geqrt(big, 64)
    with pytest.raises(ValueError, match="threads"):
        batched_update(torch.zeros((1, 9, 1100), device=card), 8)
    pan = torch.zeros((64, 8), device=card)
    with pytest.raises(NotImplementedError):
        ggr_panel.panel_factor(pan, precision="bf16")
    with pytest.raises(NotImplementedError):
        ggr_panel.panel_factor(pan.to(torch.bfloat16))
    with pytest.raises(ValueError, match="shared memory"):  # no width limit but this
        ggr_panel.panel_factor(torch.zeros((4, 7000), device=card, dtype=torch.float64))
    with pytest.raises(NotImplementedError):
        ggr_apply.apply_factors(pan, pan, pan, precision="mixed_bf16")
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
