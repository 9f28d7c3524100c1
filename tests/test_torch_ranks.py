"""Port parity: ranks.monitor (condition estimates, the downdate guard),
solvers.state_integrity and ranks.sketch against the JAX package on the same
numpy inputs, at f64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ranks as jranks
import repro.solvers as jsolvers
from repro import obs as jobs
from repro.solvers.lstsq import state_integrity as jstate_integrity
from repro.testing import graded_matrix
from repro_torch import obs, ranks, solvers


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


# ------------------------------------------------------- condition monitor
@pytest.mark.parametrize("cond", [1e2, 1e6])
def test_cond_estimate_equals_the_reference(cond):
    R = np.linalg.qr(graded_matrix(48, 16, cond, seed=8), mode="r")
    for iters in (1, 4, 8):
        ours = ranks.cond_estimate(_t(R), iters=iters)
        ref = jranks.cond_estimate(jnp.asarray(R), iters=iters)
        for f in ("cond", "smax", "smin"):
            assert _rel(getattr(ours, f), getattr(ref, f)) <= 1e-10, (f, iters)
        np.testing.assert_allclose(ours.vmin.numpy(), np.asarray(ref.vmin), atol=1e-10)
    truth = np.linalg.cond(R)
    assert 0.5 * truth <= float(ranks.cond_estimate(_t(R), iters=8).cond) <= 1.05 * truth


def test_cond_estimate_incremental_carry_equals_the_reference():
    R = np.linalg.qr(graded_matrix(48, 16, 1e4, seed=9), mode="r")
    full, jfull = ranks.cond_estimate(_t(R), iters=8), jranks.cond_estimate(jnp.asarray(R), iters=8)
    # the carry moves to a refreshed factor (one appended row)
    R2 = np.linalg.qr(np.vstack([R, np.random.default_rng(9).standard_normal(16)]), mode="r")
    warm = ranks.cond_estimate(_t(R2), state=full, iters=1)
    jwarm = jranks.cond_estimate(jnp.asarray(R2), state=jfull, iters=1)
    assert _rel(warm.cond, jwarm.cond) <= 1e-10
    # one refresh round on the same factor stays at the full estimate
    same = ranks.cond_estimate(_t(R), state=full, iters=1)
    assert float(same.cond) == pytest.approx(float(full.cond), rel=1e-2)


def test_cond_estimate_of_a_singular_factor_equals_the_reference():
    R = np.diag([1.0, 1e-3, 0.0])
    ours, ref = ranks.cond_estimate(_t(R), iters=4), jranks.cond_estimate(jnp.asarray(R), iters=4)
    assert np.isfinite(float(ours.cond)) and float(ours.cond) > 1e6
    assert _rel(ours.cond, ref.cond) <= 1e-10


def test_batch_cond_estimate_equals_the_reference():
    Rb = np.stack([np.linalg.qr(graded_matrix(20, 8, c, seed=3), mode="r")
                   for c in (1e1, 1e3, 1e5)] + [np.diag([1.0, 0.5, 0.0, 1, 1, 1, 1, 1])])
    ours = ranks.batch_cond_estimate(_t(Rb)).numpy()
    ref = np.asarray(jranks.batch_cond_estimate(jnp.asarray(Rb)))
    np.testing.assert_allclose(ours, ref, rtol=1e-10)
    # the batched pass equals per-factor calls
    for i in range(len(Rb)):
        assert float(ranks.cond_estimate(_t(Rb[i])).cond) == pytest.approx(ours[i], rel=1e-12)


def test_condition_monitor_records_and_alarms():
    mon, jmon = (ranks.ConditionMonitor(layer="rls", alarm_cond=1e3, iters=8),
                 jranks.ConditionMonitor(layer="rls", alarm_cond=1e3, iters=8))
    steps = (np.diag([1.0, 0.5, 0.25]), np.diag([1.0, 0.5, 1e-5]), np.diag([1.0, 0.5, 0.4]))
    with obs.collecting() as reg, jobs.collecting() as jreg:
        got = [mon.observe(_t(R)) for R in steps]
        want = [jmon.observe(jnp.asarray(R)) for R in steps]
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert got[0] < 1e3 < got[1]
    assert mon.alarms == jmon.alarms == 1
    assert reg.find("rls.cond_estimate").value == pytest.approx(got[-1])
    assert reg.find("rls.cond_alarms").value == jreg.find("rls.cond_alarms").value == 1
    assert reg.find("rls.smin_estimate").value == pytest.approx(
        jreg.find("rls.smin_estimate").value, rel=1e-10)


# --------------------------------------------------------- downdate guard
def _rls_near_cliff(pkg, to):
    """An RLS window plus a row whose removal would cross the rank cliff:
    scaled so its leverage ||R^-T u||^2 lands at exactly 1.5 > 1 (the
    reference's own construction)."""
    rls = pkg.RecursiveLS(n=3, delta=1e-10)
    state = (rls.init(torch.float64, device="cpu") if pkg is solvers
             else rls.init(jnp.float64))
    rows = np.random.default_rng(10).standard_normal((4, 3))
    for r in rows:
        state = rls.observe(state, to(r), to(np.asarray(r.sum())))
    lev = float(rls.residual_gram(state, to(rows[0])))
    return rls, state, rows, np.sqrt(1.5 / lev) * rows[0]


@pytest.mark.parametrize("mode", ["damp", "refuse"])
def test_guarded_forget_equals_the_reference(mode):
    rls, state, rows, bad = _rls_near_cliff(solvers, _t)
    jrls, jstate, _, jbad = _rls_near_cliff(jsolvers, jnp.asarray)
    np.testing.assert_allclose(bad, jbad, rtol=1e-12)
    guard, jguard = ranks.DowndateGuard(1e-6, mode), jranks.DowndateGuard(1e-6, mode)
    with obs.collecting() as reg:
        out = rls.forget(state, _t(bad), _t(bad.sum()), guard=guard)
    jout = jrls.forget(jstate, jnp.asarray(bad), jnp.asarray(bad.sum()), guard=jguard)
    np.testing.assert_allclose(out.R.numpy(), np.asarray(jout.R), atol=1e-10, rtol=1e-10)
    np.testing.assert_allclose(out.d.numpy(), np.asarray(jout.d), atol=1e-8, rtol=1e-8)
    assert reg.find("solvers.downdate_guard_trips").value == 1
    if mode == "refuse":  # the state comes back bit for bit
        assert torch.equal(out.R, state.R) and torch.equal(out.d, state.d)
    else:
        smin = np.linalg.svd(out.R.numpy(), compute_uv=False).min()
        assert np.isfinite(out.R.numpy()).all() and smin > 1e-12


def test_guard_raise_mode_and_inert_on_safe_downdates():
    rls, state, rows, bad = _rls_near_cliff(solvers, _t)
    with pytest.raises(FloatingPointError, match="rank cliff"):
        rls.forget(state, _t(bad), _t(bad.sum()), guard=ranks.DowndateGuard(1e-6, "raise"))
    for mode in ("damp", "refuse", "raise"):
        with obs.collecting() as reg:
            a = rls.forget(state, _t(rows[0]), _t(rows[0].sum()),
                           guard=ranks.DowndateGuard(1e-6, mode))
        b = rls.forget(state, _t(rows[0]), _t(rows[0].sum()))
        assert torch.equal(a.R, b.R) and torch.equal(a.d, b.d)
        assert reg.find("solvers.downdate_guard_trips") is None
    # the R-only downdate and the rank-1 downdate take the guard too
    R = state.R
    got = solvers.qr_downdate_row(R, _t(bad), guard=ranks.DowndateGuard(1e-6, "refuse"))
    assert torch.equal(got, R)
    jR = jnp.asarray(R.numpy())
    for mode in ("damp", "refuse"):
        got = solvers.qr_rank1_update(R, _t(bad), -1.0, guard=ranks.DowndateGuard(1e-6, mode))
        want = jsolvers.qr_rank1_update(jR, jnp.asarray(bad), -1.0,
                                        guard=jranks.DowndateGuard(1e-6, mode))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10, rtol=1e-10)


def test_downdate_guard_validates_its_config():
    for bad in (ranks.DowndateGuard(tau=2.0), ranks.DowndateGuard(tau=0.0),
                ranks.DowndateGuard(mode="explode")):
        with pytest.raises(ValueError):
            bad.validate()
    assert ranks.DowndateGuard() == tuple(jranks.DowndateGuard())


# --------------------------------------------------------- state integrity
def test_state_integrity_equals_the_reference():
    rls, state, rows, _ = _rls_near_cliff(solvers, _t)
    jrls, jstate, _, _ = _rls_near_cliff(jsolvers, jnp.asarray)
    assert solvers.state_integrity(state) == jstate_integrity(jstate) == (True, "ok")
    big = 1e300
    for bound in (big, 1.0):
        ours = solvers.state_integrity(state, max_cond=bound)
        ref = jstate_integrity(jstate, max_cond=bound)
        assert ours[0] == ref[0]
        if not ours[0]:
            assert ours[1].split()[:2] == ref[1].split()[:2] == ["cond", "estimate"]
            assert _rel(float(ours[1].split()[2]), float(ref[1].split()[2])) < 1e-3
    nan_d = state._replace(d=state.d.clone().fill_(float("nan")))
    jnan_d = jstate._replace(d=jnp.full_like(jstate.d, jnp.nan))
    assert solvers.state_integrity(nan_d) == jstate_integrity(jnan_d) == \
        (False, "non-finite leaf")
    # a plain (R, d) tuple and a NaN in a nested leaf
    assert solvers.state_integrity((state.R, [state.d, {"x": np.inf}]))[0] is False
    assert solvers.state_integrity((state.R, None, 3))[0] is True


# ------------------------------------------------------------------ sketch
@pytest.mark.parametrize("kind", ["countsketch", "srht"])
@pytest.mark.parametrize("m,n,s,seed", [(512, 16, 128, 3), (300, 5, 37, 0), (64, 8, 64, 7)])
def test_sketches_equal_the_reference(kind, m, n, s, seed):
    A = np.random.default_rng(11).standard_normal((m, n))
    ours = getattr(ranks, kind)(_t(A), s, seed=seed).numpy()
    ref = np.asarray(getattr(jranks, kind)(jnp.asarray(A), s, seed=seed))
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)
    s_full = np.linalg.svd(A, compute_uv=False)
    if kind == "countsketch" or s >= 2 * n:
        assert np.linalg.svd(ours, compute_uv=False)[0] <= 2.0 * s_full[0]


def test_countsketch_sums_each_bucket_in_row_order():
    """The deterministic scatter-add: each bucket is the sequential sum of
    its rows in row order (the same bits every run, on every device)."""
    A = np.random.default_rng(12).standard_normal((1000, 3))
    got = ranks.countsketch(_t(A), 17, seed=5).numpy()
    rng = np.random.default_rng(5)
    h = rng.integers(0, 17, size=1000)
    g = rng.choice(np.array([-1.0, 1.0]), size=1000)
    want = np.zeros((17, 3))
    for i in range(1000):
        want[h[i]] = want[h[i]] + g[i] * A[i]
    assert np.array_equal(got, want)
    assert np.array_equal(got, ranks.countsketch(_t(A), 17, seed=5).numpy())


@pytest.mark.parametrize("kw", [{}, {"kind": "srht"}, {"shards": 4}, {"s": 10_000}])
def test_sketch_qr_equals_the_reference(kw):
    A = graded_matrix(1024, 32, 1e8, seed=12)
    ours = ranks.sketch_qr(_t(A), **kw).numpy()
    ref = np.asarray(jranks.sketch_qr(jnp.asarray(A), **kw))
    np.testing.assert_allclose(ours, ref, atol=1e-12 * np.abs(ref).max(), rtol=0)
    AR = A @ np.linalg.inv(np.triu(ours))
    assert np.linalg.cond(AR) < 10.0


def _oracle(m, n, cond, seed):
    """The reference test's problem: b = A x0 + r0, r0 orthogonal to
    range(A) with ||r0|| = 0.1, so x0 and ||r0|| are exact."""
    A = graded_matrix(m, n, cond, seed=seed)
    rng = np.random.default_rng(seed + 1)
    x0 = rng.standard_normal(n)
    Q, _ = np.linalg.qr(A)
    r0 = rng.standard_normal(m)
    r0 -= Q @ (Q.T @ r0)
    r0 *= 0.1 / np.linalg.norm(r0)
    return A, A @ x0 + r0, x0, r0


def test_sketch_lstsq_oracle_takes_the_reference_iterations():
    """(2048, 48) at cond 1e8, the reference test's size: the same iteration
    count, the oracle residual within 1e-6, x within the problem's own
    tol x cond amplification (1e-2 of x0, the reference's bound)."""
    A, b, x0, r0 = _oracle(2048, 48, 1e8, 13)
    fit = ranks.sketch_lstsq(_t(A), _t(b), iters=50, tol=1e-12, seed=15)
    ref = jranks.sketch_lstsq(jnp.asarray(A), jnp.asarray(b), iters=50, tol=1e-12, seed=15)
    assert int(fit.iters) == int(ref.iters) <= 50
    assert float(fit.resid) == pytest.approx(np.linalg.norm(r0), rel=1e-6)
    assert float(fit.resid) == pytest.approx(float(ref.resid), rel=1e-8)
    assert np.linalg.norm(fit.x.numpy() - x0) <= 1e-2 * np.linalg.norm(x0)
    np.testing.assert_allclose(fit.R.numpy(), np.asarray(ref.R), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(ref.R)).max())
    # unpreconditioned LSQR at the same budget misses both marks, as there
    x, k, rn, _ = ranks.lsqr(_t(A), _t(b), iters=50, tol=1e-12)
    jx, jk, jrn, _ = jranks.lsqr(jnp.asarray(A), jnp.asarray(b), iters=50, tol=1e-12)
    assert int(k) == int(jk) == 50
    assert abs(float(rn) - np.linalg.norm(r0)) > 1e-6 * np.linalg.norm(r0)
    assert np.linalg.norm(x.numpy() - x0) > 0.1 * np.linalg.norm(x0)


@pytest.mark.parametrize("m,n,cond,seed,tol,precond", [
    (384, 48, 3.0, 32, 1e-8, False),
    (1024, 24, 1e6, 30, 1e-10, True),
    (384, 12, 1e4, 22, 1e-10, True),
])
def test_lsqr_takes_the_reference_iterations(m, n, cond, seed, tol, precond):
    """Where the iteration converges ahead of its rounding floor — the
    preconditioned systems, and an unpreconditioned one with cond(A) = 3 —
    both packages stop at the same iteration.  (Unpreconditioned LSQR on an
    ill-conditioned A runs past n iterations into its rounding floor, where
    the count is a matter of summation order in either package.)"""
    A, b, _, _ = _oracle(m, n, cond, seed)
    R = ranks.sketch_qr(_t(A), seed=1) if precond else None
    jR = jnp.asarray(R.numpy()) if precond else None
    x, k, rn, an = ranks.lsqr(_t(A), _t(b), R, iters=200, tol=tol)
    jx, jk, jrn, jan = jranks.lsqr(jnp.asarray(A), jnp.asarray(b), jR, iters=200, tol=tol)
    assert int(k) == int(jk) < 200
    assert np.allclose(x.numpy(), np.asarray(jx), atol=1e-8)
    assert float(rn) == pytest.approx(float(jrn), rel=1e-8)


def test_sketch_lstsq_paths_agree_with_the_reference():
    A = graded_matrix(1024, 24, 1e6, seed=16)
    b = A @ np.random.default_rng(17).standard_normal(24)
    base = ranks.sketch_lstsq(_t(A), _t(b), iters=50, tol=1e-12)
    for kw in ({}, {"kind": "srht"}, {"shards": 4}):
        fit = ranks.sketch_lstsq(_t(A), _t(b), iters=50, tol=1e-12, **kw)
        ref = jranks.sketch_lstsq(jnp.asarray(A), jnp.asarray(b), iters=50, tol=1e-12, **kw)
        assert np.allclose(fit.x.numpy(), base.x.numpy(), atol=1e-8)
        assert np.allclose(fit.x.numpy(), np.asarray(ref.x), atol=1e-8)


def test_wide_and_matrix_rhs_inputs():
    rng = np.random.default_rng(18)
    with pytest.raises(ValueError, match="m >= n"):
        ranks.sketch_lstsq(_t(rng.standard_normal((4, 8))), _t(rng.standard_normal(4)))
    A, B = rng.standard_normal((64, 8)), rng.standard_normal((64, 3))
    with pytest.raises(ValueError, match="single rhs"):
        ranks.lsqr(_t(A), _t(B))
    with pytest.raises(ValueError, match="unknown sketch kind"):
        ranks.sketch_qr(_t(A), kind="gaussian")
    fit = ranks.sketch_lstsq(_t(A), _t(B), iters=50, tol=1e-12)
    ref = jranks.sketch_lstsq(jnp.asarray(A), jnp.asarray(B), iters=50, tol=1e-12)
    x_ref, *_ = np.linalg.lstsq(A, B, rcond=None)
    assert fit.x.shape == (8, 3) and fit.resid.shape == (3,)
    assert np.allclose(fit.x.numpy(), x_ref, atol=1e-8)
    assert int(fit.iters) == int(ref.iters)
