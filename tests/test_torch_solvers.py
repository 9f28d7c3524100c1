"""Port parity: solvers (qr_update, lstsq, kalman) and ranks.pivoted against
the JAX package on the same numpy inputs, plus numpy oracles for the parts
of the modules that carry no kernel."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ranks as jranks
import repro.solvers as jsolvers
from repro.solvers import kalman as jkalman
from repro_torch import ranks, solvers
from repro_torch.convert import from_numpy, to_numpy
from repro_torch.solvers import kalman


def _rng(seed):
    return np.random.default_rng(seed)


def _triu_spd(rng, n, dtype=np.float64):
    T = np.triu(rng.standard_normal((n, n)))
    np.fill_diagonal(T, np.abs(np.diag(T)) + 1.0)
    return T.astype(dtype)


def _close(out, ref, tol):
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref), atol=tol, rtol=tol)


def test_append_rows_matches_jax_and_updates_invert():
    rng = _rng(0)
    R, U = _triu_spd(rng, 6), rng.standard_normal((3, 6))
    d, Y = rng.standard_normal((6, 2)), rng.standard_normal((3, 2))
    t = from_numpy((R, U, d, Y), "cpu")
    R2, d2 = solvers.qr_append_rows(*t)
    jR2, jd2 = jsolvers.qr_append_rows(*map(jnp.asarray, (R, U, d, Y)))
    _close(R2, jR2, 1e-11)
    _close(d2, jd2, 1e-11)
    _close(solvers.qr_append_rows(t[0], t[1]), jR2, 1e-11)
    # Gram invariants, then downdating the appended rows back out restores
    # the state (numpy oracle; the downdate carries no kernel)
    np.testing.assert_allclose(R2.numpy().T @ R2.numpy(), R.T @ R + U.T @ U, atol=1e-10)
    Rd, dd = R2, d2
    for i in range(3):
        Rd, dd = solvers.qr_downdate_row(Rd, t[1][i], dd, t[3][i])
    _close(Rd, R, 1e-9)
    _close(dd, d, 1e-9)
    up = solvers.qr_rank1_update(t[0], t[1][1], 0.7, t[2], t[3][1])
    down = solvers.qr_rank1_update(up[0], t[1][1], -0.7, up[1], t[3][1])
    _close(down[0], R, 1e-9)
    _close(down[1], d, 1e-9)
    # the downdate guard is ported: a malformed one is refused
    with pytest.raises(ValueError):
        solvers.qr_downdate_row(R2, t[1][0], guard=ranks.DowndateGuard(mode="explode"))


@pytest.mark.parametrize("backend,rhs", [("pallas", True), ("pallas", False),
                                         ("reference", True)])
def test_append_rows_batched_matches_jax(backend, rhs):
    rng = _rng(1)
    B, n, p, k = 7, 5, 3, 2
    R = np.stack([_triu_spd(rng, n) for _ in range(B)]).astype(np.float32)
    U = rng.standard_normal((B, p, n)).astype(np.float32)
    d = rng.standard_normal((B, n, k)).astype(np.float32) if rhs else None
    Y = rng.standard_normal((B, p, k)).astype(np.float32) if rhs else None
    out = solvers.qr_append_rows_batched(*from_numpy((R, U, d, Y), "cpu"),
                                         backend=backend)
    ref = jsolvers.qr_append_rows_batched(
        jnp.asarray(R), jnp.asarray(U), None if d is None else jnp.asarray(d),
        None if Y is None else jnp.asarray(Y), backend=backend, interpret=True)
    if not rhs:
        out, ref = (out,), (ref,)
    for a, b in zip(out, ref):
        _close(a, b, 5e-5)
    with pytest.raises(NotImplementedError):
        solvers.qr_append_rows_batched(*from_numpy((R, U), "cpu"), mesh=object())


@pytest.mark.parametrize("m,n,vec", [(20, 5, True), (300, 130, False)])
def test_lstsq_both_routes_match_jax(m, n, vec):
    """(300, 130) takes the blocked route (>= 256 rows, >= 128 pivots)."""
    rng = _rng(m)
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m) if vec else rng.standard_normal((m, 2))
    fit = solvers.ggr_lstsq(*from_numpy((A, b), "cpu"))
    ref = jsolvers.ggr_lstsq(jnp.asarray(A), jnp.asarray(b))
    for a, r in zip(fit, ref):
        _close(a, r, 1e-10)
    np.testing.assert_allclose(fit.x.numpy(), np.linalg.lstsq(A, b, rcond=None)[0],
                               atol=1e-10)


def test_lstsq_rank_check_and_batched_escape():
    rng = _rng(2)
    A = rng.standard_normal((20, 3)) @ rng.standard_normal((3, 5))
    b = rng.standard_normal(20)
    At, bt = from_numpy((A, b), "cpu")
    with pytest.raises(ValueError, match="rank-deficient"):
        solvers.ggr_lstsq(At, bt)
    # the batched serving path pads with zero problems, which are
    # rank-collapsed by construction: the check is switched off explicitly
    A1 = torch.from_numpy(rng.standard_normal((20, 5)))
    Ab = torch.stack([A1, torch.zeros_like(A1)])
    bb = torch.stack([bt, torch.zeros_like(bt)])
    with pytest.raises(ValueError):
        solvers.ggr_lstsq(Ab, bb)
    fit = solvers.ggr_lstsq(Ab, bb, check_rank=False)
    assert fit.x.shape == (2, 5) and bool(fit.x[1].eq(0).all())
    np.testing.assert_allclose(fit.x[0].numpy(), solvers.ggr_lstsq(A1, bt).x.numpy(),
                               atol=1e-12)
    # rcond= routes to the pivoted min-norm path, as in the JAX package
    piv = solvers.ggr_lstsq(At, bt, rcond=1e-10)
    np.testing.assert_allclose(piv.x.numpy(), np.linalg.lstsq(A, b, rcond=1e-10)[0],
                               atol=1e-9)


def _canon(R, d):
    """Rows of a triangular factor scaled to a non-negative diagonal, rhs
    alike: a factor's rows beyond its numerical rank (and a last pivot row no
    sweep normalizes) carry a sign that roundoff picks."""
    R, d = to_numpy(R), to_numpy(d)
    s = np.where(np.diagonal(R, axis1=-2, axis2=-1) < 0, -1.0, 1.0)
    return R * s[..., :, None], d * (s[..., :, None] if d.ndim == R.ndim else s)


def test_lstsq_pivoted_matches_jax_with_rank():
    rng = _rng(30)
    m, n, r = 24, 6, 3
    A = rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
    b = rng.standard_normal((m, 2))
    fit = ranks.lstsq_pivoted(*from_numpy((A, b), "cpu"))
    ref = jranks.lstsq_pivoted(jnp.asarray(A), jnp.asarray(b))
    assert int(fit.rank) == int(ref.rank) == r
    # pivots and factor rows within the rank are data; beyond it, roundoff
    np.testing.assert_array_equal(fit.perm.numpy()[:r], np.asarray(ref.perm)[:r])
    _close(fit.x, ref.x, 1e-9)
    _close(fit.resid, ref.resid, 1e-9)
    _close(fit.R[:r], np.asarray(ref.R)[:r], 1e-9)
    _close(fit.d[:r], np.asarray(ref.d)[:r], 1e-9)
    np.testing.assert_allclose(fit.x.numpy(), np.linalg.lstsq(A, b, rcond=1e-10)[0],
                               atol=1e-9)


def test_lstsq_pivoted_wide_and_batched():
    rng = _rng(31)
    A = rng.standard_normal((4, 3)) @ rng.standard_normal((3, 7))
    b = rng.standard_normal((4, 2))
    fit = ranks.lstsq_pivoted(*from_numpy((A, b), "cpu"))
    assert int(fit.rank) == 3
    np.testing.assert_allclose(fit.x.numpy(), np.linalg.lstsq(A, b, rcond=1e-10)[0],
                               atol=1e-9)
    # batched ranks are per problem, and zero problems are fixed points
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    batched = ranks.lstsq_pivoted(torch.stack([At, torch.zeros_like(At)]),
                                  torch.stack([bt, torch.zeros_like(bt)]))
    assert batched.rank.tolist() == [3, 0]
    np.testing.assert_allclose(batched.x[0].numpy(), fit.x.numpy(), atol=1e-12)
    assert bool(batched.x[1].eq(0).all())
    assert ranks.estimate_rank(fit.R, rcond=0.5).item() <= 3


def _filters(rng, B, n, p, shared, dtype=np.float64):
    R = np.stack([_triu_spd(rng, n) for _ in range(B)]).astype(dtype)
    d = rng.standard_normal((B, n)).astype(dtype)
    z = rng.standard_normal((B, p)).astype(dtype)
    lead = () if shared else (B,)
    F = (np.eye(n) + 0.1 * rng.standard_normal(lead + (n, n))).astype(dtype)
    Qi = (np.stack([_triu_spd(rng, n) for _ in range(B)]) if not shared
          else _triu_spd(rng, n)).astype(dtype)
    H = rng.standard_normal(lead + (p, n)).astype(dtype)
    return R, d, F, Qi, H, z


@pytest.mark.parametrize("shared", [True, False])
def test_kf_step_batched_matches_jax(shared):
    ops = _filters(_rng(3), 5, 4, 2, shared)
    out = kalman.kf_step_batched(*from_numpy(ops, "cpu"))
    ref = jkalman.kf_step_batched(*map(jnp.asarray, ops), interpret=True)
    for a, b in zip(out, ref):
        _close(a, b, 1e-10)


@pytest.mark.parametrize("shared", [True, False])
def test_kf_step_batched_reference_lanes_equal_single_steps(shared):
    """The reference backend's lanes equal single-filter fused steps bit for
    bit (the batched == sequential contract), and agree with the kernel path
    to roundoff."""
    ops = from_numpy(_filters(_rng(4), 5, 4, 2, shared), "cpu")
    Rb, db = kalman.kf_step_batched(*ops, backend="reference")
    R, d, F, Qi, H, z = ops
    for i in range(5):
        m = (F, Qi, H) if shared else (F[i], Qi[i], H[i])
        one = kalman.kf_step(kalman.KalmanState(R[i], d[i], torch.tensor(0)),
                             *m, z[i])
        assert torch.equal(one.R, Rb[i]) and torch.equal(one.d, db[i])
    Rk, dk = kalman.kf_step_batched(*ops, backend="pallas")
    _close(Rk, Rb.numpy(), 1e-10)
    _close(dk, db.numpy(), 1e-10)


def test_kalman_filter_and_smoother_match_covariance_oracle():
    """SRIF filter + RTS smoother against a plain covariance-form Kalman
    filter/smoother in numpy (f64)."""
    rng = _rng(5)
    n, p, T = 3, 2, 6
    P0 = np.eye(n) * 2.0
    x0 = rng.standard_normal(n)
    F = np.eye(n) + 0.1 * rng.standard_normal((n, n))
    Q = 0.1 * np.eye(n)
    Rn = np.array([[0.5, 0.1], [0.1, 0.3]])
    H = rng.standard_normal((p, n))
    zs = rng.standard_normal((T, p))

    Hw, zw = kalman.whiten_measurement(*from_numpy((Rn, H, zs.T), "cpu"))
    st = kalman.kf_init(*from_numpy((x0, P0), "cpu"))
    final, traj = kalman.kf_filter(st, torch.from_numpy(F),
                                   kalman.info_sqrt(torch.from_numpy(Q)), Hw, zw.T)
    xs, Ps = kalman.kf_smooth(traj, torch.from_numpy(F))

    x, P = x0, P0
    xf, Pf, xp, Pp = [], [], [], []
    for z in zs:
        x, P = F @ x, F @ P @ F.T + Q
        xp.append(x)
        Pp.append(P)
        K = P @ H.T @ np.linalg.inv(H @ P @ H.T + Rn)
        x, P = x + K @ (z - H @ x), (np.eye(n) - K @ H) @ P
        xf.append(x)
        Pf.append(P)
    np.testing.assert_allclose(kalman.kf_mean(final).numpy(), xf[-1], atol=1e-10)
    np.testing.assert_allclose(kalman.kf_cov(final).numpy(), Pf[-1], atol=1e-10)
    xs_ref, Ps_ref = [xf[-1]], [Pf[-1]]
    for t in range(T - 2, -1, -1):
        C = Pf[t] @ F.T @ np.linalg.inv(Pp[t + 1])
        xs_ref.append(xf[t] + C @ (xs_ref[-1] - xp[t + 1]))
        Ps_ref.append(Pf[t] + C @ (Ps_ref[-1] - Pp[t + 1]) @ C.T)
    np.testing.assert_allclose(xs.numpy(), np.stack(xs_ref[::-1]), atol=1e-9)
    np.testing.assert_allclose(Ps.numpy(), np.stack(Ps_ref[::-1]), atol=1e-9)
    # kf_predict + kf_observe == the fused kf_step up to rotation order
    F_t, Qi_t = torch.from_numpy(F), kalman.info_sqrt(torch.from_numpy(Q))
    two = kalman.kf_observe(kalman.kf_predict(st, F_t, Qi_t), Hw, zw[:, 0])
    one = kalman.kf_step(st, F_t, Qi_t, Hw, zw[:, 0])
    np.testing.assert_allclose(*_canon(one.R, one.d)[:1], *_canon(two.R, two.d)[:1],
                               atol=1e-10)
    assert isinstance(from_numpy(to_numpy(final), "cpu"), kalman.KalmanState)


def test_recursive_ls_matches_weighted_least_squares():
    rng = _rng(6)
    lam, delta = 0.9, 1e-8
    rls = solvers.RecursiveLS(n=4, lam=lam, delta=delta)
    st = rls.init(torch.float64, device="cpu")
    rows, ys = rng.standard_normal((8, 4)), rng.standard_normal(8)
    for u, y in zip(rows, ys):
        st = rls.observe(st, torch.from_numpy(u), torch.tensor(y))
    w = lam ** np.arange(7, -1, -1)  # exponential forgetting weights
    G = (rows * w[:, None]).T @ rows + delta * lam ** 8 * np.eye(4)
    x_ref = np.linalg.solve(G, (rows * w[:, None]).T @ ys)
    np.testing.assert_allclose(rls.solve(st).numpy(), x_ref, atol=1e-9)
    np.testing.assert_allclose(rls.predict(st, torch.from_numpy(rows)).numpy(),
                               rows @ x_ref, atol=1e-9)
    assert int(st.count) == 8
    win = solvers.RecursiveLS(n=4, delta=delta)
    st = win.init(torch.float64, device="cpu")
    for u, y in zip(rows, ys):
        st = win.observe(st, torch.from_numpy(u), torch.tensor(y))
    st = win.forget(st, torch.from_numpy(rows[0]), torch.tensor(ys[0]))
    np.testing.assert_allclose(win.solve(st).numpy(),
                               np.linalg.lstsq(rows[1:], ys[1:], rcond=None)[0], atol=1e-7)
    lev = win.residual_gram(st, torch.from_numpy(rows[1])).item()
    np.testing.assert_allclose(lev, rows[1] @ np.linalg.solve(rows[1:].T @ rows[1:], rows[1]),
                               rtol=1e-6)


@pytest.mark.parametrize("lower,trans", [(False, False), (True, False), (False, True)])
def test_solve_triangular_matches_numpy(lower, trans):
    rng = _rng(7)
    R = _triu_spd(rng, 5)
    if lower:
        R = R.T.copy()
    b = rng.standard_normal((5, 2))
    A = R.T if trans else R
    np.testing.assert_allclose(
        solvers.solve_triangular(*from_numpy((R, b), "cpu"), lower=lower,
                                 trans=trans).numpy(),
        np.linalg.solve(A, b), atol=1e-12)
