"""Port parity: core.baselines (GR, CGR, dgeqr2, dgeqrf, dgeqr2ht, MGS) against
the JAX package's routines on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro_torch import core

_UNBLOCKED = ["givens_qr", "cgr_qr", "householder_qr2"]
_BLOCKED = ["householder_qrf", "mht_qr"]
# f64: the reference's own tests hold these routines to 1e-9 of numpy; the
# port is held to the reference within 1e-10.  f32: within 2e-5 of max|R|
# (a few f32 roundings of the entries, which the two packages sum in orders
# of their own)
_TOL = {np.float64: 1e-10, np.float32: 2e-5}


def _rand(shape, seed, dtype):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close_abs(ours, ref, dtype):
    ours, ref = ours.double().numpy(), np.asarray(ref, np.float64)
    scale = 1.0 if dtype == np.float64 else max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(np.abs(ours), np.abs(ref), rtol=0, atol=_TOL[dtype] * scale)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("fn", _UNBLOCKED)
@pytest.mark.parametrize("m,n", [(8, 8), (16, 10), (12, 12), (6, 9)])
def test_unblocked_routines_equal_the_reference(fn, m, n, dtype):
    A = _rand((m, n), m * 7 + n, dtype)
    ours = getattr(core, fn)(torch.as_tensor(A))
    ref = getattr(jcore, fn)(jnp.asarray(A))
    assert ours.shape == ref.shape and ours.dtype == torch.as_tensor(A).dtype
    _close_abs(ours, ref, dtype)
    kk = min(m, n)
    np.testing.assert_allclose(np.abs(ours.double().numpy()[:kk]),
                               np.abs(np.linalg.qr(A.astype(np.float64), mode="r")[:kk]),
                               atol=1e-9 if dtype == np.float64 else 1e-4)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("fn", _BLOCKED)
@pytest.mark.parametrize("block", [8, 32])
def test_blocked_routines_equal_the_reference(fn, block, dtype):
    A = _rand((40, 36), 31, dtype)
    ours = getattr(core, fn)(torch.as_tensor(A), block=block)
    ref = getattr(jcore, fn)(jnp.asarray(A), block=block)
    _close_abs(ours, ref, dtype)


def test_householder_factors_equal_the_reference():
    A = _rand((14, 9), 33, np.float64)
    R, V, betas = core.householder_qr2(torch.as_tensor(A), want_factors=True)
    jR, jV, jb = jcore.householder_qr2(jnp.asarray(A), want_factors=True)
    for a, b in ((R, jR), (V, jV), (betas, jb)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("m,n", [(16, 16), (20, 12)])
def test_mgs_equals_the_reference(m, n, dtype):
    A = _rand((m, n), 37, dtype)
    Q, R = core.mgs_qr(torch.as_tensor(A))
    jQ, jR = jcore.mgs_qr(jnp.asarray(A))
    _close_abs(R, jR, dtype)
    if dtype == np.float64:
        _close_abs(Q, jQ, dtype)
        np.testing.assert_allclose(Q.numpy() @ R.numpy(), A, atol=1e-9)
        np.testing.assert_allclose(Q.numpy().T @ Q.numpy(), np.eye(n), atol=1e-9)
    else:
        # MGS's f32 Q moves by eps x cond(A) under a change of summation
        # order, in either package; its backward error does not
        QR = Q.double().numpy() @ R.double().numpy()
        np.testing.assert_allclose(QR, A, atol=2e-5 * np.abs(A).max())


def test_all_routines_agree_on_abs_r():
    """Fig. 9 sanity: every routine factors to the same |R| (up to signs),
    the port's GGR QR among them."""
    A = torch.as_tensor(_rand((12, 12), 41, np.float64))
    rs = [core.ggr_qr2(A).abs()] + [getattr(core, fn)(A).abs()
                                    for fn in _UNBLOCKED + _BLOCKED]
    rs.append(core.mgs_qr(A)[1].abs())
    for r in rs[1:]:
        np.testing.assert_allclose(r.numpy(), rs[0].numpy(), atol=1e-9)
