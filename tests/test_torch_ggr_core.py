"""Port parity: ``repro_torch.core.ggr`` against ``repro.core.ggr`` on the same
numpy inputs (f32 and f64), plus the port's batch dimension."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ggr as jggr
from repro_torch.core import ggr

TOL = {np.float32: 5e-5, np.float64: 1e-11}
DTYPES = [np.float32, np.float64]


def _rand(shape, seed, dtype):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(out, ref, dtype, scale=1):
    tol = TOL[dtype] * scale
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=tol, rtol=tol)


def test_closed_form_pieces_match():
    dtype = np.float64
    X = _rand((9, 5), 0, dtype)
    C = _rand((9, 4), 1, dtype)
    col = X[:, 2]

    @jax.jit
    def jax_pieces(X, C):
        f = jggr.ggr_factor_column(X, 1, pivot=3)
        return (jggr.suffix_norms(X[:, 2]), *jggr.scaled_column(X[:, 2]),
                jggr.ggr_column_step(X), f.v, f.t, jggr.apply_ggr_factors(f, C, 3))

    ref = jax_pieces(jnp.asarray(X), jnp.asarray(C))
    f = ggr.ggr_factor_column(torch.from_numpy(X), 1, pivot=3)
    out = (ggr.suffix_norms(torch.from_numpy(col)),
           *ggr.scaled_column(torch.from_numpy(col)),
           ggr.ggr_column_step(torch.from_numpy(X)), f.v, f.t,
           ggr.apply_ggr_factors(f, torch.from_numpy(C), 3))
    for a, b in zip(out, ref):
        _close(a.reshape(-1), np.asarray(b).reshape(-1), dtype)


@pytest.mark.parametrize("c,pivot", [(2, None), (1, 4)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_column_step_at_matches(c, pivot, dtype):
    X = _rand((9, 6), c + 10, dtype)
    step = jax.jit(jggr.ggr_column_step_at, static_argnums=(1, 2))
    _close(ggr.ggr_column_step_at(torch.from_numpy(X), c, pivot),
           step(jnp.asarray(X), c, pivot), dtype)


@pytest.mark.parametrize("m,w,n_piv,dtype", [
    (12, 7, 5, np.float32), (12, 7, 5, np.float64), (6, 9, 6, np.float64),
    (1, 3, 2, np.float64)])
def test_triangularize_matches(m, w, n_piv, dtype):
    X = _rand((m, w), m * w, dtype)
    _close(ggr.ggr_triangularize(torch.from_numpy(X), n_piv),
           jggr.ggr_triangularize(jnp.asarray(X), n_piv), dtype)


@pytest.mark.parametrize("shape,dtype", [((10, 6), np.float32), ((10, 6), np.float64),
                                         ((4, 7), np.float64)])
def test_qr2_matches_with_and_without_q(shape, dtype):
    A = _rand(shape, 7, dtype)
    _close(ggr.ggr_qr2(torch.from_numpy(A)), jggr.ggr_qr2(jnp.asarray(A)), dtype)
    R, Q = ggr.ggr_qr2(torch.from_numpy(A), want_q=True)
    jR, jQ = jggr.ggr_qr2(jnp.asarray(A), want_q=True)
    _close(R, jR, dtype)
    _close(Q, jQ, dtype)
    _close(Q.double() @ R.double(), A.astype(np.float64), dtype, scale=10)


def test_eps_table_is_dtype_keyed():
    # 1e-300 at f64 (the core table), 1e-30 otherwise
    assert ggr._eps_for(torch.float64) == 1e-300
    assert ggr._eps_for(torch.float32) == 1e-30
    assert ggr._eps_for(torch.bfloat16) == 1e-30


def test_tiny_column_is_not_treated_as_zero_at_f64():
    """A column of 1e-200 entries is real data at f64 (eps 1e-300), and the
    exclusive suffix by shift keeps it exact: both packages annihilate it."""
    X = _rand((6, 3), 3, np.float64)
    X[:, 0] *= 1e-200
    out = ggr.ggr_triangularize(torch.from_numpy(X), 3).numpy()
    ref = np.asarray(jggr.ggr_triangularize(jnp.asarray(X), 3))
    np.testing.assert_allclose(out, ref, rtol=1e-11, atol=0)
    assert np.all(out[1:, 0] == 0.0) and out[0, 0] > 0


def test_bf16_promotes_accumulation_to_f32():
    X = _rand((8, 4), 5, np.float32)
    Xb = torch.from_numpy(X).to(torch.bfloat16)
    out = ggr.ggr_triangularize(Xb, 4)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(jggr.ggr_triangularize(jnp.asarray(X, jnp.bfloat16), 4)
                     .astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, atol=3e-2 * np.abs(ref).max())


@pytest.mark.parametrize("fn", ["triangularize", "qr2_q"])
def test_batch_dimension_equals_per_problem_loop(fn):
    Xb = torch.from_numpy(_rand((5, 9, 6), 11, np.float64))
    if fn == "triangularize":
        out = ggr.ggr_triangularize(Xb, 4)
        loop = torch.stack([ggr.ggr_triangularize(x, 4) for x in Xb])
        assert torch.equal(out, loop)
    else:
        R, Q = ggr.ggr_qr2(Xb, want_q=True)
        for i, x in enumerate(Xb):
            Ri, Qi = ggr.ggr_qr2(x, want_q=True)
            assert torch.equal(R[i], Ri) and torch.equal(Q[i], Qi)
