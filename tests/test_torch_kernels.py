"""Port parity: the plain versions of the two ported kernels (batched_update,
batched_geqrt) against the JAX Pallas kernels in interpret mode, same numpy
inputs, and the wrappers' contracts on CPU tensors (the CUDA kernels are
held against the plain versions in tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ggr_panel import batched_geqrt_pallas
from repro.kernels.ggr_update import batched_update_pallas
from repro_torch.kernels import (Precision, batched_geqrt, batched_update,
                                 pad_batch, pad_to_tile, resolve_precision)

# the JAX kernel tests' tolerances (tests/test_kernels.py), scaled by max(1, m // 16)
TOL = {np.float32: 5e-5, np.float64: 1e-11}
DTYPES = [np.float32, np.float64]


def _update_stack(rng, B, n_piv, p, w, dtype):
    """(B, n_piv + p, w) stacked problems whose top n_piv rows are upper
    triangular, with problem 0 all zero (the serving padding case)."""
    X = rng.standard_normal((B, n_piv + p, w))
    X[:, :n_piv, :n_piv] = np.triu(X[:, :n_piv, :n_piv])
    X[0] = 0.0
    return X.astype(dtype)


def _coupling_stack(rng, npair, b, dtype):
    """Tree-coupling shape (npair, 2b, 3b): [R_a | I | 0; R_b | 0 | I]."""
    I, Z = np.eye(b), np.zeros((b, b))
    out = []
    for _ in range(npair):
        Ra = np.triu(rng.standard_normal((b, b)))
        Rb = np.triu(rng.standard_normal((b, b)))
        out.append(np.block([[Ra, I, Z], [Rb, Z, I]]))
    return np.stack(out).astype(dtype)


UPDATE_CASES = {
    # append stack (B, n + p, n + k) at n=8, p=4, k=1 for B in {1, 7, 67}
    "append_B1": lambda rng, dt: (_update_stack(rng, 1, 8, 4, 9, dt), 8),
    "append_B7": lambda rng, dt: (_update_stack(rng, 7, 8, 4, 9, dt), 8),
    "append_B67": lambda rng, dt: (_update_stack(rng, 67, 8, 4, 9, dt), 8),
    # kalman stack (B, w + 2n + p, w + n + 1) at n = w = 4, p = 2
    "kalman_B7": lambda rng, dt: (_update_stack(rng, 7, 8, 6, 9, dt), 8),
    # tree coupling (npair, 2b, 3b) at b in {8, 16}
    "coupling_b8": lambda rng, dt: (_coupling_stack(rng, 3, 8, dt), 8),
    "coupling_b16": lambda rng, dt: (_coupling_stack(rng, 2, 16, dt), 16),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_update_plain_matches_jax_kernel(case, dtype):
    X, n_piv = UPDATE_CASES[case](np.random.default_rng(len(case)), dtype)
    ref = np.asarray(batched_update_pallas(jnp.asarray(X), n_piv, interpret=True))
    out = batched_update(torch.from_numpy(X), n_piv).numpy()
    tol = TOL[dtype] * max(1, X.shape[1] // 16)
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)
    if case.startswith(("append", "kalman")):  # problem 0 is all zero
        assert np.array_equal(out[0].view(np.uint8), np.zeros_like(X[0]).view(np.uint8))


def _geqrt_tiles(rng, B, b, dtype):
    """Tree level-0 shape (B, b, 2b): [T | I], tile 0 all zero."""
    T = rng.standard_normal((B, b, b))
    T[0] = 0.0
    return np.concatenate([T, np.broadcast_to(np.eye(b), (B, b, b))], 2).astype(dtype)


@pytest.mark.parametrize("B,b", [(1, 8), (7, 8), (67, 8), (5, 16)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_batched_geqrt_plain_matches_jax_kernel(B, b, dtype):
    tiles = _geqrt_tiles(np.random.default_rng(B * b), B, b, dtype)
    ref = np.asarray(batched_geqrt_pallas(jnp.asarray(tiles), b, interpret=True))
    out = batched_geqrt(torch.from_numpy(tiles), b).numpy()
    tol = TOL[dtype] * max(1, b // 16)
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)
    # zero tile: bit-identical fixed point with Qt = I
    assert np.array_equal(out[0].view(np.uint8), tiles[0].view(np.uint8))
    # [R | Qt]: Qt @ T = R with Qt orthogonal
    Qt = out[1:, :, b:].astype(np.float64)
    np.testing.assert_allclose(Qt @ tiles[1:, :, :b], out[1:, :, :b],
                               atol=1e3 * TOL[dtype])


@pytest.mark.parametrize("which", ["update", "geqrt"])
def test_mixed_precision_plain_matches_jax_kernel(which):
    """bf16 tiles with f32 accumulation: the same policy on both sides."""
    rng = np.random.default_rng(3)
    if which == "update":
        X, n_piv = _update_stack(rng, 7, 8, 4, 9, np.float32), 8
        ref = batched_update_pallas(jnp.asarray(X), n_piv, interpret=True,
                                    precision="bf16")
        out = batched_update(torch.from_numpy(X), n_piv, precision="bf16")
    else:
        X, n_piv = _geqrt_tiles(rng, 7, 8, np.float32), 8
        ref = batched_geqrt_pallas(jnp.asarray(X), n_piv, interpret=True,
                                   precision="bf16")
        out = batched_geqrt(torch.from_numpy(X), n_piv, precision="bf16")
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.float().numpy(), ref, atol=3e-2 * scale)


def test_update_without_appended_rows_is_identity():
    X = torch.randn(3, 5, 7, dtype=torch.float64)
    assert batched_update(X, 5) is X


def test_cpu_calls_take_plain_version_and_launch_nothing():
    before = (batched_update.launches, batched_geqrt.launches)
    batched_update(torch.zeros(2, 6, 5), 4)
    batched_geqrt(torch.zeros(2, 4, 8), 4)
    assert (batched_update.launches, batched_geqrt.launches) == before


@pytest.mark.parametrize("bad", ["noncontig", "block_b", "rank", "pivots"])
def test_wrappers_reject_bad_input(bad):
    X = torch.zeros(4, 6, 8)
    kwargs = {}
    if bad == "noncontig":
        X = X.transpose(1, 2)
    elif bad == "block_b":
        kwargs["block_b"] = 0
    elif bad == "rank":
        X = X[0]
    elif bad == "pivots":
        kwargs["n_pivots"] = 9
    for fn in (batched_update, batched_geqrt):
        with pytest.raises(ValueError):
            fn(X, **{"n_pivots": 4, **kwargs})


def test_padding_primitives_match_jax():
    from repro.kernels import pad_batch as jpad_batch
    from repro.kernels import pad_to_tile as jpad_to_tile

    x = np.random.default_rng(0).standard_normal((5, 7, 3))
    np.testing.assert_array_equal(pad_batch(torch.from_numpy(x), 4).numpy(),
                                  np.asarray(jpad_batch(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(
        pad_to_tile(torch.from_numpy(x), (4, 2)).numpy(),
        np.asarray(jpad_to_tile(jnp.asarray(x), (4, 2))))
    assert pad_batch(torch.from_numpy(x), 5).shape == (5, 7, 3)
    with pytest.raises(ValueError):
        pad_batch(torch.from_numpy(x), 0)


def test_resolve_precision_aliases_match_jax():
    from repro.kernels import resolve_precision as jresolve

    for name in ("f32", "f64", "bf16", "f16", "mixed_bf16", "mixed_f16",
                 "float32", "double", "half"):
        assert tuple(resolve_precision(name)) == tuple(jresolve(name))
    with pytest.raises(ValueError):
        resolve_precision("int8")
    with pytest.raises(ValueError):
        resolve_precision(Precision("float32", "bfloat16", "float32"))
