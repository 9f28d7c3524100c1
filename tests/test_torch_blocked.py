"""Port parity: the blocked tree-schedule driver against the JAX package's
``schedule="tree"`` on the same numpy inputs, plus the port's batch dimension
and schedule resolution."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocked as jblocked
from repro_torch.core import blocked
from repro_torch.kernels import batched_geqrt, batched_update
from repro_torch.kernels.ggr_panel import panel_factor
from repro_torch.kernels.backend import degraded_mode

TOL = {np.float32: 5e-5, np.float64: 1e-11}


def _rand(shape, seed, dtype):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("m,w,n_piv,tile,dtype", [
    (70, 37, 30, 16, np.float64),   # m != n, non-multiples, 7 rhs columns ride
    (100, 45, 45, 16, np.float64),  # pure QR of a non-multiple square-ish block
    (40, 61, 20, 8, np.float64),    # wide: more columns than rows
    (70, 37, 30, 16, np.float32),
])
def test_tree_schedule_matches_jax(m, w, n_piv, tile, dtype):
    X = _rand((m, w), m + w, dtype)
    ref = np.asarray(jblocked.ggr_triangularize_blocked(
        jnp.asarray(X), n_piv, tile=tile, schedule="tree"))
    out = blocked.ggr_triangularize_blocked(torch.from_numpy(X), n_piv, tile=tile)
    tol = TOL[dtype] * max(1, m // 16)
    np.testing.assert_allclose(out.numpy(), ref, atol=tol, rtol=tol)


def test_qr_blocked_matches_numpy_r():
    A = _rand((90, 50), 2, np.float64)
    R = blocked.ggr_qr_blocked(torch.from_numpy(A), tile=16).numpy()
    Rnp = np.linalg.qr(A, mode="r")
    np.testing.assert_allclose(np.abs(R[:50]), np.abs(Rnp), atol=1e-11)
    assert np.all(R[50:] == 0)


def test_batch_dimension_equals_per_problem_loop_with_one_launch_per_level(monkeypatch):
    """B problems x p row tiles share one GEQRT call per panel and B x npair
    pairs one coupling call per tree round: the batched result equals a loop
    of single-problem calls bit for bit."""
    Xb = torch.from_numpy(_rand((3, 70, 37), 4, np.float64))
    calls = {"geqrt": 0, "update": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(blocked, "batched_geqrt", counting("geqrt", batched_geqrt))
    monkeypatch.setattr(blocked, "batched_update", counting("update", batched_update))
    out = blocked.ggr_triangularize_blocked(Xb, 30, tile=16)
    batched_calls = dict(calls)
    loop = torch.stack([blocked.ggr_triangularize_blocked(x, 30, tile=16) for x in Xb])
    assert torch.equal(out, loop)
    assert batched_calls["geqrt"] * 3 == calls["geqrt"] - batched_calls["geqrt"]
    assert batched_calls["update"] * 3 == calls["update"] - batched_calls["update"]


def test_auto_resolves_to_tree_and_fused_is_not_ported():
    """On a CPU tensor ``"auto"`` means tree, as the reference resolves it in
    interpret mode (on a CUDA tensor it means fused: tests/test_torch_cuda.py);
    ``"fused"`` — ported since, the name kept from when it raised — runs as an
    argument and under ``degraded_mode`` and matches the JAX fused schedule."""
    Xn = _rand((48, 20), 5, np.float64)
    X = torch.from_numpy(Xn)
    tree = blocked.ggr_triangularize_blocked(X, 20, tile=8, schedule="tree")
    assert torch.equal(blocked.ggr_triangularize_blocked(X, 20, tile=8), tree)
    want = np.asarray(jblocked.ggr_triangularize_blocked(
        jnp.asarray(Xn), 20, tile=8, schedule="fused"))
    fused = blocked.ggr_triangularize_blocked(X, 20, tile=8, schedule="fused")
    np.testing.assert_allclose(fused.numpy(), want, atol=3e-11, rtol=3e-11)
    with degraded_mode(schedule="fused"):
        assert torch.equal(blocked.ggr_triangularize_blocked(X, 20, tile=8), fused)
    with degraded_mode(schedule="tree"):
        assert torch.equal(blocked.ggr_triangularize_blocked(X, 20, tile=8), tree)
    with pytest.raises(ValueError):
        blocked.ggr_triangularize_blocked(X, 20, schedule="bogus")
    with pytest.raises(ValueError):
        blocked.ggr_triangularize_blocked(X, 21)
    with pytest.raises(ValueError):
        blocked.ggr_triangularize_blocked(X, 20, schedule="fused", block_w=0)


def test_degraded_mode_outranks_auto(monkeypatch):
    """On a CPU tensor ``"auto"`` is tree; ``degraded_mode(schedule="fused")``
    outranks it (and an explicit schedule), also through ``ggr_lstsq``'s
    blocked route, which passes no schedule."""
    from repro_torch.solvers import ggr_lstsq

    X = torch.from_numpy(_rand((48, 20), 9, np.float64))
    tree = blocked.ggr_triangularize_blocked(X, 20, tile=8, schedule="tree")
    fused = blocked.ggr_triangularize_blocked(X, 20, tile=8, schedule="fused")
    assert not torch.equal(tree, fused)
    assert torch.equal(blocked.ggr_triangularize_blocked(X, 20, tile=8, schedule="auto"),
                       tree)
    with degraded_mode(schedule="fused"):
        for schedule in ("auto", "tree"):
            assert torch.equal(blocked.ggr_triangularize_blocked(
                X, 20, tile=8, schedule=schedule), fused)
    calls = []
    monkeypatch.setattr(blocked, "panel_factor",
                        lambda *a, **k: calls.append(1) or panel_factor(*a, **k))
    rng = np.random.default_rng(10)
    A = torch.from_numpy(rng.standard_normal((300, 130)))
    b = torch.from_numpy(rng.standard_normal((300, 2)))
    auto = ggr_lstsq(A, b)
    assert not calls  # "auto" on a CPU tensor: tree
    with degraded_mode(schedule="fused"):
        fit = ggr_lstsq(A, b)
    assert calls
    np.testing.assert_allclose(fit.x.numpy(), auto.x.numpy(), atol=1e-10)


@pytest.mark.parametrize("p", [1, 2, 5, 8])
def test_tree_levels_and_phases_match_jax(p):
    got = [(a.tolist(), b.tolist()) for a, b in blocked._tree_levels(p)]
    want = [(a.tolist(), b.tolist()) for a, b in jblocked._tree_levels(p)]
    assert got == want
    assert blocked._phase_schedule(p * 37, 16, p) == jblocked._phase_schedule(p * 37, 16, p)


def test_suffix_col_norms_match_jax():
    X = _rand((9, 4), 6, np.float32)
    np.testing.assert_allclose(blocked.suffix_col_norms(torch.from_numpy(X)).numpy(),
                               np.asarray(jblocked.suffix_col_norms(jnp.asarray(X))),
                               rtol=1e-6)


def test_mixed_precision_gemm_accumulates_wide():
    X = _rand((64, 40), 7, np.float32)
    out = blocked.ggr_triangularize_blocked(torch.from_numpy(X), 32, tile=16,
                                            precision="bf16")
    assert out.dtype == torch.bfloat16
    ref = np.asarray(jblocked.ggr_triangularize_blocked(
        jnp.asarray(X), 32, tile=16, schedule="tree", precision="bf16")
        .astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, atol=5e-2 * np.abs(ref).max())


def test_batched_lstsq_takes_the_blocked_route_per_problem():
    """A batch of (300, 130) systems — the serving lstsq kind at blocked
    sizes — equals a loop of single solves, through one batched tree pass."""
    from repro_torch.solvers import ggr_lstsq

    rng = np.random.default_rng(8)
    A = torch.from_numpy(rng.standard_normal((2, 300, 130)))
    b = torch.from_numpy(rng.standard_normal((2, 300, 3)))
    fit = ggr_lstsq(A, b)
    for i in range(2):
        one = ggr_lstsq(A[i], b[i])
        assert torch.equal(fit.x[i], one.x) and torch.equal(fit.resid[i], one.resid)
        np.testing.assert_allclose(one.x.numpy(), np.linalg.lstsq(A[i].numpy(), b[i].numpy(),
                                                                  rcond=None)[0], atol=1e-10)
