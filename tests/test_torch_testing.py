"""Port parity: repro_torch.testing against the JAX package's repro.testing —
the matrix suites bit for bit, the error metrics and budgets, the Kalman
fleet's NIS through the port's ``kf_step_batched``, and the fault injectors'
schedules."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve_qr as jserve_qr
from repro.serve.dispatch import ExecutableCache as JExecutableCache
from repro.testing import error_harness as jeh
from repro.testing import faults as jfaults
from repro_torch.launch import serve_qr
from repro_torch.serve import ExecutableCache
from repro_torch.testing import error_harness as eh
from repro_torch.testing import faults


def test_graded_and_rank_deficient_matrices_equal_the_reference():
    for m, n, cond, seed, spectrum in ((40, 24, 1e6, 3, "geometric"),
                                       (30, 30, 1e2, 4, "cliff")):
        np.testing.assert_array_equal(
            eh.graded_matrix(m, n, cond, seed, spectrum),
            jeh.graded_matrix(m, n, cond, seed, spectrum))
    np.testing.assert_array_equal(eh.rank_deficient_matrix(40, 20, 7, 1e8, 5),
                                  jeh.rank_deficient_matrix(40, 20, 7, 1e8, 5))
    for bad in (lambda mod: mod.graded_matrix(4, 8, 10.0),
                lambda mod: mod.graded_matrix(8, 4, 0.5),
                lambda mod: mod.graded_matrix(8, 4, 2.0, spectrum="flat"),
                lambda mod: mod.rank_deficient_matrix(8, 4, 5)):
        for mod in (eh, jeh):
            with pytest.raises(ValueError):
                bad(mod)


def test_suites_equal_the_reference():
    shapes = ((24, 16), (32, 12))
    ours = list(eh.matrix_suite(shapes, seed=2)) + list(
        eh.matrix_suite(shapes, (1e0, 1e3), seed=1, spectrum="cliff"))
    theirs = list(jeh.matrix_suite(shapes, seed=2)) + list(
        jeh.matrix_suite(shapes, (1e0, 1e3), seed=1, spectrum="cliff"))
    assert len(ours) == len(theirs) == 14
    for a, b in zip(ours, theirs):
        assert (a.name, a.cond) == (b.name, b.cond)
        np.testing.assert_array_equal(a.A, b.A)
    rank = list(eh.rank_deficient_suite(shapes, seed=4))
    jrank = list(jeh.rank_deficient_suite(shapes, seed=4))
    assert len(rank) == len(jrank) > 0
    for a, b in zip(rank, jrank):
        assert (a.name, a.cond, a.rank) == (b.name, b.cond, b.rank)
        np.testing.assert_array_equal(a.A, b.A)
    assert eh.DEFAULT_SHAPES == jeh.DEFAULT_SHAPES
    assert eh.DEFAULT_CONDS == jeh.DEFAULT_CONDS
    assert eh.DEFAULT_RANK_CONDS == jeh.DEFAULT_RANK_CONDS


@pytest.mark.parametrize("cond", [1e0, 1e4])
def test_metrics_equal_the_reference(cond):
    A = eh.graded_matrix(48, 16, cond, seed=6)
    Q, R = np.linalg.qr(A.astype(np.float32))
    R_ref = np.linalg.qr(A, mode="r") * -1.0  # an alien sign convention
    ours = eh.factorization_errors(A, torch.as_tensor(R), R_ref=R_ref,
                                   Q=torch.as_tensor(Q))
    theirs = jeh.factorization_errors(A, jnp.asarray(R), R_ref=R_ref, Q=jnp.asarray(Q))
    assert sorted(ours) == sorted(theirs) == [
        "backward_error", "forward_error", "gram_residual", "orthogonality_loss"]
    for k in ours:
        assert ours[k] == pytest.approx(theirs[k], rel=1e-12, abs=0.0), k
        assert ours[k] > 0.0
    # a full (m, n) triangularized matrix is cut to its top (n, n) block
    Rfull = np.vstack([R, np.zeros((32, 16), np.float32)])
    assert eh.gram_residual(A, Rfull) == pytest.approx(
        jeh.gram_residual(A, Rfull), rel=1e-12)
    np.testing.assert_array_equal(eh.sign_align(R, R_ref), jeh.sign_align(R, R_ref))
    assert eh.orthogonality_loss(A, R) == pytest.approx(
        jeh.orthogonality_loss(A, R), rel=1e-12)


def test_budgets_equal_the_reference():
    for dtype in ("float32", "bfloat16", "float16", "float64"):
        for metric in ("gram_residual", "backward_error", "orthogonality_loss",
                       "forward_error"):
            for m, n, cond in ((64, 48, 1.0), (192, 64, 1e4), (96, 80, 1e8)):
                assert eh.error_budget(dtype, metric, m, n, cond) == \
                    jeh.error_budget(dtype, metric, m, n, cond)
                for ceiling in (0.5, 1e-3):
                    assert eh.budget_is_meaningful(dtype, metric, m, n, cond, ceiling) \
                        == jeh.budget_is_meaningful(dtype, metric, m, n, cond, ceiling)
    with pytest.raises(ValueError):
        eh.error_budget("float32", "bogus", 4, 4)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32", "float64"])
def test_dtype_eps_equals_the_reference(dtype):
    eps = eh.dtype_eps(dtype)
    assert eps == jeh.dtype_eps(dtype)
    assert eh.dtype_eps(getattr(torch, dtype)) == eps
    if dtype != "bfloat16":
        assert eh.dtype_eps(np.dtype(dtype)) == eps


def test_fleet_nis_f32_equals_the_reference():
    kw = dict(B=4, n=4, w=3, p=2, T=20, seed=3, backend="pallas")
    ours = eh.fleet_nis(**kw, device="cpu")
    theirs = jeh.fleet_nis(**kw)
    assert ours.shape == (4,)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)
    assert np.all(0.5 * 2 < ours) and np.all(ours < 2.0 * 2)


class _Disp:
    """The one attribute of a dispatcher the injector reaches."""

    def __init__(self, cache):
        self.executables = cache


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_fault_injector_fires_what_the_reference_fires(seed):
    plan = dict(seed=seed, transient_rate=0.3, transient_limit=6,
                poison_rate=0.2, latency_rate=0.25, latency_s=0.5,
                evict_rate=0.15, kinds=("append", "lstsq"))

    def trace(mod, cache):
        slept = []
        inj = mod.FaultInjector(mod.FaultPlan(**plan), sleep=slept.append)
        disp = _Disp(cache)
        out = []
        for i in range(60):
            cache.get(i, lambda: i)
            kind = ("append", "lstsq", "kalman")[i % 3]
            try:
                inj.on_dispatch(kind=kind, rung="native", dispatcher=disp)
                out.append("ok")
            except (mod.InjectedTransient, mod.InjectedPoison) as e:
                out.append(type(e).__name__)
            out.append(len(cache))
        return out, dict(inj.counts), slept

    ours = trace(faults, ExecutableCache(8))
    theirs = trace(jfaults, JExecutableCache(8))
    assert ours == theirs
    counts = ours[1]
    assert counts["transient"] == 6 and min(counts.values()) >= 1
    assert set(counts) == {"transient", "poison", "latency", "evict"}


def test_scripted_injector_equals_the_reference():
    ours, theirs = faults.ScriptedInjector({1, 3}), jfaults.ScriptedInjector({1, 3})
    for i in range(5):
        raised = []
        for inj, exc in ((ours, faults.InjectedTransient),
                         (theirs, jfaults.InjectedTransient)):
            try:
                inj.on_dispatch(kind="append", rung="native", dispatcher=None)
                raised.append(None)
            except exc as e:
                raised.append(str(e))
        assert raised[0] == raised[1]
        assert (raised[0] is not None) == (i in (1, 3))


@pytest.mark.parametrize("device_tensors", [False, True])
def test_poison_workload_equals_the_reference(device_tensors):
    reqs = serve_qr.make_workload(40, 5, 3, 1, seed=8, device="cpu")
    jreqs = jserve_qr.make_workload(40, 5, 3, 1, seed=8)
    if device_tensors:  # every first operand a tensor, as on the card
        reqs = [(r[0], torch.as_tensor(r[1]), *r[2:]) for r in reqs]
    before = [r[1].clone() if device_tensors else r[1].copy() for r in reqs]
    snapshot = list(reqs)
    out, idx = faults.poison_workload(reqs, 0.1, seed=12)
    jout, jidx = jfaults.poison_workload(jreqs, 0.1, seed=12)
    assert idx == jidx and len(idx) == 4
    assert reqs == snapshot  # the input list itself is untouched
    for r, b in zip(reqs, before):
        if device_tensors:
            assert torch.equal(r[1], b)
        else:
            np.testing.assert_array_equal(r[1], b)
    for i, (r, jr) in enumerate(zip(out, jout)):
        a = r[1].numpy() if device_tensors else r[1]
        np.testing.assert_array_equal(a, np.asarray(jr[1]))
        assert isinstance(r[1], torch.Tensor) == device_tensors
        assert (i in idx) == (not np.isfinite(a).all())
        assert all(x is y for x, y in zip(r[2:], reqs[i][2:]))  # passed through
    assert faults.poison_workload(reqs, 0.0) == (list(reqs), [])
