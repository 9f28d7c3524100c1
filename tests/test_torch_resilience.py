"""Fault-tolerant serving in the port: repro_torch.serve.resilience and the
fault-injection harness of repro_torch.testing.faults.

The first classes mirror the JAX package's ``tests/test_resilience.py`` one
for one, against the port on CPU tensors (failure classification and typed
``ServeError`` results, retry policy, circuit breaker, the degradation
ladder, quarantine at all three stages, drain/pump aggregation, the eager
purge, zero-fault identity, the state vault, the injectors).  The rest hold
the port against the reference: the torch error names, retry delays and
salts, group keys, breaker sequences, each rung's result against the
reference's rung of the same name, the chaos schedule and its quarantines,
survivors' bits, and vault directories that restore across packages.
"""
import contextlib
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve_qr as jserve_qr
from repro.serve import ContinuousBatcher as JContinuousBatcher
from repro.serve import resilience as jres
from repro.serve.requests import make_request as jmake_request
from repro.solvers.lstsq import RLSState as JRLSState
from repro.testing import faults as jfaults
from repro_torch import obs
from repro_torch.launch.serve_qr import QRServer, _as_tuple, make_workload
from repro_torch.serve import (
    DEFAULT_LADDER,
    CircuitBreaker,
    ContinuousBatcher,
    Dispatcher,
    DrainError,
    IntegrityError,
    PoisonedError,
    ResilientDispatcher,
    RetryPolicy,
    Rung,
    ServeError,
    StateVault,
    classify_failure,
    make_request,
    resilience,
)
from repro_torch.solvers.lstsq import RLSState, state_integrity
from repro_torch.testing.faults import (
    FaultInjector,
    FaultPlan,
    InjectedFatal,
    InjectedPoison,
    InjectedTransient,
    ScriptedInjector,
    inject,
    poison_workload,
)

_NO_SLEEP = lambda s: None  # noqa: E731


def _counter_sum(reg, name, **labels):
    return sum(m.value for m in reg.collect()
               if m.name == name
               and all(dict(m.labels).get(k) == v for k, v in labels.items()))


def _append_args(rng, n=6, p=3, dtype=np.float32):
    R = np.triu(rng.standard_normal((n, n))).astype(dtype)
    np.fill_diagonal(R, np.abs(np.diag(R)) + 1.0)
    return R, rng.standard_normal((p, n)).astype(dtype)


def _fast(**kw):
    kw.setdefault("backend", "reference")
    kw.setdefault("sleep", _NO_SLEEP)
    kw.setdefault("device", "cpu")
    return ResilientDispatcher(**kw)


def _same_bits(a, b) -> bool:
    a, b = _as_tuple(a), _as_tuple(b)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------- classification
class TestClassification:
    def test_attribute_wins(self):
        assert classify_failure(InjectedTransient("x")) == "transient"
        assert classify_failure(InjectedPoison("x")) == "poisoned"
        assert classify_failure(InjectedFatal("x")) == "fatal"

    def test_floating_point_error_is_poisoned(self):
        assert classify_failure(FloatingPointError("nan")) == "poisoned"

    def test_device_runtime_by_name(self):
        AcceleratorError = type("AcceleratorError", (RuntimeError,), {})
        assert classify_failure(AcceleratorError("CUDA error: unspecified")) == \
            "transient"
        assert classify_failure(MemoryError()) == "transient"

    def test_default_fatal(self):
        assert classify_failure(ValueError("shape mismatch")) == "fatal"

    def test_serve_error_carries_context(self):
        err = ServeError(kind="lstsq", classification="transient",
                         reason="retries exhausted",
                         cause=InjectedTransient("boom"))
        assert err.kind == "lstsq"
        assert err.classification == "transient"
        assert isinstance(err, RuntimeError)
        assert issubclass(PoisonedError, ServeError)


class TestTorchClassification:
    def test_torch_error_types_are_transient(self):
        assert classify_failure(torch.OutOfMemoryError("CUDA out of memory")) == \
            "transient"
        assert classify_failure(torch.cuda.OutOfMemoryError("x")) == "transient"
        assert torch.AcceleratorError.__name__ == "AcceleratorError"
        assert "AcceleratorError" in resilience._TRANSIENT_NAMES

    def test_the_kernel_bindings_runtime_error_is_fatal(self):
        # the binding's errors for a failed nvcc and a refused launch
        assert classify_failure(RuntimeError("nvcc failed:\nggr_update.cu")) == "fatal"
        assert classify_failure(RuntimeError(
            "ggr_update_f32 launch failed: invalid argument")) == "fatal"
        # a bf16 tile on a CUDA tensor has no kernel
        assert classify_failure(NotImplementedError("no CUDA kernel")) == "fatal"

    def test_fatal_resolves_tickets_without_degrading(self):
        rng = np.random.default_rng(30)
        d = _fast()
        eng = ContinuousBatcher(d)
        with inject(ScriptedInjector({0}, exc=lambda m: RuntimeError(m))):
            t = eng.submit("append", *_append_args(rng))
            eng.flush()
        with pytest.raises(ServeError) as ei:
            eng.result(t)
        assert ei.value.classification == "fatal"
        prov = d.provenance[(t.group, t.cycle)][0]
        assert prov.rung == "native" and prov.attempts == 1


# ------------------------------------------------------------- retry policy
class TestRetryPolicy:
    def test_delay_grows_and_is_deterministic(self):
        pol = RetryPolicy(max_attempts=4, backoff=0.01,
                          backoff_factor=2.0, jitter=0.0)
        d = [pol.delay(a, salt=42) for a in (1, 2, 3)]
        assert d == [pol.delay(a, salt=42) for a in (1, 2, 3)]
        assert d[1] > d[0] and d[2] > d[1]

    def test_jitter_bounded_and_varies_by_salt(self):
        pol = RetryPolicy(backoff=0.01, jitter=0.5)
        assert pol.delay(1, salt=1) != pol.delay(1, salt=2)
        for salt in range(32):
            d = pol.delay(1, salt=salt)
            assert 0.005 <= d <= 0.015  # base * [1-jitter, 1+jitter]

    def test_zero_backoff(self):
        assert RetryPolicy(backoff=0.0).delay(5, salt=9) == 0.0


# ---------------------------------------------------------- circuit breaker
class TestCircuitBreaker:
    def test_lifecycle(self):
        t = [0.0]
        br = CircuitBreaker(failure_threshold=2, cooldown=10.0,
                            clock=lambda: t[0])
        assert br.state == "closed" and br.allow()
        br.record_failure()
        assert br.state == "closed"
        br.record_failure()
        assert br.state == "open" and not br.allow()
        t[0] = 11.0
        assert br.state == "half_open" and br.allow()
        br.record_failure()  # half-open failure trips straight back
        assert br.state == "open"
        t[0] = 22.0
        assert br.state == "half_open"
        br.record_success()
        assert br.state == "closed" and br.allow()

    def test_success_resets_failure_count(self):
        br = CircuitBreaker(failure_threshold=2, clock=lambda: 0.0)
        br.record_failure()
        br.record_success()
        br.record_failure()
        assert br.state == "closed"

    def test_open_breaker_skips_rung(self):
        rng = np.random.default_rng(0)
        with obs.collecting() as reg:
            d = _fast(retry=RetryPolicy(max_attempts=1),
                      breaker_threshold=1, breaker_cooldown=1e9)
            eng = ContinuousBatcher(d)
            # one fatal trips the (append, rung 0) breaker instantly
            with inject(ScriptedInjector({0}, exc=InjectedFatal)):
                t0 = eng.submit("append", *_append_args(rng))
                eng.flush()
            with pytest.raises(ServeError):
                eng.result(t0)
            # next dispatch must skip the open native rung
            t1 = eng.submit("append", *_append_args(rng))
            eng.flush()
            eng.result(t1)
        prov = d.provenance[(t1.group, t1.cycle)][0]
        assert prov.rung == DEFAULT_LADDER[1].name
        assert _counter_sum(reg, "serve.degraded_dispatches",
                            reason="breaker_open") >= 1
        assert _counter_sum(reg, "serve.breaker_state") >= 0  # family exists


# ------------------------------------------------------- retry then degrade
class TestRetryAndDegrade:
    def test_transient_retried_then_succeeds(self):
        rng = np.random.default_rng(1)
        with obs.collecting() as reg:
            d = _fast(retry=RetryPolicy(max_attempts=3, backoff=0.0))
            eng = ContinuousBatcher(d)
            with inject(ScriptedInjector({0})):
                t = eng.submit("append", *_append_args(rng))
                eng.flush()
            R = eng.result(t)
        assert torch.isfinite(R).all()
        prov = d.provenance[(t.group, t.cycle)][0]
        assert prov.rung == "native" and prov.attempts == 2
        assert _counter_sum(reg, "serve.retries") == 1
        assert _counter_sum(reg, "serve.chunk_failures") == 1

    @pytest.mark.parametrize("k", range(1, len(DEFAULT_LADDER)))
    def test_each_rung_reachable_and_agrees(self, k):
        rng = np.random.default_rng(2)
        R, U = _append_args(rng, n=8, p=4)
        d0 = _fast(retry=RetryPolicy(max_attempts=1))
        e0 = ContinuousBatcher(d0)
        t0 = e0.submit("append", R, U)
        e0.flush()
        native = e0.result(t0).numpy()
        with obs.collecting() as reg:
            d = _fast(retry=RetryPolicy(max_attempts=1))
            eng = ContinuousBatcher(d)
            with inject(ScriptedInjector(set(range(k)))):
                t = eng.submit("append", R, U)
                eng.flush()
            out = eng.result(t).numpy()
        prov = d.provenance[(t.group, t.cycle)][0]
        assert prov.rung == DEFAULT_LADDER[k].name
        np.testing.assert_allclose(out, native, rtol=1e-4, atol=1e-5)
        assert _counter_sum(reg, "serve.degraded_dispatches",
                            to=DEFAULT_LADDER[k].name) >= 1

    def test_ladder_exhausted_resolves_serve_error(self):
        rng = np.random.default_rng(3)
        d = _fast(ladder=(Rung("native"),),
                  retry=RetryPolicy(max_attempts=2, backoff=0.0))
        eng = ContinuousBatcher(d)
        with inject(ScriptedInjector(set(range(16)))):
            t = eng.submit("append", *_append_args(rng))
            eng.flush()
        with pytest.raises(ServeError) as ei:
            eng.result(t)
        assert ei.value.classification == "transient"
        prov = d.provenance[(t.group, t.cycle)][0]
        assert prov.error is not None

    def test_kind_budget_caps_retries(self):
        rng = np.random.default_rng(4)
        d = _fast(retry=RetryPolicy(max_attempts=5, backoff=0.0,
                                    kind_budget=1))
        eng = ContinuousBatcher(d)
        with inject(ScriptedInjector(set(range(3)))):
            t = eng.submit("append", *_append_args(rng))
            eng.flush()
        eng.result(t)
        prov = d.provenance[(t.group, t.cycle)][0]
        # budget of 1 retry: attempt 2 fails -> degrade (not retry again)
        assert prov.rung != "native"

    def test_double_buffer_rejected(self):
        with pytest.raises(ValueError):
            ResilientDispatcher(backend="reference", device="cpu",
                                double_buffer=True)


# --------------------------------------------------------------- quarantine
class TestQuarantine:
    def test_precheck_rejects_nonfinite_operand(self):
        rng = np.random.default_rng(5)
        R, U = _append_args(rng)
        U_bad = U.copy()
        U_bad[0, 0] = np.inf
        with obs.collecting() as reg:
            eng = ContinuousBatcher(_fast())
            t_bad = eng.submit("append", R, U_bad)
            t_ok = eng.submit("append", R, U)
            eng.flush()
            with pytest.raises(PoisonedError, match="operand #1"):
                eng.result(t_bad)
            assert torch.isfinite(eng.result(t_ok)).all()
        assert _counter_sum(reg, "serve.quarantined", stage="precheck") == 1

    def test_postcheck_isolates_nan_lane(self):
        rng = np.random.default_rng(6)
        A = rng.standard_normal((12, 3)).astype(np.float32)
        b = rng.standard_normal((12, 1)).astype(np.float32)
        A_bad = A.copy()
        A_bad[0, 0] = np.nan
        with obs.collecting() as reg:
            eng = ContinuousBatcher(_fast(precheck=False))
            t_bad = eng.submit("lstsq", A_bad, b)
            t_ok = eng.submit("lstsq", A, b)
            eng.flush()
            with pytest.raises(PoisonedError):
                eng.result(t_bad)
            x, _ = eng.result(t_ok)
        solo = QRServer(backend="reference", device="cpu")
        ts = solo.submit_lstsq(A, b)
        solo.flush()
        xs, _ = solo.result(ts)
        np.testing.assert_allclose(x.numpy(), xs.numpy(), rtol=1e-4, atol=1e-5)
        assert _counter_sum(reg, "serve.quarantined", stage="postcheck") >= 1

    def test_bisection_isolates_poisoned_request(self):
        """An executor-raised poison (no NaN operand, so precheck cannot
        see it) is pinned to ONE request by bisection; neighbours keep
        their results."""
        rng = np.random.default_rng(7)
        reqs = [_append_args(rng) for _ in range(6)]
        marked = torch.as_tensor(reqs[3][1])

        class MarkedPoison:
            def on_dispatch(self, kind, rung, dispatcher, chunk=None):
                if chunk and any(torch.equal(r.arrays[1], marked) for r in chunk):
                    raise InjectedPoison("marked request present")

        with obs.collecting() as reg:
            eng = ContinuousBatcher(_fast())
            with inject(MarkedPoison()):
                tickets = [eng.submit("append", R, U) for R, U in reqs]
                eng.flush()
            for i, t in enumerate(tickets):
                if i == 3:
                    with pytest.raises(PoisonedError):
                        eng.result(t)
                else:
                    assert torch.isfinite(eng.result(t)).all()
        assert _counter_sum(reg, "serve.quarantined", stage="bisect") == 1

    def test_quarantine_remainder_keeps_original_padded_bits(self):
        """Survivors of a precheck quarantine must be re-padded to the
        ORIGINAL chunk width so their bits match the fault-free run."""
        rng = np.random.default_rng(8)
        A = [rng.standard_normal((12, 3)).astype(np.float32)
             for _ in range(3)]
        b = [rng.standard_normal((12, 1)).astype(np.float32)
             for _ in range(3)]
        clean = ContinuousBatcher(_fast())
        t_clean = [clean.submit("lstsq", Ai, bi) for Ai, bi in zip(A, b)]
        clean.flush()
        want = [_as_tuple(clean.result(t))[0] for t in t_clean]

        A_bad = A[1].copy()
        A_bad[0, 0] = np.nan
        eng = ContinuousBatcher(_fast())
        t0 = eng.submit("lstsq", A[0], b[0])
        tb = eng.submit("lstsq", A_bad, b[1])
        t2 = eng.submit("lstsq", A[2], b[2])
        eng.flush()
        with pytest.raises(PoisonedError):
            eng.result(tb)
        for t, ref in ((t0, want[0]), (t2, want[2])):
            assert torch.equal(_as_tuple(eng.result(t))[0], ref)


# ------------------------------------------------------------- drain/pump
class TestDrainAggregation:
    def test_drain_attempts_every_chunk(self, monkeypatch):
        rng = np.random.default_rng(9)
        d = Dispatcher(backend="reference", max_batch=2, double_buffer=True,
                       device="cpu")
        eng = ContinuousBatcher(d, admit_max=2, retain_cycles=None)
        tickets = [eng.submit("append", *_append_args(rng))
                   for _ in range(6)]
        flights = list(d._inflight)
        assert len(flights) == 3
        boom = RuntimeError("deferred device error")

        def bad_block():
            raise boom

        monkeypatch.setattr(flights[0], "block", bad_block)
        with pytest.raises(DrainError) as ei:
            eng.drain()
        assert [e for _, e in ei.value.failures] == [boom]
        assert "1 in-flight chunk(s)" in str(ei.value)
        # every chunk was attempted — the failure orphaned nobody
        assert d._inflight == []
        assert all(f.finalized for f in flights)
        for t in tickets:
            assert torch.isfinite(eng.result(t)).all()

    def test_pump_failure_does_not_block_neighbors(self, monkeypatch):
        rng = np.random.default_rng(20)
        with obs.collecting():
            d = Dispatcher(backend="reference", max_batch=2,
                           double_buffer=True, device="cpu")
            eng = ContinuousBatcher(d, admit_max=2, retain_cycles=None)
            for _ in range(4):
                eng.submit("append", *_append_args(rng))
            flights = list(d._inflight)
            boom = RuntimeError("deferred device error")

            def bad_block():
                raise boom

            monkeypatch.setattr(flights[0], "block", bad_block)
            deadline = time.time() + 30.0
            while not all(f.ready() for f in flights):
                assert time.time() < deadline
                time.sleep(0.01)
            with pytest.raises(DrainError) as ei:
                d.pump()
        assert [e for _, e in ei.value.failures] == [boom]
        assert all(f.finalized for f in flights)
        assert d._inflight == []

    def test_drain_clean_path_unchanged(self):
        rng = np.random.default_rng(10)
        d = Dispatcher(backend="reference", double_buffer=True, device="cpu")
        eng = ContinuousBatcher(d)
        t = eng.submit("append", *_append_args(rng))
        eng.flush()
        eng.drain()
        assert torch.isfinite(eng.result(t)).all()
        assert d._inflight == []


# ----------------------------------------------------------- eager purge
class TestCyclePurge:
    def test_fully_errored_cycle_purged(self):
        rng = np.random.default_rng(11)
        with obs.collecting() as reg:
            d = _fast(ladder=(Rung("native"),),
                      retry=RetryPolicy(max_attempts=1))
            eng = ContinuousBatcher(d)
            with inject(ScriptedInjector(set(range(16)))):
                t = eng.submit("append", *_append_args(rng))
                eng.flush()
            with pytest.raises(ServeError):
                eng.result(t)
            with pytest.raises(ServeError):
                eng.result(t)  # purged entry keeps resolving, not KeyError
            eng.drain()  # purged cycles must not break drain
        assert _counter_sum(reg, "serve.cycles_purged") == 1

    def test_mixed_cycle_not_purged(self):
        rng = np.random.default_rng(12)
        R, U = _append_args(rng)
        U_bad = U.copy()
        U_bad[0, 0] = np.nan
        with obs.collecting() as reg:
            eng = ContinuousBatcher(_fast())
            t_bad = eng.submit("append", R, U_bad)
            t_ok = eng.submit("append", R, U)
            eng.flush()
            with pytest.raises(PoisonedError):
                eng.result(t_bad)
            assert torch.isfinite(eng.result(t_ok)).all()
        assert _counter_sum(reg, "serve.cycles_purged") == 0


# ----------------------------------------------------- zero-fault identity
class TestByteCompatibility:
    @pytest.mark.parametrize("backend", ["pallas", "reference"])
    def test_resilient_matches_plain_dispatcher(self, backend):
        reqs = make_workload(24, 8, 4, 1, seed=13, device="cpu")
        plain = QRServer(backend=backend, device="cpu")
        resil = QRServer(backend=backend, device="cpu", resilient=True)
        tp = [getattr(plain, f"submit_{r[0]}")(*r[1:]) for r in reqs]
        tr = [getattr(resil, f"submit_{r[0]}")(*r[1:]) for r in reqs]
        plain.flush()
        resil.flush()
        for a, b in zip(tp, tr):
            assert _same_bits(plain.result(a), resil.result(b))
        provs = resil._engine.dispatcher.provenance.values()
        assert {(p.rung, p.attempts) for ps in provs for p in ps} == {("native", 1)}

    @pytest.mark.parametrize("max_cond", [None, 1e6])
    def test_host_reads_per_chunk_do_not_grow_with_its_size(self, monkeypatch, max_cond):
        """The pre- and post-check read one mask each per chunk, whatever its
        size: count the host reads a resilient dispatch adds over a plain
        one of the same chunk."""
        reads = [0]
        for meth in ("cpu", "item", "tolist", "__bool__", "__float__", "__int__"):
            real = getattr(torch.Tensor, meth)

            def counted(self, *a, _real=real, **k):
                reads[0] += 1
                return _real(self, *a, **k)

            monkeypatch.setattr(torch.Tensor, meth, counted)

        def added(size):
            reqs = [r for r in make_workload(8 * size, 6, 3, 1, seed=24, device="cpu")
                    if r[0] == "kalman"][:size]
            counts = []
            for disp in (Dispatcher(device="cpu", max_batch=size),
                         _fast(backend="pallas", max_batch=size, max_cond=max_cond)):
                batch = [make_request(*r, device="cpu") for r in reqs]
                reads[0] = 0
                disp.dispatch(batch[0].group, batch)
                counts.append(reads[0])
            return counts[1] - counts[0]

        small, large = added(8), added(64)
        assert small == large and 1 <= small <= 4, (small, large)

    def test_provenance_records_native_single_attempt(self):
        rng = np.random.default_rng(14)
        d = _fast()
        eng = ContinuousBatcher(d)
        t = eng.submit("append", *_append_args(rng))
        eng.flush()
        eng.result(t)
        prov = d.provenance[(t.group, t.cycle)][0]
        assert prov.rung == "native" and prov.attempts == 1
        assert prov.error is None and not prov.quarantined


# -------------------------------------------------------------- state vault
class TestStateVault:
    def _state(self, rng, n=4, k=1):
        A = rng.standard_normal((8, n)).astype(np.float32)
        R = np.triu(np.linalg.qr(A)[1]).astype(np.float32)
        return RLSState(R=torch.as_tensor(R),
                        d=torch.as_tensor(
                            rng.standard_normal((n, k)).astype(np.float32)),
                        count=torch.tensor(8, dtype=torch.int32))

    @staticmethod
    def _nan_at(state, i, j, value=float("nan")):
        R = state.R.clone()
        R[i, j] = value
        return state._replace(R=R)

    def test_snapshot_cadence_and_gc(self, tmp_path):
        rng = np.random.default_rng(15)
        vault = StateVault(root=str(tmp_path), interval=2, keep=2)
        written = [vault.snapshot("m", self._state(rng)) for _ in range(6)]
        assert [w is not None for w in written] == [False, True] * 3
        steps = sorted(os.listdir(tmp_path / "m"))
        assert steps == ["step_00000004", "step_00000006"]  # gc kept `keep`
        assert vault.snapshot("m", self._state(rng), force=True) is not None

    def test_restore_falls_back_past_corruption(self, tmp_path):
        rng = np.random.default_rng(16)
        vault = StateVault(root=str(tmp_path), interval=1, keep=4)
        good = self._state(rng)
        vault.snapshot("m", good)
        bad = self._nan_at(good, 0, 0)
        vault.snapshot("m", bad)
        with obs.collecting() as reg:
            restored, step = vault.restore_latest("m", like=good)
        assert torch.equal(restored.R, good.R)
        assert step == 1  # fell back past the newest (corrupt) snapshot
        assert _counter_sum(reg, "serve.state_restores", outcome="rejected") == 1
        assert _counter_sum(reg, "serve.state_restores", outcome="ok") == 1

    def test_all_corrupt_raises_integrity_error(self, tmp_path):
        rng = np.random.default_rng(17)
        vault = StateVault(root=str(tmp_path), interval=1)
        good = self._state(rng)
        vault.snapshot("m", self._nan_at(good, 0, 0))
        with pytest.raises(IntegrityError):
            vault.restore_latest("m", like=good)
        with pytest.raises(IntegrityError, match="no snapshots"):
            vault.restore_latest("absent", like=good)

    def test_state_integrity_cond_gate(self, tmp_path):
        rng = np.random.default_rng(18)
        ok_state = self._state(rng)
        ok, _ = state_integrity(ok_state)
        assert ok
        ill = self._nan_at(ok_state, -1, -1, 1e-12)
        ok, reason = state_integrity(ill, max_cond=1e3)
        assert not ok and "cond" in reason
        # the vault's gate is the same: an ill-conditioned newest snapshot
        # falls back to the well-conditioned one before it
        vault = StateVault(root=str(tmp_path), interval=1, max_cond=1e3)
        vault.snapshot("m", ok_state)
        vault.snapshot("m", ill)
        restored, step = vault.restore_latest("m", like=ok_state)
        assert step == 1 and torch.equal(restored.R, ok_state.R)

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_vault_directories_restore_across_packages(self, tmp_path, writer):
        rng = np.random.default_rng(19)
        R, _ = _append_args(rng, n=5)
        d = rng.standard_normal((5, 1)).astype(np.float32)
        states = []
        for i in range(3):
            Ri = R * (i + 1)
            states.append((JRLSState(R=jnp.asarray(Ri), d=jnp.asarray(d),
                                     count=jnp.asarray(i, jnp.int32)),
                           RLSState(R=torch.as_tensor(Ri), d=torch.as_tensor(d),
                                    count=torch.tensor(i, dtype=torch.int32))))
        # the newest snapshot is corrupt: both packages fall back past it
        Rbad = R.copy()
        Rbad[1, 1] = np.nan
        states.append((JRLSState(R=jnp.asarray(Rbad), d=jnp.asarray(d),
                                 count=jnp.asarray(3, jnp.int32)),
                       RLSState(R=torch.as_tensor(Rbad), d=torch.as_tensor(d),
                                count=torch.tensor(3, dtype=torch.int32))))
        jv = jres.StateVault(root=str(tmp_path), interval=1, keep=3)
        pv = StateVault(root=str(tmp_path), interval=1, keep=3)
        for js, ps in states:
            (jv if writer == "jax" else pv).snapshot("m", js if writer == "jax" else ps)
        ours, step = pv.restore_latest("m", like=states[0][1])
        theirs, jstep = jv.restore_latest("m", like=states[0][0])
        assert step == jstep == 3  # steps 2, 3, 4 kept; 4 is corrupt
        want = states[2][1]
        assert torch.equal(ours.R, want.R) and torch.equal(ours.d, want.d)
        assert torch.equal(ours.count, want.count)
        np.testing.assert_array_equal(np.asarray(theirs.R), want.R.numpy())
        np.testing.assert_array_equal(np.asarray(theirs.d), want.d.numpy())


# ------------------------------------------------------------ the injectors
class TestFaultHarness:
    def test_plan_deterministic_per_seed(self):
        def trace(seed):
            inj = FaultInjector(FaultPlan(seed=seed, transient_rate=0.5),
                                sleep=_NO_SLEEP)
            out = []
            for _ in range(32):
                try:
                    inj.on_dispatch(kind="append", rung="native",
                                    dispatcher=None)
                    out.append(0)
                except InjectedTransient:
                    out.append(1)
            return out

        assert trace(3) == trace(3)
        assert trace(3) != trace(4)

    def test_transient_limit(self):
        inj = FaultInjector(FaultPlan(seed=0, transient_rate=1.0,
                                      transient_limit=2), sleep=_NO_SLEEP)
        raised = 0
        for _ in range(8):
            try:
                inj.on_dispatch(kind="append", rung="native",
                                dispatcher=None)
            except InjectedTransient:
                raised += 1
        assert raised == 2

    def test_kind_filter(self):
        inj = FaultInjector(FaultPlan(seed=0, transient_rate=1.0,
                                      kinds=("lstsq",)), sleep=_NO_SLEEP)
        inj.on_dispatch(kind="append", rung="native", dispatcher=None)
        with pytest.raises(InjectedTransient):
            inj.on_dispatch(kind="lstsq", rung="native", dispatcher=None)

    def test_poison_workload_pure(self):
        reqs = make_workload(8, 6, 3, 1, seed=19, device="cpu")
        before = [np.asarray(r[1]).copy() for r in reqs]
        poisoned, idx = poison_workload(reqs, 0.25, seed=19)
        assert len(idx) == 2
        for r, b in zip(reqs, before):
            assert np.array_equal(np.asarray(r[1]), b)  # input untouched
        for i in idx:
            assert not np.isfinite(np.asarray(poisoned[i][1])).all()

    def test_injector_install_is_scoped(self):
        sentinel = ScriptedInjector(set())
        with inject(sentinel) as got:
            assert got is sentinel
            assert resilience.get_injector() is sentinel
        assert resilience.get_injector() is not sentinel

    def test_eviction_clears_the_dispatchers_cache(self):
        d = _fast()
        d.executables.get("k", lambda: object())
        assert len(d.executables) == 1
        inj = FaultInjector(FaultPlan(seed=0, evict_rate=1.0), sleep=_NO_SLEEP)
        inj.on_dispatch(kind="append", rung="native", dispatcher=d)
        assert len(d.executables) == 0 and inj.counts["evict"] == 1
        assert d.executables.misses == 1  # counters survive a storm


# ------------------------------------------------- parity with the reference
_KEYS = [("append", ((8, 8), "float32", (4, 8), "float32", None)),
         ("lstsq", ((32, 8), "float64", (32, 1), "float64")),
         ("kalman", ((4, 4), "float32", (4,), "float32")),
         ("lstsq_pivoted", ((16, 4), "float32", (16, 2), "float32"))]


class TestParityWithReference:
    def test_delays_and_salts_equal_the_reference(self):
        for pol in (RetryPolicy(), RetryPolicy(backoff=0.01, jitter=0.5),
                    RetryPolicy(backoff=0.002, backoff_factor=3.0, jitter=0.0)):
            jpol = jres.RetryPolicy(*pol)
            for key in _KEYS:
                for rung_i in range(5):
                    salt = resilience._salt(key, rung_i)
                    assert salt == jres._salt(key, rung_i)
                    for attempt in range(0, 7):
                        assert pol.delay(attempt, salt) == jpol.delay(attempt, salt)

    def test_group_keys_equal_the_reference(self):
        reqs = make_workload(16, 6, 3, 2, seed=21, device="cpu")
        jreqs = jserve_qr.make_workload(16, 6, 3, 2, seed=21)
        kinds = set()
        for r, jr in zip(reqs, jreqs):
            key = make_request(r[0], *r[1:], device="cpu").group
            jkey = jmake_request(jr[0], *jr[1:]).group
            assert key == jkey
            kinds.add(key[0])
            for rung_i in range(4):
                assert resilience._salt(key, rung_i) == jres._salt(jkey, rung_i)
        assert kinds == {"append", "lstsq", "kalman", "lstsq_pivoted"}

    def test_breaker_sequences_equal_the_reference(self):
        def run(cls):
            t = [0.0]
            seen = []
            br = cls(failure_threshold=3, cooldown=5.0, clock=lambda: t[0],
                     on_state=seen.append)
            script = "ffsfff" + "t" * 6 + "f" + "t" * 6 + "sffftttttts"
            trace = []
            for op in script:
                if op == "f":
                    br.record_failure()
                elif op == "s":
                    br.record_success()
                else:
                    t[0] += 1.0
                trace.append((br.state, br.allow()))
            return trace, seen

        ours, theirs = run(CircuitBreaker), run(jres.CircuitBreaker)
        assert ours == theirs
        assert {"closed", "open", "half_open"} <= set(ours[1])

    @pytest.mark.parametrize("dtype", [np.float64, np.float32])
    def test_each_rung_agrees_with_the_references_rung(self, dtype):
        rng = np.random.default_rng(22)
        R, U = _append_args(rng, n=8, p=4, dtype=dtype)
        tol = (dict(rtol=1e-10, atol=1e-10) if dtype == np.float64
               else dict(rtol=1e-4, atol=1e-5))
        jladder = [r.name for r in jres.DEFAULT_LADDER]
        for k, rung in enumerate(DEFAULT_LADDER):
            d = _fast(backend="pallas", retry=RetryPolicy(max_attempts=1))
            eng = ContinuousBatcher(d)
            with inject(ScriptedInjector(set(range(k)))):
                t = eng.submit("append", R, U)
                eng.flush()
            ours = eng.result(t)
            assert d.provenance[(t.group, t.cycle)][0].rung == rung.name
            jk = jladder.index(rung.name)
            jd = jres.ResilientDispatcher(backend="pallas", sleep=_NO_SLEEP,
                                          retry=jres.RetryPolicy(max_attempts=1))
            jeng = JContinuousBatcher(jd)
            with jfaults.inject(jfaults.ScriptedInjector(set(range(jk)))):
                jt = jeng.submit("append", R, U)
                jeng.flush()
            assert jd.provenance[(jt.group, jt.cycle)][0].rung == rung.name
            theirs = np.asarray(jeng.result(jt))
            assert ours.numpy().dtype == theirs.dtype
            np.testing.assert_allclose(ours.numpy(), theirs, **tol)

    @pytest.mark.parametrize("override", [("interpret", True), ("mesh", None)])
    def test_a_rung_naming_a_missing_knob_is_refused(self, override):
        """The port has no interpret knob at all; ``mesh`` is a dispatcher
        field (sharded serving), so a rung may override it — but it is no
        knob of ``degraded_mode``."""
        rung = Rung("x", overrides=(override,))
        if override[0] == "mesh":
            assert _fast(ladder=(Rung("native"), rung)).ladder[1] == rung
        else:
            with pytest.raises(ValueError, match="does not have"):
                _fast(ladder=(Rung("native"), rung))
        with pytest.raises(ValueError, match="does not have"):
            _fast(ladder=(Rung("native"), Rung("x", kernel=(override,))))
        assert "interpret" not in [r.name for r in DEFAULT_LADDER]

    def test_precheck_verdicts_equal_the_reference(self):
        """Which requests the pre-check quarantines, and the first bad
        operand each reason names, with a fleet-shared model tensor that
        is itself poisoned (checked once for all the lanes that use it)."""
        rng = np.random.default_rng(23)
        n, p = 4, 2
        F_bad = np.eye(n, dtype=np.float32)
        F_bad[1, 2] = np.nan
        F_shared = torch.as_tensor(F_bad)
        reqs = []
        for i in range(7):
            R, _ = _append_args(rng, n=n, p=p)
            ops = [R, rng.standard_normal(n).astype(np.float32),
                   np.eye(n, dtype=np.float32), np.eye(n, dtype=np.float32),
                   rng.standard_normal((p, n)).astype(np.float32),
                   rng.standard_normal(p).astype(np.float32)]
            reqs.append(ops)
        reqs[0][1][0] = np.nan           # d: operand #1
        reqs[1][5][1] = np.inf           # z: operand #5
        reqs[3][0][0, 0] = np.nan        # R: operand #0
        for i in (4, 5):
            reqs[i][2] = F_bad           # the shared poisoned model: #2
        reqs[5][4][0, 0] = np.nan        # and H, later: still #2
        eng = ContinuousBatcher(_fast())
        jeng = JContinuousBatcher(jres.ResilientDispatcher(backend="reference",
                                                           sleep=_NO_SLEEP))
        ts = [eng.submit("kalman", *[F_shared if o is F_bad else o for o in ops])
              for ops in reqs]
        jts = [jeng.submit("kalman", *ops) for ops in reqs]
        eng.flush()
        jeng.flush()

        def verdicts(engine, tickets, err_cls):
            out = []
            for t in tickets:
                try:
                    engine.result(t)
                    out.append(None)
                except err_cls as e:
                    out.append(e.reason)
            return out

        ours = verdicts(eng, ts, ServeError)
        assert ours == verdicts(jeng, jts, jres.ServeError)
        assert [r and r.split()[2] for r in ours] == \
            ["#1", "#5", None, "#0", "#2", "#2", None]

    @pytest.mark.parametrize("seed", [5, 10])
    def test_chaos_schedule_and_quarantines_equal_the_reference(self, seed):
        """The same FaultPlan over the same poisoned mix: the same hazards
        fire, the same requests are quarantined, the same rungs serve
        (the reference run without its "interpret" rung)."""
        plan = dict(seed=seed, transient_rate=0.3, poison_rate=0.15)
        reqs = make_workload(32, 6, 3, 1, seed=seed, device="cpu")
        jreqs = jserve_qr.make_workload(32, 6, 3, 1, seed=seed)
        poisoned, idx = poison_workload(reqs, 0.1, seed=seed)
        jpoisoned, jidx = jfaults.poison_workload(jreqs, 0.1, seed=seed)
        assert idx == jidx
        for r, jr in zip(poisoned, jpoisoned):
            np.testing.assert_array_equal(np.asarray(r[1]), np.asarray(jr[1]))

        eng = ContinuousBatcher(_fast(max_batch=8))
        with inject(FaultPlan(**plan)) as inj:
            tickets = [eng.submit(r[0], *r[1:]) for r in poisoned]
            eng.flush()
        jladder = tuple(r for r in jres.DEFAULT_LADDER if r.name != "interpret")
        jeng = JContinuousBatcher(jres.ResilientDispatcher(
            backend="reference", max_batch=8, sleep=_NO_SLEEP, ladder=jladder))
        with jfaults.inject(jfaults.FaultPlan(**plan)) as jinj:
            jtickets = [jeng.submit(r[0], *r[1:]) for r in jpoisoned]
            jeng.flush()
        assert dict(inj.counts) == dict(jinj.counts)
        assert inj.counts["transient"] >= 1 and inj.counts["poison"] >= 1

        def outcomes(engine, ts, err_cls):
            out = []
            for t in ts:
                prov = engine.dispatcher.provenance[(t.group, t.cycle)][t.index]
                try:
                    engine.result(t)
                    out.append(("ok", prov.rung))
                except err_cls as e:
                    out.append((e.classification, prov.rung))
            return out

        ours = outcomes(eng, tickets, ServeError)
        theirs = outcomes(jeng, jtickets, jres.ServeError)
        assert ours == theirs
        assert {r for _, r in ours} - {"native", "quarantined"}  # a degradation
        quarantined = [i for i, (c, _) in enumerate(ours) if c == "poisoned"]
        assert set(idx) <= set(quarantined)
        for i in idx:
            assert ours[i] == ("poisoned", "quarantined")


# -------------------------------------------------- survivors keep their bits
class TestSurvivorsKeepTheirBits:
    """The port's own contract at the kernel path (the plain versions on
    CPU tensors): after each kind of quarantine, every survivor equals its
    fault-free result bit for bit."""

    @staticmethod
    def _run(reqs, dispatcher, injector=None):
        eng = ContinuousBatcher(dispatcher)
        with inject(injector) if injector is not None else contextlib.nullcontext():
            ts = [eng.submit(*r) for r in reqs]
            eng.flush()
        out = []
        for t in ts:
            try:
                out.append(eng.result(t))
            except PoisonedError as e:
                out.append(e)
        return out

    @staticmethod
    def _reqs(seed, count=7):
        rng = np.random.default_rng(seed)
        reqs = []
        for _ in range(count):
            R, U = _append_args(rng, n=6, p=3)
            d = rng.standard_normal((6, 2)).astype(np.float32)
            Y = rng.standard_normal((3, 2)).astype(np.float32)
            reqs.append(("append", R, U, d, Y))
        return reqs

    def _check(self, clean, got, bad):
        for i, (a, b) in enumerate(zip(clean, got)):
            if i in bad:
                assert isinstance(b, PoisonedError)
            else:
                assert _same_bits(a, b), i

    def test_after_a_precheck(self):
        reqs = self._reqs(31)
        clean = self._run(reqs, _fast(backend="pallas"))
        bad = list(reqs)
        U = bad[2][2].copy()
        U[1, 1] = np.nan
        bad[2] = (*bad[2][:2], U, *bad[2][3:])
        self._check(clean, self._run(bad, _fast(backend="pallas")), {2})

    def test_after_a_postcheck(self):
        reqs = self._reqs(32)
        clean = self._run(reqs, _fast(backend="pallas"))
        bad = list(reqs)
        Y = bad[4][4].copy()
        Y[0, 0] = np.inf
        bad[4] = (*bad[4][:4], Y)
        self._check(clean, self._run(bad, _fast(backend="pallas", precheck=False)),
                    {4})

    def test_after_a_bisection(self):
        reqs = self._reqs(33)
        clean = self._run(reqs, _fast(backend="pallas"))
        marked = torch.as_tensor(reqs[5][2])

        class MarkedPoison:
            def on_dispatch(self, kind, rung, dispatcher, chunk=None):
                if any(torch.equal(r.arrays[1], marked) for r in chunk):
                    raise InjectedPoison("marked request present")

        self._check(clean, self._run(reqs, _fast(backend="pallas"), MarkedPoison()),
                    {5})
