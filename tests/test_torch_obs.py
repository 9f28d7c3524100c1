"""Port parity: repro_torch.obs against the JAX package's repro.obs — registry
values, the exporters' text, the health gauges — plus the port's serving
metrics contract, which the JAX package's validator must accept."""
import json
import math
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.obs import export as jexport
from repro_torch import obs
from repro_torch.core import ggr_qr_blocked
from repro_torch.launch import serve_qr
from repro_torch.solvers import ggr_lstsq

_REPO = pathlib.Path(__file__).resolve().parents[1]


def _record(o):
    """The same sequence of recordings into a fresh registry of ``o``."""
    reg = o.MetricsRegistry()
    c = reg.counter("x.events", kind="a")
    c.inc()
    c.inc(3)
    reg.counter("x.events", kind="b").inc(2.5)
    g = reg.gauge("x.level")
    for v in (0.5, 2.0, -1.0):
        g.set(v)
    h = reg.histogram("x.latency", kind="a")
    for v in np.random.default_rng(0).exponential(0.01, 257):
        h.observe(float(v))
    reg.gauge("x.never")
    return reg


def test_registry_values_equal_the_reference():
    ours, ref = _record(obs), _record(jobs)
    assert [(m.name, m.labels, m.kind) for m in ours.collect()] == \
        [(m.name, m.labels, m.kind) for m in ref.collect()]
    for a, b in zip(ours.collect(), ref.collect()):
        if a.kind == "histogram":
            assert a.count == b.count and a.sum == b.sum
            for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
                assert a.quantile(q) == b.quantile(q)
            assert a.buckets() == b.buckets()
        elif a.kind == "gauge":
            assert (a.min, a.max, a.updates) == (b.min, b.max, b.updates)
            assert a.value == b.value or (math.isnan(a.value) and math.isnan(b.value))
        else:
            assert a.value == b.value
    with pytest.raises(ValueError):
        ours.counter("x.events", kind="a").inc(-1)
    with pytest.raises(TypeError):
        ours.gauge("x.events", kind="a")
    with pytest.raises(ValueError):
        ours.find("x.latency", kind="a").quantile(1.5)


def test_null_default_records_nothing():
    assert not obs.enabled()
    h = obs.histogram("x.a", k="1")
    assert h is obs.counter("y.b")
    h.observe(1.0)
    obs.gauge("z").set(3.0)
    assert obs.registry().collect() == []
    with obs.collecting() as reg:
        assert obs.enabled() and obs.registry() is reg
        inner = obs.MetricsRegistry()
        with obs.collecting(inner):
            assert obs.registry() is inner
        assert obs.registry() is reg
    assert not obs.enabled()


def test_snapshot_and_prometheus_text_equal_the_reference(tmp_path):
    ours, ref = _record(obs), _record(jobs)
    meta = {"run": "t1"}
    a, b = obs.snapshot(ours, meta), jobs.snapshot(ref, meta)
    assert abs(a.pop("ts") - b.pop("ts")) < 60
    assert a == b
    assert obs.prometheus_text(ours) == jobs.prometheus_text(ref)
    # the files, apart from the timestamp, and read back by both packages
    pa, pb = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    obs.write_jsonl(str(pa), ours, meta)
    jobs.write_jsonl(str(pb), ref, meta)
    la, lb = json.loads(pa.read_text()), json.loads(pb.read_text())
    la.pop("ts"), lb.pop("ts")
    assert la == lb
    assert jobs.load_jsonl(str(pa))[0]["schema"] == obs.export.SCHEMA == jexport.SCHEMA
    obs.write_prometheus(str(tmp_path / "a.prom"), ours)
    assert (tmp_path / "a.prom").read_text() == jobs.prometheus_text(ref)
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"schema": "other/v9", "metrics": []}\n')
    with pytest.raises(ValueError):
        obs.load_jsonl(str(bad))


def test_required_families_equal_the_reference():
    assert obs.REQUIRED_SERVE_FAMILIES == jobs.REQUIRED_SERVE_FAMILIES
    assert obs.REQUIRED_ASYNC_SERVE_FAMILIES == jobs.REQUIRED_ASYNC_SERVE_FAMILIES
    assert obs.REQUIRED_RESILIENCE_FAMILIES == jobs.REQUIRED_RESILIENCE_FAMILIES


def test_timing_and_spans_on_the_cpu():
    x = torch.ones(64, 64)
    assert obs.block_ready(x) is False  # CPU tensors are complete: no wait
    with obs.device_timer() as t:
        t.stop((x @ x, [x]))
    assert t.seconds > 0.0 and t.blocked is False
    out, sec = obs.time_dispatch(torch.mm, x, x)
    assert sec > 0.0 and out.shape == (64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("repro/test/outer"):
            obs.annotate_fn("repro/test/inner", torch.mm)(x, x)
    names = {e.key for e in prof.key_averages()}
    assert {"repro/test/outer", "repro/test/inner"} <= names


def _graded(rng, B, n, spread):
    R = np.triu(rng.standard_normal((B, n, n)))
    d = np.geomspace(1.0, spread, n)
    R[:, np.arange(n), np.arange(n)] = d * rng.uniform(1.0, 2.0, (B, n))
    return R


@pytest.mark.parametrize("batched", [False, True])
def test_factor_health_equals_the_reference(batched):
    rng = np.random.default_rng(3)
    R = _graded(rng, 5, 12, 1e-4)
    R[3, 5, 5] *= 1e-3  # the worst member, the one estimated
    if not batched:
        R = R[3]
    with obs.collecting() as reg, jobs.collecting() as jreg:
        obs.factor_health(torch.as_tensor(R), "unit", kind="x")
        jobs.factor_health(jnp.asarray(R), "unit", kind="x")
    names = ("r_diag_min", "r_diag_max", "r_cond_estimate", "r_cond_proxy")
    for name in names:
        a, b = reg.find(f"unit.{name}", kind="x").value, jreg.find(f"unit.{name}", kind="x").value
        assert a == pytest.approx(b, rel=1e-12), name
    assert reg.find("unit.r_cond_estimate", kind="x").value > 1e6
    # an exactly singular member reads inf, as in the reference
    R0 = np.array(R, copy=True)
    R0[..., 1, 1] = 0.0
    with obs.collecting() as reg:
        obs.factor_health(torch.as_tensor(R0), "unit")
    assert reg.find("unit.r_cond_estimate").value == math.inf


def test_orthogonality_audit_equals_the_reference(monkeypatch):
    monkeypatch.setenv("REPRO_OBS_ORTHO_EVERY", "1")
    rng = np.random.default_rng(1)
    A = rng.standard_normal((32, 8)).astype(np.float32)
    R = np.linalg.qr(A, mode="r")
    for RR in (R, R * 1.5):
        assert obs.orthogonality_loss(torch.as_tensor(A), torch.as_tensor(RR)) == \
            pytest.approx(jobs.orthogonality_loss(jnp.asarray(A), jnp.asarray(RR)), rel=1e-12)
    Rfull = np.linalg.qr(A.astype(np.float64), mode="complete")[1]
    assert obs.orthogonality_loss(A, Rfull) == pytest.approx(
        obs.orthogonality_loss(A, Rfull[:8]))
    for dt in ("float32", "bfloat16", "float64", torch.float16):
        assert obs.ortho_tolerance(8, dt) == jobs.ortho_tolerance(
            8, str(dt).removeprefix("torch."))
    with obs.collecting() as reg:
        loss = obs.maybe_sample_orthogonality(torch.as_tensor(A), torch.as_tensor(R),
                                              "unit")
        obs.maybe_sample_orthogonality(torch.as_tensor(A), torch.as_tensor(R / 30),
                                       "unit", dtype="bfloat16")
    assert loss is not None and loss < 1e-4
    assert reg.find("unit.orthogonality_samples").value == 2
    assert reg.find("unit.orthogonality_alarms").value == 1


def test_orthogonality_sampling_follows_the_env(monkeypatch):
    monkeypatch.setenv("REPRO_OBS_ORTHO_EVERY", "4")
    A = torch.as_tensor(np.random.default_rng(2).standard_normal((16, 4)))
    R = torch.linalg.qr(A, mode="r").R
    with obs.collecting() as reg:
        got = [obs.maybe_sample_orthogonality(A, R, "unit") for _ in range(12)]
    assert sum(g is not None for g in got) == 3
    assert reg.find("unit.orthogonality_samples").value == 3
    assert obs.maybe_sample_orthogonality(A, R, "unit") is None  # no collector


def test_lstsq_and_blocked_record_under_a_collector(monkeypatch):
    """ggr_lstsq's health sensors equal the reference's on the same system;
    the blocked driver records one dispatch by the sweep model, and every
    kernel entry point counts its resolution ("interpret" on the CPU)."""
    monkeypatch.setenv("REPRO_OBS_ORTHO_EVERY", "1")
    rng = np.random.default_rng(4)
    A, b = rng.standard_normal((40, 6)), rng.standard_normal(40)
    with obs.collecting() as reg, jobs.collecting() as jreg:
        ggr_lstsq(torch.as_tensor(A), torch.as_tensor(b))
        from repro.solvers import ggr_lstsq as jlstsq
        jlstsq(jnp.asarray(A), jnp.asarray(b))
    for name in ("lstsq.r_cond_estimate", "lstsq.r_diag_min", "lstsq.orthogonality_loss"):
        assert reg.find(name).value == pytest.approx(jreg.find(name).value, rel=1e-8, abs=1e-14)
    M = torch.as_tensor(rng.standard_normal((96, 80)))
    with obs.collecting() as reg:
        ggr_qr_blocked(M, tile=32, precision="f64")
    assert reg.find("blocked.dispatches", schedule="tree", precision="float64").value == 1
    flops = reg.find("blocked.flops_total", dtype="float64", schedule="tree",
                     precision="float64").value
    assert flops == obs.ggr_sweep_flops(96, 80, 80)
    assert reg.find("kernels.interpret_resolutions", mode="interpret").value >= 2
    assert reg.find("kernels.precision_resolutions", compute="float64",
                    accum="float64").value >= 1
    assert reg.find("kernels.interpret_resolutions", mode="compiled") is None


def _flush_under_collector(backend, num=12):
    reqs = serve_qr.make_workload(num, 8, 4, 1, device="cpu")
    server = serve_qr.QRServer(backend=backend, max_batch=8, device="cpu")
    with obs.collecting() as reg:
        serve_qr._submit_all(server, reqs)
        served = server.flush()
        server.drain()
    return reg, served, num


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_serving_flush_emits_the_serving_contract(backend, tmp_path):
    reg, served, num = _flush_under_collector(backend)
    col = reg.collect()
    assert obs.missing_families(obs.snapshot(reg)) == []
    submitted = sum(m.value for m in col if m.name == "serve.requests_submitted")
    done = sum(m.value for m in col if m.name == "serve.requests_served")
    assert submitted == done == served == num
    qwaits = [m for m in col if m.name == "serve.queue_wait_seconds"]
    assert sum(h.count for h in qwaits) == num and all(h.min >= 0.0 for h in qwaits)
    assert all(h.min > 0.0 for h in col if h.name == "serve.flush_duration_seconds")
    assert all(1 <= h.min and h.max <= num for h in col if h.name == "serve.batch_size")
    pads = [m for m in col if m.name == "serve.padding_waste"]
    assert pads and all(0.0 <= g.min and g.max < 1.0 for g in pads)
    assert all(h.min > 0.0 for h in col if h.name == "serve.achieved_gflops")
    assert sum(m.value for m in col if m.name == "serve.executable_cache_miss") >= 1
    assert all(g.value == 0.0 for g in col if g.name == "serve.queue_depth")
    assert any(m.name == "serve.r_cond_proxy" for m in col)
    # the JAX package's validator accepts the port's snapshot
    path = tmp_path / "serve.jsonl"
    obs.write_jsonl(str(path), reg, {"backend": backend})
    jexport.main(["--validate", str(path)])
    assert jobs.missing_families(jobs.load_jsonl(str(path))[-1]) == []


def test_uninstrumented_flush_records_nothing():
    assert not obs.enabled()
    reqs = serve_qr.make_workload(6, 8, 4, 1, device="cpu")
    server = serve_qr.QRServer(backend="reference", max_batch=8, device="cpu")
    serve_qr._submit_all(server, reqs)
    server.flush()
    server.drain()
    assert obs.registry().collect() == []
    assert not server._submit_times and not server._seen_dispatch


def test_serve_qr_metrics_cli_on_the_cpu(tmp_path):
    prefix = tmp_path / "m"
    env = {"PYTHONPATH": str(_REPO / "src"), "PATH": "/usr/bin:/bin"}
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_qr", "--device", "cpu",
         "--requests", "24", "--n", "8", "--rows", "4", "--check",
         "--metrics", str(prefix)],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert run.returncode == 0, run.stderr
    lines = run.stdout.strip().splitlines()
    assert len(lines) == 2 and len(lines[1].split(",")) == 3
    assert "wrote" in run.stderr
    assert (tmp_path / "m.prom").read_text().startswith("# TYPE")
    val = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.export", "--validate",
         f"{prefix}.jsonl"], capture_output=True, text=True, env=env, timeout=120)
    assert val.returncode == 0 and "OK" in val.stdout, val.stderr
    jexport.main(["--validate", f"{prefix}.jsonl"])
    with pytest.raises(SystemExit):
        obs.export.main(["--validate", f"{prefix}.jsonl", "--require", "serve.nope"])
