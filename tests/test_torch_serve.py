"""The whole slice: the port's serving engine and ``QRServer`` against the JAX
package's on the same ``make_workload`` traffic, the ``serve_qr`` CLI, the
engine's batching contracts, and the rule that the port never imports JAX."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.launch import serve_qr as jserve_qr
from repro_torch.convert import from_numpy, to_numpy
from repro_torch.launch import serve_qr
from repro_torch.serve import (AdmissionPolicy, ContinuousBatcher, Dispatcher,
                               ExecutableCache, LatencyTier, Rejected, ShedError,
                               make_request)

_REPO = pathlib.Path(__file__).resolve().parent.parent
WORKLOAD = dict(num=24, n=8, rows=4, k=1)


@pytest.fixture(scope="module")
def served():
    """Both packages' QRServer on the same 24-request mix of all four kinds."""
    jreqs = jserve_qr.make_workload(**WORKLOAD)
    reqs = serve_qr.make_workload(**WORKLOAD, device="cpu")
    jsrv = jserve_qr.QRServer()
    jt = jserve_qr._submit_all(jsrv, jreqs)
    jsrv.flush()
    jsrv.drain()
    srv = serve_qr.QRServer(device="cpu")
    tt = serve_qr._submit_all(srv, reqs)
    assert srv.flush() == len(reqs)
    srv.drain()
    return jreqs, reqs, [jsrv.result(t) for t in jt], [srv.result(t) for t in tt]


def test_workloads_are_the_same_requests(served):
    jreqs, reqs, _, _ = served
    assert [r[0] for r in jreqs] == [r[0] for r in reqs]
    for jr, r in zip(jreqs, to_numpy(reqs)):
        for a, b in zip(jr[1:], r[1:]):
            np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("kind", ["append", "kalman", "lstsq", "lstsq_pivoted"])
def test_every_ticket_matches_jax_server(served, kind):
    jreqs, _, jres, res = served
    seen = 0
    for r, a, b in zip(jreqs, jres, res):
        if r[0] != kind:
            continue
        seen += 1
        a, b = jserve_qr._as_tuple(a), serve_qr._as_tuple(b)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            x = np.asarray(x)
            assert y.shape == x.shape
            np.testing.assert_allclose(y.numpy().astype(np.float64), x.astype(np.float64),
                                       atol=5e-5 * max(1.0, np.abs(x).max()))
    assert seen >= 3


def test_shared_kalman_models_stay_one_tensor():
    reqs = serve_qr.make_workload(**WORKLOAD, device="cpu")
    shared = [r for i, r in enumerate(reqs) if i % 8 == 1]
    assert all(r[3] is shared[0][3] for r in shared)
    moved = from_numpy(reqs, "cpu")
    shared = [r for i, r in enumerate(moved) if i % 8 == 1]
    assert all(r[3] is shared[0][3] for r in shared)


def test_cli_check_prints_three_csv_fields(capsys):
    serve_qr.main(["--device", "cpu", "--check", "--requests", "24", "--n", "8",
                   "--rows", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,req_per_s,derived"
    fields = lines[1].split(",")
    assert len(fields) == 3 and float(fields[1]) > 0
    err = float(re.search(r"xbackend_maxerr=([0-9.e+-]+)", fields[2]).group(1))
    assert err < 1e-4


@pytest.mark.parametrize("flag", [["--mesh", "2"], ["--mesh", "2", "--resilient"],
                                  ["--mesh", "4", "--resilient", "--metrics", "m"]])
def test_cli_unported_flags_exit_2(flag, capsys):
    with pytest.raises(SystemExit) as e:
        serve_qr.main(["--device", "cpu", *flag])
    assert e.value.code == 2
    assert "not yet ported" in capsys.readouterr().err


def test_cli_resilient_check_prints_three_csv_fields(capsys):
    serve_qr.main(["--device", "cpu", "--resilient", "--check", "--requests", "24",
                   "--n", "8", "--rows", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and lines[0] == "name,req_per_s,derived"
    fields = lines[1].split(",")
    assert len(fields) == 3 and float(fields[1]) > 0
    err = float(re.search(r"xbackend_maxerr=([0-9.e+-]+)", fields[2]).group(1))
    assert err < 1e-4


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert serve_qr.QRServer()._engine.dispatcher.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_qr.QRServer()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Dispatcher()


# the modules of the instrumented and fault-tolerant slices; each must also
# import on its own
_SLICE_MODULES = ("repro_torch.core.counts", "repro_torch.core.baselines",
                  "repro_torch.obs", "repro_torch.obs.registry",
                  "repro_torch.obs._state", "repro_torch.obs.export",
                  "repro_torch.obs.tracing", "repro_torch.obs.timing",
                  "repro_torch.obs.flops", "repro_torch.obs.health",
                  "repro_torch.ranks.monitor", "repro_torch.ranks.sketch",
                  "repro_torch.solvers.lstsq", "repro_torch.kernels.backend",
                  # the fault-tolerant serving slice
                  "repro_torch.serve.resilience", "repro_torch.serve.dispatch",
                  "repro_torch.launch.serve_qr", "repro_torch.checkpoint",
                  "repro_torch.checkpoint.ckpt", "repro_torch.testing",
                  "repro_torch.testing.faults", "repro_torch.testing.error_harness")


def test_port_never_imports_jax():
    code = ("import sys, pkgutil, importlib, repro_torch\n"
            "walked = set()\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "    walked.add(m.name)\n"
            f"missing = set({_SLICE_MODULES!r}) - walked - {{'repro_torch.obs'}}\n"
            "assert not missing, missing\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'repro' or k.startswith('repro.'))\n"
            "assert not bad, bad\n"
            # each slice module alone, from a clean slate: no import cycle
            f"for name in {_SLICE_MODULES!r}:\n"
            "    for k in [k for k in sys.modules if k.startswith('repro_torch')]:\n"
            "        del sys.modules[k]\n"
            "    importlib.import_module(name)\n")
    env = {"PYTHONPATH": str(_REPO / "src"), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


def test_port_sources_import_nothing_of_jax_or_repro():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b|import repro\.|"
                         r"from repro\b|from repro\.)", re.M)
    files = [*(_REPO / "src" / "repro_torch").rglob("*.py"), _REPO / "chip_smoke.py"]
    assert len(files) > 15
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


# ------------------------------------------------------------ the engine
def _append_args(rng, n=6, p=3):
    R = np.triu(rng.standard_normal((n, n))).astype(np.float32)
    np.fill_diagonal(R, np.abs(np.diag(R)) + 1.0)
    return R, rng.standard_normal((p, n)).astype(np.float32)


def _engine(**kw):
    return ContinuousBatcher(Dispatcher(device="cpu", max_batch=4), **kw)


def test_flush_by_kind_and_ticket_expiry():
    rng = np.random.default_rng(0)
    eng = _engine()
    ta = eng.submit("append", *_append_args(rng))
    tl = eng.submit("lstsq", rng.standard_normal((12, 3)).astype(np.float32),
                    rng.standard_normal((12, 1)).astype(np.float32))
    assert eng.flush(kind="append") == 1
    assert eng.result(ta).shape == (6, 6)
    with pytest.raises(KeyError, match="not yet flushed"):
        eng.result(tl)
    eng.flush()
    x, resid = eng.result(tl)
    assert x.shape == (3, 1)
    eng.submit("append", *_append_args(rng))
    eng.flush()
    with pytest.raises(KeyError, match="expired"):
        eng.result(ta)
    with pytest.raises(ValueError):
        eng.flush(kind="bogus")


def test_chunking_and_padding_match_one_big_batch():
    """max_batch chunks padded to block_b give the same results as one
    unchunked dispatch: zero pad problems are fixed points."""
    rng = np.random.default_rng(1)
    args = [_append_args(rng) for _ in range(11)]
    small = ContinuousBatcher(Dispatcher(device="cpu", max_batch=4, block_b=3))
    big = ContinuousBatcher(Dispatcher(device="cpu", max_batch=64, block_b=1))
    ts = [small.submit("append", *a) for a in args]
    tb = [big.submit("append", *a) for a in args]
    small.flush()
    big.flush()
    for a, b in zip(ts, tb):
        assert torch.equal(small.result(a), big.result(b))
    assert small.dispatcher.padded_chunk(4, "append") == 6
    assert small.dispatcher.padded_chunk(4, "append", "bfloat16") == 6
    assert small.dispatcher.block_b_for("bfloat16") == 6


def test_double_buffered_dispatch_matches_closed_loop():
    rng = np.random.default_rng(2)
    args = [_append_args(rng) for _ in range(9)]
    async_eng = ContinuousBatcher(Dispatcher(device="cpu", max_batch=4,
                                             double_buffer=True),
                                  admit_max=4, retain_cycles=None)
    sync_eng = _engine()
    ta = [async_eng.submit("append", *a) for a in args]
    ts = [sync_eng.submit("append", *a) for a in args]
    async_eng.flush()
    sync_eng.flush()
    assert async_eng.poll() == 0
    assert async_eng.drain() == 9
    for a, b in zip(ta, ts):
        assert torch.equal(async_eng.result(a), sync_eng.result(b))
        assert async_eng.done_at(a) is not None


def test_admission_reject_shed_and_deadline():
    rng = np.random.default_rng(3)

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    clock = Clock()
    eng = _engine(policy=AdmissionPolicy(tiers={
        "append": LatencyTier(max_queue=2),
        "lstsq": LatencyTier(deadline=1.0, max_queue=1, on_full="shed_oldest")}),
        clock=clock)
    eng.submit("append", *_append_args(rng))
    eng.submit("append", *_append_args(rng))
    with pytest.raises(Rejected):
        eng.submit("append", *_append_args(rng))
    A = rng.standard_normal((12, 3)).astype(np.float32)
    b = rng.standard_normal((12, 1)).astype(np.float32)
    old = eng.submit("lstsq", A, b)
    new = eng.submit("lstsq", A, b)  # sheds the open batch holding `old`
    with pytest.raises(ShedError):
        eng.result(old)
    clock.t = 2.0
    assert eng.poll() == 1  # the deadline closes the lstsq batch
    assert eng.result(new)[0].shape == (3, 1)


def test_executable_cache_is_a_bounded_lru():
    cache = ExecutableCache(maxsize=2)
    for k in "abcc":
        assert cache.get(k, lambda k=k: k.upper()) == k.upper()
    assert cache.keys() == ["b", "c"] and cache.hits == 1 and cache.misses == 3
    assert "a" not in cache and len(cache) == 2
    with pytest.raises(ValueError):
        ExecutableCache(maxsize=0)


def test_requests_keep_dtype_groups_and_reject_malformed_operands():
    rng = np.random.default_rng(4)
    R, U = _append_args(rng)
    r32 = make_request("append", R, U, device="cpu")
    r64 = make_request("append", R.astype(np.float64), U.astype(np.float64))
    assert r32.group == ("append", (6, 6), "float32", (3, 6), "float32", None)
    assert r32.group != r64.group
    with pytest.raises(ValueError):
        make_request("append", R, U, d=np.zeros((6, 1), np.float32))
    with pytest.raises(TypeError):
        make_request("lstsq", R)
    with pytest.raises(ValueError):
        make_request("bogus", R)


def test_precision_policy_in_serving():
    """Under a bf16 policy f32-stored groups still compute at f32 (promote),
    and bf16-stored groups run bf16 tiles with f32 accumulation, come back
    bf16, at double block_b granularity, close to the f32 answer."""
    rng = np.random.default_rng(5)
    args = [_append_args(rng) for _ in range(5)]
    plain = ContinuousBatcher(Dispatcher(device="cpu"))
    mixed = ContinuousBatcher(Dispatcher(device="cpu", precision="bf16"))
    tp = [plain.submit("append", *a) for a in args]
    tm = [mixed.submit("append", *a) for a in args]
    tb = [mixed.submit("append", *(torch.from_numpy(x).bfloat16() for x in a))
          for a in args]
    plain.flush()
    mixed.flush()
    assert mixed.dispatcher.padded_chunk(5, "append", "bfloat16") == 16
    for a, b, c in zip(tp, tm, tb):
        ref = plain.result(a)
        assert torch.equal(mixed.result(b), ref)
        low = mixed.result(c)
        assert low.dtype == torch.bfloat16
        np.testing.assert_allclose(low.float().numpy(), ref.numpy(),
                                   atol=3e-2 * float(ref.abs().max()))
