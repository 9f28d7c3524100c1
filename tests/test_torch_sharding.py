"""Sharded serving in the port: a 1-D batch mesh through
``qr_append_rows_batched``, ``kf_step_batched``, the ``Dispatcher``,
``QRServer``, ``serve_qr --mesh N`` and ``fleet_nis``.

Mirrors ``tests/test_serve_sharded.py``, the sharded case of
``tests/test_kalman.py``, ``test_qrserver_flush_metrics_on_host_mesh`` of
``tests/test_obs.py`` and the mesh-cycling cache bound of
``tests/test_serve_engine.py``.  The meshes are four shards of the host.  Two
contracts hold: the port's sharded results equal its single-device results
(bitwise for the kernel kinds append and kalman, within 1e-6 for the lstsq
kinds), and they equal the JAX package's *single-device* results at that
package's tolerances (its own mesh paths raise under the installed JAX).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve_qr as jserve_qr
from repro.solvers import kalman as jkalman
from repro.solvers import qr_append_rows_batched as jappend
from repro.testing import error_harness as jeh
from repro_torch import obs
from repro_torch.convert import from_numpy
from repro_torch.launch import serve_qr
from repro_torch.parallel import (BatchMesh, batch_shard_spec, make_batch_mesh,
                                  shard_batch)
from repro_torch.serve import (ContinuousBatcher, Dispatcher, PoisonedError,
                               ResilientDispatcher, RetryPolicy, Rung, ServeError)
from repro_torch.solvers import kf_step_batched, qr_append_rows_batched
from repro_torch.solvers import qr_update
from repro_torch.testing import error_harness as eh
from repro_torch.testing.faults import ScriptedInjector, inject, poison_workload

MESH = make_batch_mesh(4, device="cpu")
# the JAX package's tolerances for the kernel path against a second route
TOL = {np.float32: 5e-5, np.float64: 1e-11}
KERNEL_KINDS = ("append", "kalman")


def _same_bits(a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def _agree(kind, a, b):
    """Sharded vs single-device: the kernel kinds bit for bit, the lstsq
    kinds to roundoff (their padded width differs between mesh and none)."""
    if kind in KERNEL_KINDS:
        assert _same_bits(a, b)
        return
    a, b = serve_qr._as_tuple(a), serve_qr._as_tuple(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6, atol=1e-6)


def _append_problem(B, dtype, seed, n=6, p=3, k=2):
    rng = np.random.default_rng(seed)
    return (np.triu(rng.standard_normal((B, n, n))).astype(dtype),
            rng.standard_normal((B, p, n)).astype(dtype),
            rng.standard_normal((B, n, k)).astype(dtype),
            rng.standard_normal((B, p, k)).astype(dtype))


# ------------------------------------------------------------ the mesh itself
def test_batch_mesh_is_a_hashable_1d_mesh():
    assert MESH.shape == {"batch": 4}
    assert MESH.devices == (torch.device("cpu"),) * 4
    again = make_batch_mesh(4, device="cpu")
    assert hash(MESH) == hash(again) and MESH == again
    assert make_batch_mesh(device="cpu").shape == {"batch": 1}
    assert make_batch_mesh(2, axis="b2", device="cpu").shape == {"b2": 2}
    assert BatchMesh(("cpu", "cpu")) == make_batch_mesh(2, device="cpu")
    assert batch_shard_spec(3) == ("batch", None, None)
    assert batch_shard_spec(1, "b2") == ("b2",)
    with pytest.raises(KeyError):
        MESH.shape["model"]  # noqa: B018 — an axis the mesh lacks
    with pytest.raises(ValueError):
        make_batch_mesh(0, device="cpu")
    with pytest.raises(ValueError):
        BatchMesh(())


@pytest.mark.parametrize("visible", [0, 2])
def test_make_batch_mesh_refuses_more_cards_than_are_visible(monkeypatch, visible):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: visible > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    with pytest.raises(ValueError, match=f"requested a 4-device batch mesh but only "
                                         f"{visible} devices are visible"):
        make_batch_mesh(4)
    if visible:
        mesh = make_batch_mesh(visible)
        assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
        assert make_batch_mesh().shape == {"batch": visible}


def test_shard_batch_maps_contiguous_slices_in_order():
    seen = []

    def fn(x, y):
        seen.append(x[:, 0].tolist())
        return x + y, x.sum(1)

    x = torch.arange(24.0).reshape(8, 3)
    out, sums = shard_batch(fn, MESH)(x, torch.ones(8, 3))
    assert seen == [[0.0, 3.0], [6.0, 9.0], [12.0, 15.0], [18.0, 21.0]]
    assert torch.equal(out, x + 1) and torch.equal(sums, x.sum(1))
    with pytest.raises(ValueError, match="pad dim 0"):
        shard_batch(fn, MESH)(x[:7], torch.ones(7, 3))
    with pytest.raises(KeyError):
        shard_batch(fn, MESH, "model")


# ------------------------------------------------------ the batched functions
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("B", [1, 7, 67])
def test_sharded_append_matches_single_device(B, dtype):
    """Bitwise against ``mesh=None`` and a 1-shard mesh (the padded grid
    differs, each problem's sweep does not), and against the JAX package's
    single-device kernel at its tolerance."""
    ops = _append_problem(B, dtype, 50 + B)
    t = from_numpy(ops, "cpu")
    Rs, ds = qr_append_rows_batched(*t, mesh=MESH)
    R1, d1 = qr_append_rows_batched(*t)
    Ro, do = qr_append_rows_batched(*t, mesh=make_batch_mesh(1, device="cpu"))
    assert Rs.shape == (B, 6, 6) and ds.shape == (B, 6, 2)
    assert _same_bits((Rs, ds), (R1, d1)) and _same_bits((Ro, do), (R1, d1))
    jR, jd = jappend(*map(jnp.asarray, ops), backend="pallas", interpret=True)
    np.testing.assert_allclose(Rs.numpy(), np.asarray(jR), rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(ds.numpy(), np.asarray(jd), rtol=TOL[dtype], atol=TOL[dtype])


def test_sharded_reference_backend():
    R, U, _, _ = _append_problem(10, np.float32, 52, n=5, p=2)
    t = from_numpy((R, U), "cpu")
    Rs = qr_append_rows_batched(*t, backend="reference", mesh=MESH)
    assert torch.equal(Rs, qr_append_rows_batched(*t, backend="reference"))
    jR = jappend(jnp.asarray(R), jnp.asarray(U), backend="reference")
    np.testing.assert_allclose(Rs.numpy(), np.asarray(jR), rtol=5e-5, atol=5e-5)


def test_a_mesh_axis_the_mesh_lacks_raises():
    t = from_numpy(_append_problem(3, np.float32, 53)[:2], "cpu")
    with pytest.raises(KeyError):
        qr_append_rows_batched(*t, mesh=MESH, mesh_axis="model")


def test_one_sweep_per_shard(monkeypatch):
    """The kernel runs once per shard, each on a quarter of the padded
    batch: 11 problems pad to 4 x 8 = 32, so four sweeps of 8."""
    widths = []
    real = qr_update.batched_update

    def counting(stacked, *a, **k):
        widths.append(stacked.shape[0])
        return real(stacked, *a, **k)

    monkeypatch.setattr(qr_update, "batched_update", counting)
    t = from_numpy(_append_problem(11, np.float32, 54)[:2], "cpu")
    qr_append_rows_batched(*t, mesh=MESH)
    assert widths == [8, 8, 8, 8]
    widths.clear()
    qr_append_rows_batched(*t)
    assert widths == [11]


def _kalman_problem(B, n, w, p, seed, dtype, shared):
    rng = np.random.default_rng(seed)
    lead = () if shared else (B,)

    def triu_spd(shape):
        T = np.triu(rng.standard_normal(shape))
        idx = np.arange(shape[-1])
        T[..., idx, idx] = np.abs(T[..., idx, idx]) + 1.0
        return T.astype(dtype)

    R = triu_spd((B, n, n))
    d = rng.standard_normal((B, n)).astype(dtype)
    F = (np.eye(n) + 0.1 * rng.standard_normal(lead + (n, n))).astype(dtype)
    Qi = triu_spd(lead + (w, w))
    H = rng.standard_normal(lead + (p, n)).astype(dtype)
    z = rng.standard_normal((B, p)).astype(dtype)
    G = rng.standard_normal(lead + (n, w)).astype(dtype)
    return R, d, F, Qi, H, z, G


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shared", [True, False])
def test_sharded_kalman_matches_single_device(shared, dtype):
    """B = 11 (prime: pads to 4 shards x 8 on the mesh, to 16 alone) —
    bitwise against the single-device step, and against the JAX package's
    single-device kernel step at its tolerance."""
    ops = _kalman_problem(11, 4, 2, 2, 72, dtype, shared)
    t = from_numpy(ops, "cpu")
    Rs, ds = kf_step_batched(*t, mesh=MESH)
    R1, d1 = kf_step_batched(*t)
    assert _same_bits((Rs, ds), (R1, d1))
    jR, jd = jkalman.kf_step_batched(*map(jnp.asarray, ops), interpret=True)
    tol = {np.float32: 5e-5, np.float64: 1e-10}[dtype]
    np.testing.assert_allclose(Rs.numpy(), np.asarray(jR), rtol=tol, atol=tol)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jd), rtol=tol, atol=tol)


def test_fleet_nis_sharded_equals_single_device():
    kw = dict(B=6, n=4, w=3, p=2, T=15, seed=3, backend="pallas", device="cpu")
    ours = eh.fleet_nis(**kw, mesh=MESH)
    assert np.array_equal(ours, eh.fleet_nis(**kw))
    theirs = jeh.fleet_nis(**{k: v for k, v in kw.items() if k != "device"})
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)


# ------------------------------------------------------------ serving
@pytest.fixture(scope="module")
def served():
    """A 19-request mix (odd group sizes: padding on every path) through the
    sharded and the single-device server, and the JAX package's
    single-device server."""
    reqs = serve_qr.make_workload(19, n=6, rows=3, k=1, seed=53, device="cpu")
    out = {}
    for name, mesh in (("sharded", MESH), ("single", None)):
        srv = serve_qr.QRServer(device="cpu", mesh=mesh)
        tickets = serve_qr._submit_all(srv, reqs)
        assert srv.flush() == len(reqs)
        srv.drain()
        out[name] = [srv.result(t) for t in tickets]
    jsrv = jserve_qr.QRServer()
    jt = jserve_qr._submit_all(jsrv, jserve_qr.make_workload(19, n=6, rows=3, k=1, seed=53))
    jsrv.flush()
    out["jax"] = [jsrv.result(t) for t in jt]
    return reqs, out


@pytest.mark.parametrize("kind", ["append", "kalman", "lstsq", "lstsq_pivoted"])
def test_sharded_server_round_trip(served, kind):
    reqs, out = served
    seen = 0
    for r, a, b, j in zip(reqs, out["sharded"], out["single"], out["jax"]):
        if r[0] != kind:
            continue
        seen += 1
        _agree(kind, a, b)
        for x, y in zip(serve_qr._as_tuple(a), jserve_qr._as_tuple(j)):
            y = np.asarray(y)
            np.testing.assert_allclose(x.numpy().astype(np.float64), y.astype(np.float64),
                                       atol=5e-5 * max(1.0, np.abs(y).max()))
    assert seen >= 2


def test_sharded_continuous_batching_matches_single_device():
    """Continuous batching (admit_max auto-close + double buffering) over a
    4-shard mesh agrees with the single-device engine: the kernel kinds
    bitwise, the lstsq kinds to roundoff."""
    reqs = serve_qr.make_workload(19, n=6, rows=3, k=1, seed=56, device="cpu")

    def engine(mesh):
        return ContinuousBatcher(Dispatcher(device="cpu", mesh=mesh, max_batch=4,
                                            double_buffer=True),
                                 admit_max=4, retain_cycles=None)

    sharded, single = engine(MESH), engine(None)
    ts = [sharded.submit(r[0], *r[1:]) for r in reqs]
    t1 = [single.submit(r[0], *r[1:]) for r in reqs]
    sharded.flush()
    single.flush()
    assert sharded.drain() >= 19 and single.drain() >= 19
    for r, a, b in zip(reqs, ts, t1):
        _agree(r[0], sharded.result(a), single.result(b))
    assert all(sharded.done_at(t) is not None for t in ts)


@pytest.mark.parametrize("kind,nb,mesh_width,single_width",
                         [("append", 67, 96, 72), ("kalman", 11, 32, 16),
                          ("lstsq", 67, 68, 72), ("lstsq_pivoted", 5, 8, 8)])
def test_padded_chunk_follows_the_mesh(kind, nb, mesh_width, single_width):
    assert Dispatcher(device="cpu", mesh=MESH).padded_chunk(nb, kind) == mesh_width
    assert Dispatcher(device="cpu").padded_chunk(nb, kind) == single_width
    # 2-byte storage doubles block_b for the kernel kinds only
    doubled = Dispatcher(device="cpu", mesh=MESH).padded_chunk(nb, kind, "bfloat16")
    assert doubled == (-(-nb // 64) * 64 if kind in KERNEL_KINDS else mesh_width)


def test_dispatcher_refuses_a_device_outside_the_mesh():
    with pytest.raises(ValueError, match="not a device of the mesh"):
        Dispatcher(device="cpu", mesh=BatchMesh((torch.device("meta"),) * 2))


def test_executable_cache_fills_per_mesh_and_stays_bounded():
    """The sharded lstsq kinds build their executor once per (kind, mesh,
    axis) — one miss, then hits — and a server cycling meshes keeps at most
    ``cache_size`` of them; two servers never share entries."""
    rng = np.random.default_rng(8)
    mesh_b = make_batch_mesh(2, axis="batch2", device="cpu")
    d1 = Dispatcher(device="cpu", backend="reference", mesh=MESH, cache_size=1)
    d2 = Dispatcher(device="cpu", backend="reference", mesh=MESH)
    assert d1.executables is not d2.executables
    eng = ContinuousBatcher(d1, retain_cycles=None)
    A = rng.standard_normal((12, 3)).astype(np.float32)
    b = rng.standard_normal((12, 1)).astype(np.float32)
    for _ in range(2):
        eng.submit("lstsq", A, b)
        eng.flush()
    assert ("lstsq", MESH, "batch") in d1.executables
    assert (d1.executables.misses, d1.executables.hits) == (1, 1)
    d1.mesh, d1.mesh_axis = mesh_b, "batch2"
    eng.submit("lstsq", A, b)
    eng.flush()
    assert len(d1.executables) == 1
    assert ("lstsq", mesh_b, "batch2") in d1.executables
    assert ("lstsq", MESH, "batch") not in d1.executables
    assert len(d2.executables) == 0


def test_flush_metrics_on_host_mesh():
    """The serving contract under a collector on a 4-shard mesh: one
    dispatch recorded per chunk (as alone), padding waste counting the
    mesh's wider pad."""
    reqs = serve_qr.make_workload(16, 8, 4, 1, device="cpu")
    regs = {}
    for name, mesh in (("sharded", MESH), ("single", None)):
        server = serve_qr.QRServer(max_batch=8, device="cpu", mesh=mesh)
        with obs.collecting() as reg:
            serve_qr._submit_all(server, reqs)
            assert server.flush() == 16
            server.drain()
        regs[name] = reg
    col = regs["sharded"].collect()
    assert obs.missing_families(obs.snapshot(regs["sharded"])) == []
    done = sum(m.value for m in col if m.name == "serve.requests_served")
    assert done == 16

    def dispatches(reg):
        return sum(h.count for h in reg.collect() if h.name == "serve.dispatch_seconds")

    assert dispatches(regs["sharded"]) == dispatches(regs["single"]) > 0
    def pads(reg):
        return {dict(m.labels)["kind"]: m.max for m in reg.collect()
                if m.name == "serve.padding_waste"}

    sharded, single = pads(regs["sharded"]), pads(regs["single"])
    assert any(v > 0.0 for v in sharded.values())
    # the kernel kinds pad to 4 x 8 on the mesh, to 8 alone
    assert all(sharded[k] >= single[k] for k in KERNEL_KINDS)


# ------------------------------------------------------------ resilience
def _served(server, reqs):
    tickets = serve_qr._submit_all(server, reqs)
    server.flush()
    out = []
    for t in tickets:
        try:
            out.append(server.result(t))
        except ServeError as e:
            out.append(e)
    return out


def test_resilient_dispatcher_under_a_mesh():
    """Resilient == plain under the mesh, bit for bit; NaN-poisoned requests
    are quarantined and every survivor keeps its fault-free bits (the
    re-dispatch runs at the original chunk's mesh-padded width)."""
    reqs = serve_qr.make_workload(40, n=6, rows=3, k=1, seed=57, device="cpu")
    plain = _served(serve_qr.QRServer(device="cpu", mesh=MESH), reqs)
    resil = _served(serve_qr.QRServer(device="cpu", mesh=MESH, resilient=True), reqs)
    assert all(_same_bits(a, b) for a, b in zip(plain, resil))
    poisoned, idx = poison_workload(reqs, rate=0.1, seed=11)
    server = serve_qr.QRServer(device="cpu", mesh=MESH, resilient=True)
    got = _served(server, poisoned)
    assert all(isinstance(got[i], PoisonedError) for i in idx)
    survivors = [i for i in range(len(reqs)) if i not in set(idx)]
    for i in survivors:
        if reqs[i][0] in KERNEL_KINDS:
            assert _same_bits(got[i], resil[i]), i
        else:
            _agree(reqs[i][0], got[i], resil[i])


def test_pad_floor_composes_with_the_mesh_granularity():
    d = ResilientDispatcher(device="cpu", mesh=make_batch_mesh(3, device="cpu"))
    d._pad_floor = 100
    assert d.padded_chunk(5, "append") == 120   # the floor rounded up to 3 x 8
    assert d.padded_chunk(5, "lstsq") == 102    # ... and to 3 for the solves
    d.mesh = None
    assert d.padded_chunk(5, "append") == 104


@pytest.mark.parametrize("kind", ["append", "lstsq"])
def test_a_rung_dropping_the_mesh_serves(kind):
    """A rung that overrides ``mesh`` is legal: ``("mesh", None)`` serves
    the chunk on one device, at the mesh-padded width, with the single
    device's bits for the kernel kind."""
    reqs = [r for r in serve_qr.make_workload(48, n=6, rows=3, k=1, seed=58,
                                              device="cpu") if r[0] == kind][:11]
    d = ResilientDispatcher(device="cpu", mesh=MESH, sleep=lambda s: None,
                            retry=RetryPolicy(max_attempts=1),
                            ladder=(Rung("native"), Rung("one_device",
                                                         overrides=(("mesh", None),))))
    eng = ContinuousBatcher(d)
    with inject(ScriptedInjector([0])):
        tickets = [eng.submit(*r) for r in reqs]
        eng.flush()
    assert d.mesh is MESH  # restored after the attempt
    prov = d.provenance[(tickets[0].group, tickets[0].cycle)]
    assert {p.rung for p in prov} == {"one_device"}
    single = _served(serve_qr.QRServer(device="cpu"), reqs)
    for t, want in zip(tickets, single):
        _agree(kind, eng.result(t), want)


# ------------------------------------------------------------ the CLI
def test_serve_qr_cli_mesh_csv_well_formed(capsys):
    """--check emits exactly-3-field CSV rows with ``mesh=4`` in the derived
    column and no stray spaces."""
    serve_qr.main(["--device", "cpu", "--requests", "11", "--n", "6", "--rows", "3",
                   "--mesh", "4", "--check"])
    lines = [ln for ln in capsys.readouterr().out.strip().splitlines() if "," in ln]
    assert lines[0] == "name,req_per_s,derived" and len(lines) == 2
    row = lines[1].split(",")
    assert len(row) == 3 and " " not in lines[1]
    assert row[0].startswith("serve_qr_pallas_n6_p3")
    float(row[1])
    derived = dict(kv.split("=") for kv in row[2].split(";"))
    assert derived["mesh"] == "4" and derived["max_batch"] == "64"
    assert float(derived["xbackend_maxerr"]) < 1e-4


def test_serve_qr_cli_metrics_meta_carries_the_mesh(tmp_path, capsys):
    prefix = tmp_path / "m"
    serve_qr.main(["--device", "cpu", "--requests", "11", "--n", "6", "--rows", "3",
                   "--mesh", "4", "--resilient", "--metrics", str(prefix)])
    assert "mesh=4" in capsys.readouterr().out
    meta = obs.load_jsonl(f"{prefix}.jsonl")[-1]["meta"]
    assert meta["mesh"] == 4


def test_serve_qr_cli_rejects_oversized_mesh(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit, match=re.escape("8-device batch mesh")):
        serve_qr.main(["--device", "cuda", "--mesh", "8"])
