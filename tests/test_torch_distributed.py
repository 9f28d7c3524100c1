"""Port parity: repro_torch.core.distributed, checkpoint.restore(shardings=)
and repro_torch.optim against the JAX package.

The same numpy inputs go through the reference in one JAX subprocess (meshes
``Mesh(np.array(jax.devices()[:P]), ("x",))`` of P forced host devices, whose
axes are Auto) and through the port in P spawned gloo ranks
(``repro_torch.testing.spawn``), one spawn a world size, every case of that
size in it.  The optimizers run in this process against the reference on
the same f32 trees, the JAX states carried in through ``repro_torch.convert``.

The spawned ranks import this module by name, so it imports JAX only inside
the functions that use it.
"""
import gc
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint import restore, save
from repro_torch.core import blocked, distributed
from repro_torch.testing.spawn import spawn_ranks

_REPO = Path(__file__).resolve().parents[1]
WORLDS = (1, 2, 4, 8)
PANEL = 4
QR_SHAPES = {"tall": (96, 64), "square": (64, 64)}
DTYPES = {"f64": (np.float64, 1e-10), "f32": (np.float32, 1e-4)}
LAYOUTS = ("logical", "cyclic")


def _inputs() -> dict:
    rng = np.random.default_rng(22)
    x = {f"qr/{k}": rng.standard_normal(s) for k, s in QR_SHAPES.items()}
    x["tsqr"] = rng.standard_normal((128, 16))
    x["tsqr/square"] = rng.standard_normal((64, 16))
    return x


def _ckpt_tree():
    """A checkpoint tree: leaves sharded along dims 1 and 0, two replicated."""
    rng = np.random.default_rng(5)
    tree = {"w": rng.standard_normal((8, 12)).astype(np.float32),
            "b": rng.standard_normal(8).astype(np.float32),
            "u": rng.standard_normal(6).astype(np.float32),
            "s": {"x": rng.standard_normal((8, 4, 2))}}
    return {k: (torch.as_tensor(v) if isinstance(v, np.ndarray)
                else {kk: torch.as_tensor(vv) for kk, vv in v.items()})
            for k, v in tree.items()}


def _shardings():
    from torch.distributed.tensor import Replicate, Shard

    return {"w": Shard(1), "b": None, "u": Replicate(), "s": {"x": Shard(0)}}


# ------------------------------------------------------------------ the ranks
def _catch(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _rank_cases(x: dict, ckpt_dir: str) -> dict:
    """Every port case of this world size, on this rank; the results are this
    rank's shards."""
    P, r = dist.get_world_size(), dist.get_rank()
    out = {}
    for shape in QR_SHAPES:
        for dt, (np_dt, _) in DTYPES.items():
            A = x[f"qr/{shape}"].astype(np_dt)
            nl = A.shape[1] // P
            perm, _ = distributed.cyclic_perm(A.shape[1], P, PANEL)
            for layout, full in (("logical", A), ("cyclic", A[:, perm])):
                shard = torch.as_tensor(full[:, r * nl:(r + 1) * nl])
                out[f"qr/{shape}/{dt}/{layout}"] = distributed.distributed_ggr_qr_1d(
                    shard, panel=PANEL, layout=layout)
    B = x["tsqr"]
    ml = B.shape[0] // P
    for dt, (np_dt, _) in DTYPES.items():
        out[f"tsqr/{dt}"] = distributed.tsqr(
            torch.as_tensor(B[r * ml:(r + 1) * ml].astype(np_dt)))
    for refine in (True, False):
        out[f"orth/{refine}"] = distributed.distributed_orthogonalize(
            torch.as_tensor(B[r * ml:(r + 1) * ml]), refine=refine)
    # the errors: n % panel, then the panel count over the ranks
    out["err/panel"] = _catch(lambda: distributed.distributed_ggr_qr_1d(
        torch.zeros(64, 64 // P, dtype=torch.float64), panel=5))
    out["err/split"] = _catch(lambda: distributed.distributed_ggr_qr_1d(
        torch.zeros(16, 6, dtype=torch.float64), panel=PANEL))
    if P == 4:
        Bs = x["tsqr/square"]  # 16 rows a rank for 16 columns
        out["tsqr/square"] = distributed.tsqr(torch.as_tensor(Bs[16 * r:16 * (r + 1)]))
        pair, three = dist.new_group([0, 1]), dist.new_group([0, 1, 2])
        if r < 2:  # a subgroup: its ranks alone build its pair groups
            out["tsqr/subgroup"] = distributed.tsqr(
                torch.as_tensor(B[64 * r:64 * (r + 1)]), group=pair)
        if r < 3:
            out["err/three"] = _catch(lambda: distributed.tsqr(
                torch.as_tensor(B[:48]), group=three))
        out["err/short"] = _catch(lambda: distributed.tsqr(
            torch.as_tensor(B[r * 8:(r + 1) * 8])))
        uneven = {"w": None, "b": None, "u": _shardings()["s"]["x"], "s": None}
        out["err/uneven"] = _catch(lambda: restore(ckpt_dir, 1, _ckpt_tree(),
                                                   shardings=uneven))
    if P in (2, 4):
        out["restore"], _ = restore(ckpt_dir, 1, _ckpt_tree(), shardings=_shardings())
    return out


# ------------------------------------------------------- the JAX reference
_REFERENCE = """
import sys
import numpy as np, jax, jax.numpy as jnp
jax.config.update("jax_enable_x64", True)
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.checkpoint.ckpt import restore
from repro.core.distributed import (cyclic_perm, distributed_ggr_qr_1d,
                                    distributed_orthogonalize, tsqr)

tmp = sys.argv[1]
x = dict(np.load(tmp + "/inputs.npz"))
out = {}
for nP in (1, 2, 4, 8):
    mesh = Mesh(np.array(jax.devices()[:nP]), ("x",))
    cols, rows = NamedSharding(mesh, P(None, "x")), NamedSharding(mesh, P("x", None))
    for shape in ("tall", "square"):
        for dt, np_dt in (("f64", np.float64), ("f32", np.float32)):
            A = x["qr/" + shape].astype(np_dt)
            perm, _ = cyclic_perm(A.shape[1], nP, 4)
            for layout, full in (("logical", A), ("cyclic", A[:, perm])):
                f = jax.jit(lambda X: distributed_ggr_qr_1d(X, mesh, "x", panel=4,
                                                            layout=layout))
                out[f"qr/{shape}/{dt}/{layout}/{nP}"] = np.asarray(
                    f(jax.device_put(full, cols)))
    for dt, np_dt in (("f64", np.float64), ("f32", np.float32)):
        B = jax.device_put(x["tsqr"].astype(np_dt), rows)
        out[f"tsqr/{dt}/{nP}"] = np.asarray(jax.jit(lambda X: tsqr(X, mesh, "x"))(B))
    B = jax.device_put(x["tsqr"], rows)
    with jax.set_mesh(mesh):
        for refine in (True, False):
            f = jax.jit(lambda X: distributed_orthogonalize(X, mesh, "x", refine=refine))
            out[f"orth/{refine}/{nP}"] = np.asarray(f(B))
    if nP == 4:
        Bs = jax.device_put(x["tsqr/square"], rows)
        out["tsqr/square/4"] = np.asarray(jax.jit(lambda X: tsqr(X, mesh, "x"))(Bs))
    if nP in (2, 4):
        like = {"w": jnp.zeros((8, 12), jnp.float32), "b": jnp.zeros(8, jnp.float32),
                "u": jnp.zeros(6, jnp.float32), "s": {"x": jnp.zeros((8, 4, 2))}}
        specs = {"w": P(None, "x"), "b": P(), "u": P(), "s": {"x": P("x")}}
        shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), specs)
        tree, _ = restore(tmp + "/ckpt", 1, like, shardings)
        for key, arr in (("w", tree["w"]), ("b", tree["b"]), ("u", tree["u"]),
                         ("s/x", tree["s"]["x"])):
            for s in arr.addressable_shards:
                d = list(mesh.devices).index(s.device)
                out[f"restore/{key}/{d}/{nP}"] = np.asarray(s.data)
np.savez(tmp + "/reference.npz", **out)
"""


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Inputs and the checkpoint, on disk for both packages."""
    tmp = tmp_path_factory.mktemp("dist")
    np.savez(tmp / "inputs.npz", **_inputs())
    save(str(tmp / "ckpt"), 1, _ckpt_tree())
    return tmp


@pytest.fixture(scope="module")
def reference_run(workdir):
    """The JAX reference, started first so that it runs beside the spawns."""
    env = dict(os.environ, PYTHONPATH=str(_REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                             str(workdir)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def port(reference_run, workdir):
    """Every rank's results at each world size, one spawn a size, made while
    the reference runs."""
    return {P: spawn_ranks(_rank_cases, P, _inputs(), str(workdir / "ckpt"),
                           timeout_s=300) for P in WORLDS}


@pytest.fixture(scope="module")
def ref(port, reference_run, workdir):
    out, _ = reference_run.communicate(timeout=600)
    assert reference_run.returncode == 0, out
    with np.load(workdir / "reference.npz") as data:
        return dict(data)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, rel * np.abs(want).max())


# -------------------------------------------------------- distributed QR
@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", QR_SHAPES)
def test_qr_1d_matches_reference(port, ref, P, layout, dt, shape):
    """Signed R in every row, the square case's last pivot row included:
    both packages sweep all ``panel`` columns of a panel."""
    key = f"qr/{shape}/{dt}/{layout}"
    R = torch.cat([res[key] for res in port[P]], dim=1)
    assert R.dtype == getattr(torch, {"f64": "float64", "f32": "float32"}[dt])
    _close(R, ref[f"{key}/{P}"], DTYPES[dt][1])


@pytest.mark.parametrize("P", WORLDS[1:])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_qr_1d_ranks_equal_one_rank_bitwise(port, P, layout):
    """Each rank replays the broadcast factors over its own columns only; a
    column's arithmetic does not depend on which rank holds it."""
    for shape, (_, n) in QR_SHAPES.items():
        for dt in DTYPES:
            key = f"qr/{shape}/{dt}/{layout}"
            R = torch.cat([res[key] for res in port[P]], dim=1)
            if layout == "cyclic":  # both back to logical column order
                R = R[:, distributed.cyclic_perm(n, P, PANEL)[1]]
            assert torch.equal(R, port[1][0][key]), key


@pytest.mark.parametrize("P", WORLDS)
def test_qr_1d_refuses_bad_splits(port, P):
    for res in port[P]:
        assert "panel multiple" in res["err/panel"]
        if P > 1:  # 6 local columns: 1.5 P panels of 4
            assert "do not divide evenly" in res["err/split"]


def test_qr_1d_refuses_an_unknown_layout():
    with pytest.raises(ValueError, match="layout"):
        distributed.distributed_ggr_qr_1d(torch.zeros(4, 4), layout="rows")


@pytest.mark.parametrize("n,nP,panel", [(64, 4, 4), (96, 2, 8), (32, 8, 4), (12, 1, 3)])
def test_cyclic_perm_is_the_reference(n, nP, panel):
    from repro.core.distributed import cyclic_perm

    for a, b in zip(distributed.cyclic_perm(n, nP, panel), cyclic_perm(n, nP, panel)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ TSQR
@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("dt", DTYPES)
def test_tsqr_matches_reference(port, ref, P, dt):
    results = port[P]
    for res in results[1:]:  # replicated: the same R on every rank
        assert torch.equal(res[f"tsqr/{dt}"], results[0][f"tsqr/{dt}"])
    _close(results[0][f"tsqr/{dt}"], ref[f"tsqr/{dt}/{P}"], DTYPES[dt][1])


def test_tsqr_with_square_local_blocks(port, ref):
    """m_local = n: every local R keeps its unnormalized last row, as the
    reference's ``ggr_geqrt`` leaves it."""
    for res in port[4]:
        _close(res["tsqr/square"], ref["tsqr/square/4"], 1e-10)


def test_tsqr_over_a_subgroup(port, ref):
    """Ranks 0 and 1 of the 4-rank world reduce their rows alone: the
    reference's R at P = 2."""
    for res in port[4][:2]:
        _close(res["tsqr/subgroup"], ref["tsqr/f64/2"], 1e-10)


def test_pair_groups_are_cached_per_group_and_go_with_it(monkeypatch):
    class Group:  # stands in for a process group
        pass

    made = []
    monkeypatch.setattr(distributed.dist, "new_group",
                        lambda ranks, **kw: made.append(tuple(ranks)) or Group())
    a, b = Group(), Group()
    before = len(distributed._PAIRS)
    pair = distributed._pair_group(a, 2, 0)
    assert distributed._pair_group(a, 0, 2) is pair
    assert distributed._pair_group(b, 0, 2) is not pair
    assert made == [(0, 2), (0, 2)]
    assert len(distributed._PAIRS) == before + 2
    del a
    gc.collect()
    assert len(distributed._PAIRS) == before + 1 and b in distributed._PAIRS


def test_tsqr_refuses_what_it_cannot_reduce(port):
    results = port[4]
    for res in results[:3]:
        assert "power-of-two" in res["err/three"]
    for res in results:
        assert "at least as many local rows" in res["err/short"]


@pytest.mark.parametrize("shape", [(16, 16), (40, 16), (33, 7), (96, 64)])
def test_tsqr_local_r_is_ggr_geqrts_r(shape):
    """The fused schedule over min(m - 1, n) pivots gives the R of the
    port's ``ggr_geqrt``, bit for bit, the square case's unnormalized last
    row included, without forming its m x m transform."""
    A = torch.as_tensor(np.random.default_rng(sum(shape)).standard_normal(shape))
    R, _ = blocked.ggr_geqrt(A)
    assert torch.equal(distributed.tsqr_local_r(A), R[:shape[1]])


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("refine", [True, False])
def test_orthogonalize_matches_reference(port, ref, P, refine):
    Q = torch.cat([res[f"orth/{refine}"] for res in port[P]], dim=0).numpy()
    np.testing.assert_allclose(Q, ref[f"orth/{refine}/{P}"], rtol=0, atol=1e-9)
    assert np.abs(Q.T @ Q - np.eye(Q.shape[1])).max() < 1e-6


# ------------------------------------------------------ sharded restore
@pytest.mark.parametrize("P", [2, 4])
def test_restore_shards_equal_the_references(port, ref, P):
    """Rank r's block is the addressable shard ``device_put`` gives device r,
    bit for bit, as a plain tensor of ``like``'s dtype."""
    for r, res in enumerate(port[P]):
        tree = res["restore"]
        for key, got in (("w", tree["w"]), ("b", tree["b"]), ("u", tree["u"]),
                         ("s/x", tree["s"]["x"])):
            want = ref[f"restore/{key}/{r}/{P}"]
            assert type(got) is torch.Tensor and got.dtype == torch.as_tensor(want).dtype
            np.testing.assert_array_equal(got.numpy(), want)


def test_restore_refuses_an_uneven_split(port):
    for res in port[4]:
        assert "does not split evenly" in res["err/uneven"]


# ------------------------------------------------------------ optimizers
_OPT_SHAPES = {"square": (16, 16), "tall": (24, 8), "wide": (8, 24),
               "stacked": (3, 16, 8), "vector": (8,)}


def _tree(rng, shapes):
    return {"blocks": {k: rng.standard_normal(s).astype(np.float32)
                       for k, s in shapes.items() if k != "vector"},
            "vector": rng.standard_normal(shapes["vector"]).astype(np.float32)}


def _jnp_tree(tree):
    import jax.numpy as jnp

    return {k: _jnp_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _assert_trees_close(got, want, rel):
    want = dict(_leaves(want))
    for key, leaf in _leaves(got):
        w = np.asarray(want[key])
        err = np.abs(leaf.numpy().astype(np.float64) - w).max()
        assert err <= rel * np.abs(w).max(), (key, err)


def _run_both(name, rel, steps=3):
    """``steps`` updates of the reference and of the port from the same
    trees, the port's state converted from the reference's initial state."""
    import repro.optim as jopt
    from repro_torch import optim
    from repro_torch.convert import from_numpy

    rng = np.random.default_rng(0)
    params = _tree(rng, _OPT_SHAPES)
    jinit, jupdate = jopt.make_optimizer(name)
    init, update = optim.make_optimizer(name)
    jp = _jnp_tree(params)
    js = jinit(jp)
    tp, ts = from_numpy(params, "cpu"), from_numpy(js, "cpu")
    assert type(ts) is getattr(optim, type(js).__name__)
    for _ in range(steps):
        g = _tree(rng, _OPT_SHAPES)
        jp, js = jupdate(_jnp_tree(g), js, jp, 1e-2)
        tp, ts = update(from_numpy(g, "cpu"), ts, tp, 1e-2)
        _assert_trees_close(tp, jp, rel)
    assert int(ts.step) == int(js.step) == steps
    return tp, ts, jp, js


def test_adamw_matches_reference():
    tp, ts, _, js = _run_both("adamw", 1e-6)
    _assert_trees_close(ts.m, js.m, 1e-6)
    _assert_trees_close(ts.v, js.v, 1e-6)


def test_orthant_matches_reference():
    """Within 1e-4: the triangular solve amplifies the R factors' rounding
    differences by cond(R)."""
    tp, ts, _, js = _run_both("orthant", 1e-4)
    _assert_trees_close(ts.momentum, js.momentum, 1e-6)
    _assert_trees_close(ts.v, js.v, 1e-6)


def test_orthant_keeps_the_references_sign_in_the_last_column():
    """Square momenta whose reference R has R[-1, -1] < 0 (the last row
    ``ggr_geqrt`` leaves unnormalized) give the same signed direction."""
    import jax
    import jax.numpy as jnp

    from repro.core.blocked import ggr_geqrt
    from repro.optim import orthant as jorthant
    from repro_torch.optim import orthant

    reference = jax.jit(jorthant._orthogonalize)
    negative = 0
    for seed in range(12):
        M = np.random.default_rng(seed).standard_normal((16, 16)).astype(np.float32)
        R, _ = ggr_geqrt(jnp.asarray(M / np.sqrt((M * M).mean())))
        negative += float(R[-1, -1]) < 0
        want = np.asarray(reference(jnp.asarray(M)))
        got = orthant._orthogonalize(torch.as_tensor(M)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        assert np.array_equal(np.sign(got[:, -1]), np.sign(want[:, -1])) or (
            np.abs(want[:, -1]).min() < 1e-4)
    assert negative >= 2  # the draws hold the case this test is about


def test_orthant_folds_stacked_leaves_into_one_batch(monkeypatch):
    """A (3, 16, 8) stack is one call of the blocked driver, not one a layer."""
    from repro_torch.optim import orthant

    calls = []
    real = orthant.ggr_triangularize_blocked
    monkeypatch.setattr(orthant, "ggr_triangularize_blocked",
                        lambda X, *a, **k: calls.append(X.shape) or real(X, *a, **k))
    M = torch.randn(3, 2, 16, 8)
    Q = orthant._orthogonalize(M)
    assert calls == [(6, 16, 8)] and Q.shape == M.shape
    for i in range(3):
        for j in range(2):
            assert torch.equal(Q[i, j], orthant._orthogonalize(M[i, j][None])[0])


def test_compress_matches_reference():
    import jax.numpy as jnp

    from repro.optim import compress as jcompress
    from repro_torch.convert import from_numpy
    from repro_torch.optim import compress

    rng = np.random.default_rng(3)
    params = _tree(rng, _OPT_SHAPES)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    x[0, :3] = [0.5, -1.5, 2.5]  # halves: rounded to even
    x *= 127.0 / 2.5
    jq, js = jcompress.quantize(jnp.asarray(x))
    q, s = compress.quantize(torch.as_tensor(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(compress.dequantize(q, s).numpy(),
                                  np.asarray(jcompress.dequantize(jq, js)))
    jp = _jnp_tree(params)
    jstate = jcompress.init(jp)
    state = from_numpy(jstate, "cpu")
    assert type(state) is compress.EFState
    for _ in range(3):
        g = _tree(rng, _OPT_SHAPES)
        jgq, jstate = jcompress.compress_grads(_jnp_tree(g), jstate)
        gq, state = compress.compress_grads(from_numpy(g, "cpu"), state)
        _assert_trees_close(gq, jgq, 1e-6)
        _assert_trees_close(state.residual, jstate.residual, 1e-6)
    assert compress.compressed_bytes(from_numpy(params, "cpu")) == \
        jcompress.compressed_bytes(jp)


@pytest.mark.parametrize("shape", [(3, 16, 16), (2, 24, 8), (2, 8, 24)])
def test_direction_readings_hold_orthant_against_its_plain_driver(shape):
    """On the host the wrappers run their plain versions, so the readings of
    Orthant's own direction equal those of the plain driver's bit for bit;
    both faulty directions read far over them."""
    from repro_torch.testing.orthant_check import direction_readings

    M = torch.as_tensor(np.random.default_rng(5).standard_normal(shape).astype(np.float32))
    rd = direction_readings(M, faults=True)
    for i in (0, 1):
        assert torch.equal(rd["kernels"][i], rd["plain"][i])
        assert bool((rd["kernels"][i] < 1e-4).all())
    assert bool((rd["flipped"][1] > 1e3 * rd["plain"][1]).all())
    assert bool((torch.maximum(rd["half"][0] / rd["plain"][0],
                               rd["half"][1] / rd["plain"][1]) > 100).all())


def test_plain_driver_restores_the_kernels():
    from repro_torch.testing.orthant_check import plain_driver

    saved = blocked.panel_factor, blocked.apply_factors
    with pytest.raises(RuntimeError, match="inside"):
        with plain_driver():
            assert blocked.panel_factor is not saved[0]
            raise RuntimeError("inside")
    assert (blocked.panel_factor, blocked.apply_factors) == saved


def test_plain_driver_hands_each_kernel_launch_to_hold(monkeypatch):
    """With ``hold``, each plain step also runs the kernel wrapper on the
    same inputs, and ``hold`` gets every (shape, param, dtype, accum) the
    wrapper launched at with both results; the wrappers keep the launches
    they recorded before.  On the host nothing launches, so the wrappers are
    stood in for by ones that record a launch and run the plain version."""
    from repro_torch.kernels import ggr_apply, ggr_panel
    from repro_torch.testing.orthant_check import direction_readings

    def recording(fn, key):
        def wrapper(*args, **kwargs):
            wrapper.shapes.add(key(*args))
            return fn(*args, **kwargs)
        wrapper.__name__, wrapper.shapes = fn.__name__, {"earlier"}
        return wrapper

    panel = recording(ggr_panel.panel_factor, lambda x, p0: (tuple(x.shape), p0))
    apply = recording(ggr_apply.apply_factors,
                      lambda V, T, C, p0: (tuple(C.shape), (V.shape[-1], p0)))
    monkeypatch.setattr(ggr_panel, "panel_factor", panel)
    monkeypatch.setattr(ggr_apply, "apply_factors", apply)
    got = []
    M = torch.as_tensor(np.random.default_rng(6).standard_normal((2, 150, 70))
                        .astype(np.float32))
    direction_readings(M, hold=lambda name, key, k, p: got.append((name, key, k, p)))
    names = [name for name, *_ in got]
    assert names.count("panel_factor") == 2 and names.count("apply_factors") == 1
    for name, key, k, p in got:
        assert key in (panel if name == "panel_factor" else apply).shapes
        k, p = (k, p) if isinstance(k, tuple) else ((k,), (p,))
        assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert "earlier" in panel.shapes and "earlier" in apply.shapes


def test_optimizer_trees_must_match():
    from repro_torch.optim import adamw

    params = {"a": torch.zeros(2, 2)}
    with pytest.raises(ValueError, match="structure"):
        adamw.update({"b": torch.zeros(2, 2)}, adamw.init(params), params, 1e-2)
