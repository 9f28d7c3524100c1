"""Port parity: repro_torch.checkpoint against the JAX package's
repro.checkpoint — the same keys letter for letter, bitwise round trips,
placement from ``like``, atomic publish, and snapshots that restore across
the two packages."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.solvers.kalman import KalmanState as JKalmanState
from repro.solvers.lstsq import RLSState as JRLSState
from repro_torch.checkpoint import ckpt, latest_step, restore, save
from repro_torch.convert import from_numpy
from repro_torch.solvers import KalmanState, RLSState


def _arrays(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return (np.triu(rng.standard_normal((n, n))).astype(np.float32),
            rng.standard_normal((n, 1)).astype(np.float32))


def _trees(seed=0):
    """(JAX tree, port tree) pairs of the same arrays, one per structure."""
    R, d = _arrays(seed)
    cnt = np.asarray(7, dtype=np.int32)
    jrls = JRLSState(R=jnp.asarray(R), d=jnp.asarray(d), count=jnp.asarray(cnt))
    rls = RLSState(R=torch.as_tensor(R), d=torch.as_tensor(d), count=torch.as_tensor(cnt))
    jkf = JKalmanState(R=jnp.asarray(R), d=jnp.asarray(d[:, 0]),
                       step=jnp.asarray(cnt))
    kf = KalmanState(R=torch.as_tensor(R), d=torch.as_tensor(d[:, 0]),
                     step=torch.as_tensor(cnt))
    return {
        "rls": (jrls, rls),
        "kalman": (jkf, kf),
        "dict": ({"b": jrls, "a": [jnp.asarray(d), (jnp.asarray(R), None)]},
                 {"b": rls, "a": [torch.as_tensor(d), (torch.as_tensor(R), None)]}),
        "list": ([jkf, {"x": jnp.asarray(R)}], [kf, {"x": torch.as_tensor(R)}]),
    }


@pytest.mark.parametrize("name", ["rls", "kalman", "dict", "list"])
def test_keys_equal_the_reference(name):
    jtree, tree = _trees()[name]
    jflat, _ = jckpt._flatten(jtree)
    flat = ckpt._flatten(tree)
    assert list(flat) == list(jflat)
    for k in flat:
        np.testing.assert_array_equal(flat[k], np.asarray(jflat[k]))
    if name == "rls":  # a named tuple's field prints as .<name>
        assert list(flat) == [".R", ".d", ".count"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32, torch.int64])
def test_bitwise_round_trip(tmp_path, dtype):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((5, 3), generator=gen, dtype=torch.float64) * 1e3
    x = x.to(dtype)
    tree = {"x": x, "pair": (x[:2] + 1, x.amax())}
    path = save(str(tmp_path), 4, tree, extra={"data_step": 11})
    assert os.path.basename(path) == "step_00000004"
    like = {"x": torch.zeros_like(x), "pair": (torch.zeros_like(x[:2]), torch.zeros_like(x.amax()))}
    out, extra = restore(str(tmp_path), 4, like)
    assert extra == {"data_step": 11}
    for a, b in ((out["x"], x), (out["pair"][0], x[:2] + 1), (out["pair"][1], x.amax())):
        assert a.dtype == dtype and torch.equal(a, b)


def test_dtype_and_device_from_like(tmp_path):
    R, d = _arrays(1)
    save(str(tmp_path), 1, RLSState(R=torch.as_tensor(R), d=torch.as_tensor(d),
                                    count=torch.tensor(3, dtype=torch.int32)))
    like = RLSState(R=torch.zeros((4, 4), dtype=torch.float64),
                    d=torch.zeros((4, 1), dtype=torch.float64),
                    count=torch.zeros((), dtype=torch.int64))
    out, _ = restore(str(tmp_path), 1, like)
    assert out.R.dtype == torch.float64 and out.count.dtype == torch.int64
    assert out.R.device == like.R.device
    np.testing.assert_array_equal(out.R.numpy(), R.astype(np.float64))
    assert int(out.count) == 3
    with pytest.raises(ValueError, match="structure mismatch"):
        restore(str(tmp_path), 1, {"R": like.R})


def test_crashed_save_does_not_shadow_last_good_step(tmp_path):
    R, d = _arrays(2)
    state = RLSState(R=torch.as_tensor(R), d=torch.as_tensor(d),
                     count=torch.tensor(1, dtype=torch.int32))
    save(str(tmp_path), 5, state)
    # a save of step 6 that died before its rename: the tmp dir without a
    # manifest, and one with a manifest but never published
    os.makedirs(tmp_path / "tmp.6")
    np.savez(tmp_path / "tmp.6" / "leaves.npz", **{".R": np.full((4, 4), np.nan)})
    os.makedirs(tmp_path / "tmp.7")
    with open(tmp_path / "tmp.7" / "manifest.json", "w") as f:
        json.dump({"step": 7, "keys": [], "extra": {}}, f)
    assert latest_step(str(tmp_path)) == 5
    assert latest_step(str(tmp_path / "absent")) is None
    out, _ = restore(str(tmp_path), latest_step(str(tmp_path)), state)
    assert torch.equal(out.R, state.R) and torch.equal(out.d, state.d)
    save(str(tmp_path), 6, state)  # a retried save replaces the stale tmp
    assert latest_step(str(tmp_path)) == 6 and not (tmp_path / "tmp.6").exists()


@pytest.mark.parametrize("name", ["rls", "kalman", "dict", "list"])
def test_snapshots_restore_across_packages(tmp_path, name):
    jtree, tree = _trees(4)[name]
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(jdir, 3, jtree, extra={"who": "jax"})
    save(pdir, 3, tree, extra={"who": "port"})
    # the port restores the JAX package's files, and the other way round
    out, extra = restore(jdir, 3, tree)
    assert extra == {"who": "jax"}
    jout, jextra = jckpt.restore(pdir, 3, jtree)
    assert jextra == {"who": "port"}
    a, b = ckpt._flatten(out), ckpt._flatten(tree)
    ja, jb = jckpt._flatten(jout)[0], jckpt._flatten(jtree)[0]
    assert list(a) == list(b) == list(ja) == list(jb)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(np.asarray(ja[k]), np.asarray(jb[k]))
    # the two packages' files hold the same bits
    with np.load(os.path.join(jdir, "step_00000003", "leaves.npz")) as f1, \
            np.load(os.path.join(pdir, "step_00000003", "leaves.npz")) as f2:
        assert sorted(f1.files) == sorted(f2.files)
        for k in f1.files:
            assert f1[k].dtype == f2[k].dtype
            np.testing.assert_array_equal(f1[k], f2[k])


def test_shardings_raise(tmp_path):
    """``shardings=`` places leaves over the default process group, so it
    raises where none is initialized (the placements themselves are held
    against the JAX package's in tests/test_torch_distributed.py)."""
    tree = {"x": torch.ones(2)}
    save(str(tmp_path), 1, tree)
    with pytest.raises(ValueError, match="shardings.*process group"):
        restore(str(tmp_path), 1, tree, shardings={"x": None})


def test_restore_accepts_trees_converted_from_numpy(tmp_path):
    R, d = _arrays(5)
    state = from_numpy(JRLSState(R=R, d=d, count=np.asarray(2, np.int32)), "cpu")
    assert isinstance(state, RLSState)
    save(str(tmp_path), 2, state)
    out, _ = restore(str(tmp_path), 2, state)
    assert isinstance(out, RLSState) and torch.equal(out.R, state.R)
