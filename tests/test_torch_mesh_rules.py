"""The port's LM sharding rules (``repro_torch.parallel.sharding``) against
the JAX package's, and ``launch.mesh``'s meshes.

Every arch of ``configs/`` at its published widths: the reference's specs
over ``jax.eval_shape`` trees on an ``AbstractMesh``, the port's over the
meta device on a ``MeshShape`` — no device holds a parameter and no process
group is formed, so the 256- and 512-rank production meshes are covered."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs
from repro.models import encdec as jax_encdec
from repro.models import serve as jax_serve
from repro.models import transformer as jax_tmod
from repro.optim import make_optimizer as jax_make_optimizer
from repro.parallel import sharding as jsh
from repro_torch.configs import get_config
from repro_torch.launch import mesh as lmesh
from repro_torch.models import encdec, serve, transformer
from repro_torch.optim import make_optimizer
from repro_torch.parallel import sharding as tsh
from repro_torch.parallel.sharding import MeshShape, P, map_named

MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((1, 4), ("data", "model")), ((4, 1), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]


def meshes(shape, axes):
    return AbstractMesh(shape, axes), MeshShape(dict(zip(axes, shape)))


def as_tuple(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in spec)


def jax_named(tree) -> dict:
    """{path: leaf} of a JAX tree, its path as the port's ``_walk`` spells it."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        key = []
        for p in path:
            if isinstance(p, jax.tree_util.DictKey):
                key.append(str(p.key))
            elif isinstance(p, jax.tree_util.GetAttrKey):
                key.append(f".{p.name}")
            else:
                key.append(str(p.idx))
        out["/".join(key)] = leaf
    return out


def port_named(tree, path=()) -> dict:
    if isinstance(tree, tuple) and hasattr(tree, "_fields") and not isinstance(tree, P):
        out = {}
        for name, v in zip(tree._fields, tree):
            out.update(port_named(v, path + (f".{name}",)))
        return out
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_named(v, path + (str(k),)))
        return out
    return {"/".join(path): tree}


_SHAPES = {}


def shape_trees(arch: str):
    """(reference param+opt shapes, port param+opt meta tensors), cached."""
    if arch not in _SHAPES:
        jcfg = jax_get_config(arch)
        key = jax.random.PRNGKey(0)
        jinit = jax_encdec.init_encdec if jcfg.family == "encdec" else jax_tmod.init_lm
        jparams = jax.eval_shape(lambda: jinit(jcfg, key))
        jopt = jax.eval_shape(jax_make_optimizer("orthant")[0], jparams)
        cfg = get_config(arch)
        init = encdec.init_encdec if cfg.family == "encdec" else transformer.init_lm
        params = init(cfg, torch.Generator(), device="meta")
        opt = make_optimizer("orthant")[0](params)
        _SHAPES[arch] = (jcfg, cfg, {"params": jparams, "opt": jopt},
                         {"params": params, "opt": opt})
    return _SHAPES[arch]


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", list_archs())
def test_param_pspecs_equal_the_reference(arch, shape, axes, fsdp):
    """``param_pspecs`` over the params and Orthant's state (momenta, v and
    its scalar step) at published widths: the same spec for every leaf,
    with ``fsdp`` off (the Trainer's) and on."""
    jcfg, cfg, jtree, ttree = shape_trees(arch)
    amesh, smesh = meshes(shape, axes)
    want = jax_named(jsh.param_pspecs(jtree, jcfg, jsh.MeshRules(amesh, fsdp=fsdp)))
    got = port_named(tsh.param_pspecs(ttree, cfg, tsh.MeshRules(smesh, fsdp=fsdp)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert as_tuple(got[k]) == as_tuple(want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
def test_batch_activation_and_dp_rules(shape, axes):
    amesh, smesh = meshes(shape, axes)
    for sp in (False, True):
        jr, tr = jsh.MeshRules(amesh, sequence_parallel=sp), tsh.MeshRules(smesh,
                                                                        sequence_parallel=sp)
        assert (tr.data_axes, tr.model_size, tr.dp_size) == (jr.data_axes, jr.model_size,
                                                              jr.dp_size)
        for kind in ("tokens", "labels", "patch_embs", "frames", "token1"):
            assert as_tuple(tsh.batch_spec(kind, tr)) == as_tuple(jsh.batch_spec(kind, jr))
        assert as_tuple(tsh.activation_spec(tr)) == as_tuple(jsh.activation_spec(jr))
        with pytest.raises(ValueError):
            tsh.batch_spec("pixels", tr)
        # add_dp_axis / sanitize_spec on specs and shapes the rules do not reach
        for spec, shp in ((P(None, "model"), (32, 64)), (P("model", None), (7, 48)),
                          (P(None, None, None), (3, 16, 6)), (P(), (4096,)),
                          (P(None, "model"), (5, 3))):
            assert (as_tuple(tsh.add_dp_axis(spec, shp, tr))
                    == as_tuple(jsh.add_dp_axis(jax.sharding.PartitionSpec(*spec), shp, jr)))
            jspec = jax.sharding.PartitionSpec(*spec)
            assert (as_tuple(tsh.sanitize_spec(spec, shp, smesh))
                    == as_tuple(jsh.sanitize_spec(jspec, shp, amesh)))


@pytest.mark.parametrize("batch", [1, 8, 128])
@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
def test_cache_pspec_equals_the_reference(shape, axes, batch):
    """Every arch's decode cache at 32k positions (``long_500k``'s batch 1
    shards the sequence instead of the batch)."""
    amesh, smesh = meshes(shape, axes)
    for arch in list_archs():
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        jfn = jsh.cache_pspec(jcfg, jsh.MeshRules(amesh), batch)
        want = jax.tree_util.tree_map_with_path(jfn, jax_serve.cache_spec(jcfg, batch, 32768))
        tfn = tsh.cache_pspec(cfg, tsh.MeshRules(smesh), batch)
        got = map_named(tfn, {k: torch.empty(s.shape, device="meta")
                              for k, s in serve.cache_spec(cfg, batch, 32768).items()})
        assert sorted(got) == sorted(want), arch
        for k in want:
            assert as_tuple(got[k]) == as_tuple(want[k]), (arch, k)


def test_placements_follow_the_spec():
    """One placement a mesh dimension; a tuple entry shards its dimension
    over each of its axes, the first major (JAX's block order)."""
    from torch.distributed.tensor import Replicate, Shard

    m2 = MeshShape({"data": 2, "model": 4})
    m3 = MeshShape({"pod": 2, "data": 16, "model": 16})
    assert tsh.placements(P(None, "model"), m2) == (Replicate(), Shard(1))
    assert tsh.placements(P("model", None), m2) == (Replicate(), Shard(0))
    assert tsh.placements(P("data", None), m2) == (Shard(0), Replicate())
    assert tsh.placements(P(), m2) == (Replicate(), Replicate())
    assert tsh.placements(P(("pod", "data"), None, "model"), m3) == (Shard(0), Shard(0),
                                                                    Shard(2))
    with pytest.raises(ValueError, match="order"):
        tsh.placements(P(("data", "pod"), None), m3)
    with pytest.raises(ValueError, match="twice"):
        tsh.placements(P("model", "model"), m2)
    assert repr(P("data", None)) == "P('data', None)" and P("data", None) == ("data", None)


def test_rules_read_a_device_mesh_by_its_dimension_names():
    """``mesh_axes`` reads a ``DeviceMesh`` by ``mesh_dim_names`` (stand-in
    object: forming a real one needs a process group)."""
    fake = type("FakeMesh", (), {"mesh_dim_names": ("data", "model"), "shape": (2, 4)})()
    assert tsh.mesh_axes(fake) == {"data": 2, "model": 4}
    rules = tsh.MeshRules(fake)
    assert (rules.data_axes, rules.model_size, rules.dp_size) == (("data",), 4, 2)


@pytest.mark.parametrize("make,need", [
    (lambda: lmesh.make_production_mesh(device_type="cpu"), 256),
    (lambda: lmesh.make_production_mesh(multi_pod=True, device_type="cpu"), 512),
    (lambda: lmesh.make_debug_mesh(2, 2, device_type="cpu"), 4),
])
def test_meshes_need_their_ranks(make, need):
    """With no process group, each mesh names the ranks it needs; importing
    ``launch.mesh`` formed none."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match=f"needs {need} ranks.*no process group"):
        make()
    assert lmesh.PRODUCTION_SHAPES[False] == ((16, 16), ("data", "model"))
    assert lmesh.PRODUCTION_SHAPES[True] == ((2, 16, 16), ("pod", "data", "model"))


def test_rules_import_no_jax():
    """The port computes the rules with no JAX: a fresh interpreter that
    imports the port's sharding module and launch.mesh loads no ``jax``."""
    import subprocess
    import sys

    code = ("import sys; import repro_torch.parallel.sharding, repro_torch.launch.mesh, "
            "repro_torch.train; print(sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'repro.'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_meta_shapes_match_the_reference():
    """The port's meta-device trees have the reference's leaf shapes (the
    precondition of the spec comparisons above)."""
    for arch in ("olmo-1b", "arctic-480b", "seamless-m4t-large-v2"):
        _, _, jtree, ttree = shape_trees(arch)
        want = {k: tuple(v.shape) for k, v in jax_named(jtree).items()}
        got = {k: tuple(v.shape) for k, v in port_named(ttree).items()}
        assert got == want, arch
        assert all(v.device.type == "meta" for v in port_named(ttree).values()
                   if isinstance(v, torch.Tensor) and v.ndim)


def test_meshshape_keeps_its_axis_order():
    m = MeshShape({"pod": 2, "data": 16, "model": 16})
    assert m.axis_names == ("pod", "data", "model")
    assert tsh.mesh_axes(m) == {"pod": 2, "data": 16, "model": 16}
    assert dataclasses.replace(m, shape={"data": 1, "model": 1}).axis_names == ("data", "model")
    assert np.prod(list(m.shape.values())) == 512
