"""Wide accumulation (f32 / bf16 / f16 tiles with f64 sums) and the repairs
that came with it: one rounding from f64 to f16, the row-parallel gradient
under sequence parallelism, and the decode write into a cache split along
its sequence.

- The four kernels' plain versions and the blocked driver (tree and fused)
  equal the JAX package bit for bit at ``Precision(t, "float64", t)`` for t
  = f32, bf16 and f16, on seeded numpy inputs (the JAX kernels in interpret
  mode).  With the f64 -> f16 casts of ``Tensor.to`` (two roundings) the
  f16 cases differ.
- ``kernels.backend.to_tile`` rounds f64 to f16 once, as numpy and XLA do.
- A decode step on a real 2-rank gloo mesh, batch 1, its KV cache split
  along the sequence over the data axis, within 1e-4 of each output's rms
  of one device at f32 (the mesh tests' rule), step by step.
- The dry run's long_500k cells (whose caches split their sequence) run on
  the fake 16x16 mesh.

JAX is imported inside the tests that use it: the spawned ranks import this
module by name.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import Precision
from repro_torch.kernels.backend import to_tile
from repro_torch.launch import dryrun

TILES = ("float32", "bfloat16", "float16")
FUNCS = ("update", "geqrt", "panel", "apply", "tree", "fused")
GAP = 1e-4  # decode on the mesh vs one device, of each output's rms
DECODE_ARCHS = ("olmo-1b", "zamba2-1.2b")
CACHE_LEN, STEPS = 8, 6  # slots 0-5: both ranks' blocks of the cache


def _f64(x) -> np.ndarray:
    """A JAX or torch array's values as float64 numpy (exact for every tile
    dtype)."""
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    import jax.numpy as jnp

    return np.asarray(x.astype(jnp.float64))


def _run(fn: str, tile: str, rng):
    """(JAX result, port result) of ``fn`` at (tile, f64 sums) on the same
    seeded inputs: tuples of arrays."""
    import jax.numpy as jnp

    from repro.core.blocked import ggr_triangularize_blocked as jax_blocked
    from repro.kernels.backend import Precision as JaxPrecision
    from repro.kernels.ggr_apply import apply_factors_pallas
    from repro.kernels.ggr_panel import batched_geqrt_pallas, panel_factor_pallas
    from repro.kernels.ggr_update import batched_update_pallas
    from repro_torch.core.blocked import ggr_triangularize_blocked
    from repro_torch.kernels import batched_geqrt, batched_update
    from repro_torch.kernels.ggr_apply import apply_factors
    from repro_torch.kernels.ggr_panel import panel_factor

    jp, tp = JaxPrecision(tile, "float64", tile), Precision(tile, "float64", tile)
    if fn == "update":
        X = rng.standard_normal((8, 40, 41)).astype(np.float32)
        X[:, :32, :32] = np.triu(X[:, :32, :32])
        X[0] = 0.0  # a padding problem: a fixed point
        return ((batched_update_pallas(jnp.asarray(X), 32, interpret=True, precision=jp),),
                (batched_update(torch.from_numpy(X), 32, precision=tp),))
    if fn == "geqrt":
        X = rng.standard_normal((8, 32, 64)).astype(np.float32)
        return ((batched_geqrt_pallas(jnp.asarray(X), 32, interpret=True, precision=jp),),
                (batched_geqrt(torch.from_numpy(X), 32, precision=tp),))
    if fn in ("panel", "apply"):
        X = rng.standard_normal((96, 16)).astype(np.float32)
        ref = panel_factor_pallas(jnp.asarray(X), 0, interpret=True, precision=jp)
        if fn == "panel":
            return ref, panel_factor(torch.from_numpy(X), 0, precision=tp)
        C = rng.standard_normal((96, 40)).astype(np.float32)
        V, T = ref[1:]  # the tile-dtype factors, on both sides
        Vt, Tt = (torch.tensor(_f64(a)).to(getattr(torch, tile)) for a in (V, T))
        return ((apply_factors_pallas(V, T, jnp.asarray(C), 0, interpret=True, precision=jp),),
                (apply_factors(Vt, Tt, torch.from_numpy(C), 0, precision=tp),))
    A = rng.standard_normal((128, 64)).astype(np.float32)
    return ((jax_blocked(jnp.asarray(A), tile=32, schedule=fn, precision=jp),),
            (ggr_triangularize_blocked(torch.from_numpy(A), tile=32, schedule=fn,
                                       precision=tp),))


@pytest.mark.parametrize("fn", FUNCS)
@pytest.mark.parametrize("tile", TILES)
def test_plain_versions_equal_the_jax_kernels_bitwise(tile, fn):
    """Each output of B1-B4's plain versions and of the blocked driver at
    (tile, f64 sums) has the JAX package's bits, at the tile dtype."""
    ref, got = _run(fn, tile, np.random.default_rng(FUNCS.index(fn)))
    for r, g in zip(ref, got):
        assert g.dtype == getattr(torch, tile)
        assert str(r.dtype) == tile
        diff = int((_f64(r) != _f64(g)).sum())
        assert diff == 0, f"{diff} of {g.numel()} entries differ"


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_to_tile_rounds_once(sign):
    """1 + 2^-11 + 2^-40 lies just above the tie between 1 and 1 + 2^-10:
    once rounded it is 1 + 2^-10; through float32 (``Tensor.to``) the tie
    rounds to even, 1.  Every other pair is ``Tensor.to``."""
    x = torch.tensor([sign * (1 + 2.0 ** -11 + 2.0 ** -40)], dtype=torch.float64)
    assert to_tile(x, torch.float16).item() == sign * (1 + 2.0 ** -10)
    assert x.to(torch.float16).item() == sign * 1.0
    for dt in (torch.bfloat16, torch.float32, "float16"):
        want = x.to(getattr(torch, dt) if isinstance(dt, str) else dt)
        got = to_tile(x, dt)
        assert got.dtype == want.dtype
        if dt != "float16":
            assert torch.equal(got, want)
    f32 = torch.tensor([1 + 2.0 ** -11 + 2.0 ** -20], dtype=torch.float32)
    assert torch.equal(to_tile(f32, torch.float16), f32.to(torch.float16))


@pytest.mark.parametrize("scale", [1.0, 1e-6, 3e4])
def test_to_tile_equals_numpy_on_seeded_values(scale):
    """On 1e6 normal values (f16 subnormals at 1e-6, overflow at 3e4) and
    the special values, ``to_tile`` has numpy's ``astype(float16)`` bits."""
    rng = np.random.default_rng(int(scale * 7) + 1)
    v = np.concatenate([rng.standard_normal(10 ** 6) * scale,
                        [0.0, -0.0, np.inf, -np.inf, np.nan, 65520.0, 65519.99, 1e300,
                         2.0 ** -25, 2.0 ** -25 + 2.0 ** -70, 1e-320]])
    with np.errstate(over="ignore"):
        want = v.astype(np.float16).view(np.int16)
    got = to_tile(torch.from_numpy(v), torch.float16).view(torch.int16).numpy()
    assert np.array_equal(got, want), int((got != want).sum())


def test_row_parallel_gradient_comes_back_with_its_sequence_whole():
    """``mesh_ops.reduced_like`` reduce-scatters a row-parallel product's
    partial sums into a sequence-split stream; its backward hands the
    product the gradient with the sequence whole (the all-gather), since
    the product's backward flattens (batch, sequence) into rows, which
    torch 2.11's ``DTensor`` refuses on a split sequence."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.models import mesh_ops

    with dryrun.fake_mesh((2, 2), ("data", "model")) as mesh:
        y0 = torch.empty((2, 8, 4), device="meta", requires_grad=True)
        y = DTensor.from_local(y0, mesh, [Shard(0), Partial()], run_check=False)
        like = DTensor.from_local(torch.empty((2, 4, 4), device="meta"), mesh,
                                  [Shard(0), Shard(1)], run_check=False)
        z = mesh_ops.reduced_like(y, like)
        assert tuple(z.placements) == (Shard(0), Shard(1))
        (g,) = torch.autograd.grad(z, y, grad_outputs=torch.ones_like(z))
    assert tuple(g.placements) == (Shard(0), Replicate())


def rank_decode() -> dict:
    """Each of ``DECODE_ARCHS`` at smoke size and f32, batch 1, decoded for
    ``STEPS`` tokens on this rank's block of a 2x1 mesh whose KV cache is
    split along its sequence (dim 2 of a (L, B, S, ...) leaf) over the data
    axis (``cache_pspec``); rank 0's split leaves, logits a step and final
    caches, whole."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import mesh_ops, serve, transformer
    from repro_torch.parallel import MeshRules, cache_pspec, placements
    from repro_torch.testing.lm_check import no_drop_f32
    from repro_torch.train.trainer import _block, shard_tree

    torch.set_num_threads(1)
    mesh = make_debug_mesh(2, 1, device_type="cpu")
    rules = MeshRules(mesh)
    out = {}
    for arch in DECODE_ARCHS:
        cfg = no_drop_f32(get_config(arch, smoke=True))
        params = shard_tree(transformer.init_lm(cfg, torch.Generator().manual_seed(3)),
                            cfg, rules)
        spec = cache_pspec(cfg, rules, 1)
        cache = {name: _block(x, mesh, placements(spec(name, x), mesh))
                 for name, x in serve.init_cache(cfg, 1, CACHE_LEN, device="cpu").items()}
        split = [name for name, x in cache.items() if Shard(2) in x.placements]
        logits = []
        with torch.no_grad(), implicit_replication():
            for i, tok in enumerate(_tokens(cfg)):
                token = _block(tok, mesh, placements(spec("token", tok), mesh))
                lg, cache = serve.decode_step(params, cache, token, torch.tensor(i), cfg)
                logits.append(mesh_ops.whole(lg))
        out[arch] = (split, logits, {k: mesh_ops.whole(v) for k, v in cache.items()})
    return out if dist.get_rank() == 0 else {}


def _tokens(cfg):
    g = torch.Generator().manual_seed(11)
    return [torch.randint(0, cfg.vocab, (1,), generator=g) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def mesh_decode():
    from repro_torch.testing.spawn import spawn_ranks

    return spawn_ranks(rank_decode, 2)[0]


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_on_a_sequence_split_cache_matches_one_device(mesh_decode, arch):
    """The KV cache's sequence is split over the data axis (batch 1 does not
    divide it), every decode write lands in one rank's block, and each
    step's logits and the final caches are within 1e-4 of their rms of one
    device's."""
    from repro_torch.models import serve, transformer
    from repro_torch.testing.lm_check import no_drop_f32

    split, logits, caches = mesh_decode[arch]
    assert split and {"k", "v"} <= set(split), split
    cfg = no_drop_f32(get_config(arch, smoke=True))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run
    try:
        params = transformer.init_lm(cfg, torch.Generator().manual_seed(3))
        cache = serve.init_cache(cfg, 1, CACHE_LEN, device="cpu")
        with torch.no_grad():
            for i, (tok, got) in enumerate(zip(_tokens(cfg), logits)):
                want, cache = serve.decode_step(params, cache, tok, torch.tensor(i), cfg)
                gap = float((got - want).abs().max() / want.pow(2).mean().sqrt())
                assert gap <= GAP, (i, gap)
    finally:
        torch.set_num_threads(threads)
    for name, want in cache.items():
        got = caches[name]
        rms = float(want.double().pow(2).mean().sqrt())
        assert float((got - want).abs().max()) <= GAP * max(rms, 1e-30), name
    for name in split:  # every slot written lies in the cache
        assert caches[name][:, :, :STEPS].abs().amax() > 0


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mixtral-8x22b", "xlstm-125m"])
def test_long_500k_cells_run_on_the_fake_mesh(arch):
    """The long_500k decode cells (batch 1: the cache's sequence goes over
    the data axes) run through on the fake 16x16 mesh at published widths,
    one unit deep: local FLOPs and collective bytes on each of 256 chips."""
    from repro_torch.configs import cell_is_runnable

    assert cell_is_runnable(arch, "long_500k")[0]
    cfg = dryrun.with_depth(get_config(arch), 1)
    res = dryrun.analyze(*dryrun.lower_cell(arch, "long_500k", False, cfg_override=cfg))
    pd = res["per_device"]
    assert res["chips"] == 256 and pd["hlo_flops"] > 0 and pd["collective_bytes"] > 0
