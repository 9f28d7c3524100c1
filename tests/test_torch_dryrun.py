"""The port's dry run (``repro_torch.launch.specs`` / ``dryrun`` / ``sweep``)
against the JAX package's ``launch/specs.py`` and ``launch/dryrun.py``.

The reference's spec trees come from one subprocess with 256 forced host
devices on a ``jax.sharding.Mesh`` of Auto axes (``jax.make_mesh``'s
Explicit axes are what fail the reference's own ``test_dryrun`` cases); the
port's are meta ``DTensor``s on a fake 16x16 process group in this
process.  Shapes, dtypes and specs are compared exactly; counts and formulas
exactly (integers) unless a test says otherwise."""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.launch import dryrun, specs
from repro_torch.models.config import SHAPES, ShapeConfig

_REPO = Path(__file__).resolve().parents[1]


def _jax_dryrun():
    """The JAX package's ``launch.dryrun``, imported without keeping the
    ``XLA_FLAGS`` it sets at import (this process's JAX is already
    initialized; later subprocesses must not inherit 512 host devices)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jax_dryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jax_dryrun


SPEC_ARCHS = ("olmo-1b", "mixtral-8x22b", "zamba2-1.2b", "xlstm-125m",
              "seamless-m4t-large-v2", "phi-3-vision-4.2b")
ZERO1_ARCH = "olmo-1b"

# the reference test's HLO sample (tests/test_dryrun.py): four collectives
# and an add
HLO_SAMPLE = """
  %all-reduce.1 = f32[16,4096,2048]{2,1,0} all-reduce(%fusion.1), channel_id=1
  %all-gather.2 = bf16[512,1024]{1,0} all-gather(%param.1), channel_id=2
  %reduce-scatter.3 = f32[128]{0} reduce-scatter(%fusion.2), channel_id=3
  %add.1 = f32[4]{0} add(%a, %b)
  %collective-permute.4 = f32[2,2]{1,0} collective-permute(%x), channel_id=4
"""

_REFERENCE = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.launch import specs as S
from repro.models.config import SHAPES
from repro.optim import make_optimizer
from repro.parallel import MeshRules

archs, zero1_arch = sys.argv[1].split(","), sys.argv[2]
mesh = Mesh(np.array(jax.devices()).reshape(16, 16), ("data", "model"))
rules = MeshRules(mesh)


def key(k):
    for a in ("key", "name", "idx"):
        if hasattr(k, a):
            v = getattr(k, a)
            return f".{v}" if a == "name" else str(v)
    raise TypeError(k)


def flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for path, s in leaves:
        spec = [list(e) if isinstance(e, tuple) else e for e in s.sharding.spec]
        out["/".join(key(k) for k in path)] = [list(s.shape), str(s.dtype), spec]
    return out


res = {}
for arch in archs:
    cfg = get_config(arch)
    p = S.param_specs(cfg, rules)
    cache, token, pos = S.decode_specs(cfg, SHAPES["decode_32k"], rules)
    res[arch] = {
        "params": flat(p),
        "opt": flat(S.opt_specs(p, cfg, rules, make_optimizer("adamw")[0])),
        "train": flat(S.batch_specs(cfg, SHAPES["train_4k"], rules)),
        "prefill": flat(S.batch_specs(cfg, SHAPES["prefill_32k"], rules)),
        "decode": flat({"cache": cache, "token": token, "pos": pos}),
    }
    if arch == zero1_arch:
        res[arch]["opt_zero1"] = flat(S.opt_specs(p, cfg, rules, make_optimizer("adamw")[0],
                                                  zero1=True))
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def reference_trees():
    env = dict(os.environ, PYTHONPATH=str(_REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=256")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                           ",".join(SPEC_ARCHS), ZERO1_ARCH],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _norm(spec) -> list:
    """A spec's entries as JSON gives them (tuples as lists), trailing
    whole dimensions dropped."""
    out = [list(e) if isinstance(e, tuple) else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return out


def _flat(tree) -> dict:
    from repro_torch.checkpoint.ckpt import _walk

    return {"/".join(p): [list(x.shape), str(x.dtype).removeprefix("torch."),
                          _norm(specs.spec_of(x))] for p, x in _walk(tree)}


@pytest.fixture(scope="module")
def port_trees():
    from repro_torch.optim import make_optimizer
    from repro_torch.parallel import MeshRules

    res = {}
    with dryrun.fake_mesh((16, 16), ("data", "model")) as mesh:
        rules = MeshRules(mesh)
        for arch in SPEC_ARCHS:
            cfg = get_config(arch)
            p = specs.param_specs(cfg, rules)
            cache, token, pos = specs.decode_specs(cfg, SHAPES["decode_32k"], rules)
            init = make_optimizer("adamw")[0]
            res[arch] = {
                "params": _flat(p),
                "opt": _flat(specs.opt_specs(p, cfg, rules, init)),
                "train": _flat(specs.batch_specs(cfg, SHAPES["train_4k"], rules)),
                "prefill": _flat(specs.batch_specs(cfg, SHAPES["prefill_32k"], rules)),
                "decode": _flat({"cache": cache, "token": token, "pos": pos}),
            }
            if arch == ZERO1_ARCH:
                res[arch]["opt_zero1"] = _flat(specs.opt_specs(p, cfg, rules, init, zero1=True))
    return res


def _ref_norm(tree: dict) -> dict:
    return {k: [shape, dtype, _norm(spec)] for k, (shape, dtype, spec) in tree.items()}


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_spec_trees_match_the_reference(reference_trees, port_trees, arch):
    """Params, AdamW state, the train and prefill batches and the decode
    (cache, token, pos) of each arch on 16x16: every leaf's global shape,
    dtype and spec (placements mapped back to a ``PartitionSpec``) exactly
    the reference's ``ShapeDtypeStruct``."""
    for part in ("params", "opt", "train", "prefill", "decode"):
        assert port_trees[arch][part] == _ref_norm(reference_trees[arch][part]), (arch, part)


def test_zero1_moments_match_the_reference(reference_trees, port_trees):
    """``opt_specs(zero1=True)``: each moment gains the data axis on its first
    free divisible dimension, exactly as the reference's."""
    got = port_trees[ZERO1_ARCH]["opt_zero1"]
    assert got == _ref_norm(reference_trees[ZERO1_ARCH]["opt_zero1"])
    assert got[".m/embed"][2] == ["model", "data"]
    assert got != port_trees[ZERO1_ARCH]["opt"]


@pytest.mark.parametrize("arch", list_archs())
def test_depth_helpers_match_the_reference(arch):
    """``depth_units`` and ``with_depth`` give the reference's depths (and
    round-trip) for all ten archs."""
    from repro.configs import get_config as jax_get_config

    jax_depth_units, jax_with_depth = _jax_dryrun().depth_units, _jax_dryrun().with_depth
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    L = dryrun.depth_units(cfg)
    assert L == jax_depth_units(jcfg) >= 1
    for units in (1, 2, L):
        got, want = dryrun.with_depth(cfg, units), jax_with_depth(jcfg, units)
        assert dryrun.depth_units(got) == units
        assert ((got.n_layers, got.enc_layers, got.dec_layers)
                == (want.n_layers, want.enc_layers, want.dec_layers))
    assert dryrun.with_depth(dryrun.with_depth(cfg, 2), L).n_layers == cfg.n_layers


def _record(flops=1.0, nbytes=1.0, coll=None):
    return dryrun.StepRecord(seconds=0.0, flops=flops, bytes=nbytes,
                             collectives=coll or dryrun.collective_bytes([]), kernels={},
                             argument_bytes=0, output_bytes=0)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_params_and_model_flops_match_the_reference(arch, shape):
    """``params``, ``active_params`` and ``model_flops_global`` of every
    (arch, shape): the reference's formulas on its own config, exactly."""
    from repro.configs import get_config as jax_get_config

    from repro_torch.parallel import MeshShape

    jcfg, sh = jax_get_config(arch), SHAPES[shape]
    n = jcfg.active_param_count()
    want = {"train": 6 * n * sh.global_batch * sh.seq_len,
            "prefill": 2 * n * sh.global_batch * sh.seq_len,
            "decode": 2 * n * sh.global_batch}[sh.kind]
    res = dryrun.analyze(get_config(arch), sh, MeshShape({"data": 16, "model": 16}), _record())
    assert res["params"] == jcfg.param_count()
    assert res["active_params"] == n
    assert res["model_flops_global"] == want
    assert res["chips"] == 256 and res["hlo_flops_global"] == 256.0


def test_collective_bytes_sums_the_reference_sample():
    """The sample's collectives, issued as functional collectives on meta
    tensors of a fake 16x16 mesh whose results have the sample's shapes
    (the collective-permute, which ``DTensor`` never issues, as a record of
    its kind): the same bytes by kind, count and total as the reference's
    HLO parser reads."""
    import torch.distributed._functional_collectives as fc

    want = _jax_dryrun().collective_bytes(HLO_SAMPLE)
    with dryrun.fake_mesh((16, 16), ("data", "model")) as mesh, dryrun.LocalWork() as work:
        grp = mesh.get_group("model")
        fc.all_reduce(torch.empty((16, 4096, 2048), device="meta"), "sum", grp)
        fc.all_gather_tensor(torch.empty((32, 1024), dtype=torch.bfloat16, device="meta"),
                             0, grp)
        fc.reduce_scatter_tensor(torch.empty((128 * 16,), device="meta"), "sum", 0, grp)
    got = dryrun.collective_bytes(work.records + [("collective-permute", 2 * 2 * 4)])
    assert got == want
    assert got["count"] == 4 and work.flops == 0


def test_local_flops_are_per_device_not_global():
    """A column- then row-parallel MLP on meta DTensors of a fake 16x16
    mesh (batch over data, the hidden width over model), forward and
    backward (the output's gradient split over the batch, as a loss over the
    batch rows gives it): rank 0's FLOPs equal the hand count
    2·M·K·N/(dp·tp) for each of its 6 products (2 forward, 4 backward),
    exactly; ``FlopCounterMode``
    over the same step reads the global count (256x) that the dry run must
    not report."""
    from torch.distributed.tensor import Partial, Shard
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.parallel import PartitionSpec as P

    M, K, N = 4096, 2048, 8192

    def step(mesh):
        x = specs.meta_dtensor((M, K), torch.float32, P("data", None), mesh).requires_grad_()
        w1 = specs.meta_dtensor((K, N), torch.float32, P(None, "model"), mesh).requires_grad_()
        w2 = specs.meta_dtensor((N, K), torch.float32, P("model", None), mesh).requires_grad_()
        # the output's gradient as a loss over the batch rows gives it
        grad = specs.meta_dtensor((M, K), torch.float32, P("data", None), mesh)
        ((x @ w1) @ w2).backward(grad)
        # the data-parallel sum of the weights' gradients is left partial
        assert w1.grad.placements == (Partial(), Shard(1))

    with dryrun.fake_mesh((16, 16), ("data", "model")) as mesh:
        with dryrun.LocalWork() as work:
            step(mesh)
        with FlopCounterMode(display=False) as fcm:
            step(mesh)
    assert work.flops == 6 * 2 * M * K * N // 256
    assert fcm.get_total_flops() == 256 * work.flops


def test_one_real_cell_subprocess(tmp_path):
    """xlstm decode_32k, the reference's cheapest real cell, through the
    port's CLI with the depth probe: 256 chips, a dominant term, local FLOPs
    and the corrected roofline; every loop iteration is counted, so the
    probe's extrapolation reads the full step's FLOPs within 1e-9
    relative."""
    out = tmp_path / "cell.json"
    env = dict(os.environ, PYTHONPATH=str(_REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "xlstm-125m",
         "--shape", "decode_32k", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    cell = json.loads(out.read_text())
    assert cell["chips"] == 256 and cell["mesh"] == [16, 16]
    assert cell["roofline_seconds"]["dominant"] in ("compute", "memory", "collective")
    assert cell["per_device"]["hlo_flops"] > 0
    assert "roofline_seconds_corrected" in cell
    corrected = cell["depth_probe"]["corrected_per_device"]["hlo_flops"]
    assert math.isclose(corrected, cell["per_device"]["hlo_flops"], rel_tol=1e-9)
    assert cell["memory_analysis"]["temp_size_bytes"] is None
    assert set(cell["memory_analysis"]["null_reasons"]) == {"temp_size_bytes",
                                                           "generated_code_size_bytes"}


def smoke16():
    """olmo-1b at smoke widths with 16 heads: the production mesh's 16-wide
    model axis splits whole heads (``DTensor`` cannot view a gradient split
    finer than the heads back into them)."""
    return get_config("olmo-1b", smoke=True).scaled(n_heads=16, n_kv_heads=16)


def test_multipod_smoke_train_cell():
    """A smoke-width train step of xlstm-125m (one unit deep; the
    reference's multi-pod test cell is xlstm-125m's) on the fake 2x16x16
    mesh: 512 chips and bytes across the mesh; the group is gone after it,
    so the next cell forms its own (here: 16x16, 256 chips)."""
    import torch.distributed as dist

    cfg = dryrun.with_depth(get_config("xlstm-125m", smoke=True), 1)
    shape = ShapeConfig("smoke_train", 16, 32, "train")
    res = dryrun.analyze(*dryrun.lower_cell("xlstm-125m", shape, True, cfg_override=cfg))
    assert res["chips"] == 512 and res["mesh"] == [2, 16, 16]
    assert res["per_device"]["collective_bytes"] > 0 and res["per_device"]["hlo_flops"] > 0
    assert not dist.is_initialized()
    res = dryrun.analyze(*dryrun.lower_cell("xlstm-125m", shape, False, cfg_override=cfg))
    assert res["chips"] == 256


def test_the_group_is_destroyed_on_error():
    """A step that raises leaves no process group behind."""
    import torch.distributed as dist

    with pytest.raises(KeyError):
        dryrun.lower_cell("olmo-1b", ShapeConfig("bad", 64, 64, "train"), False,
                          optimizer="nonsense", cfg_override=get_config("olmo-1b", smoke=True))
    assert not dist.is_initialized()


def test_zero1_shards_the_moments_of_a_step():
    """``--zero1``: the step's optimizer state takes 1/16 of its bytes on
    rank 0 (the data axis), params and batch as before; the same FLOPs."""
    cfg = smoke16()
    shape = ShapeConfig("smoke_train", 64, 64, "train")
    *_, plain = dryrun.lower_cell("olmo-1b", shape, False, cfg_override=cfg)
    *_, z1 = dryrun.lower_cell("olmo-1b", shape, False, cfg_override=cfg, zero1=True)
    assert z1.argument_bytes < plain.argument_bytes
    assert z1.flops == plain.flops


def test_olmo_train_cell_reads_within_the_hand_count():
    """olmo-1b's train_4k cell at full depth and width on 16x16: the
    useful-FLOPs ratio within ``dryrun_check.useful_band`` (the model FLOPs
    over the hand count at most, 0.8 of that at least), the reference's
    result keys all present."""
    from repro_torch.testing.dryrun_check import missing_keys, useful_band

    res = dryrun.analyze(*dryrun.lower_cell("olmo-1b", "train_4k", False))
    res.update(multi_pod=False, optimizer="adamw", seq_parallel=False, unrolled_scans=False)
    lo, hi = useful_band(get_config("olmo-1b"), SHAPES["train_4k"])
    assert lo <= res["useful_flops_ratio"] <= hi, (lo, res["useful_flops_ratio"], hi)
    assert missing_keys(res, probed=False) == []


def test_orthant_step_counts_b3_b4_without_launching():
    """``--optimizer orthant`` on meta tensors (smoke widths, 16x16): B3 and
    B4 tallied by shape into ``per_device.kernels`` and their operations
    into the FLOPs; no kernel launched."""
    from repro_torch.kernels import ggr_apply, ggr_panel

    before = (ggr_panel.panel_factor.launches, ggr_apply.apply_factors.launches)
    shape = ShapeConfig("smoke_train", 64, 64, "train")
    *_, adamw = dryrun.lower_cell("olmo-1b", shape, False, cfg_override=smoke16())
    cfg, sh, mesh, rec = dryrun.lower_cell("olmo-1b", shape, False, optimizer="orthant",
                                           cfg_override=smoke16())
    ks = dryrun.analyze(cfg, sh, mesh, rec)["per_device"]["kernels"]
    assert ks["panel_factor"]["tpu_kernel"] == "B3" and ks["apply_factors"]["tpu_kernel"] == "B4"
    assert ks["panel_factor"]["launches"] > 0 and ks["apply_factors"]["launches"] > 0
    assert rec.flops > adamw.flops
    assert (ggr_panel.panel_factor.launches, ggr_apply.apply_factors.launches) == before


def test_refused_cell_writes_skipped(tmp_path):
    """A cell ``cell_is_runnable`` refuses: ``{"skipped": why}``, exit 0."""
    out = tmp_path / "skip.json"
    assert dryrun.main(["--arch", "olmo-1b", "--shape", "long_500k", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert "skipped" in res and res["arch"] == "olmo-1b"


# the kernel table's shapes (PERF.md §6) and the operation counts
# chip_smoke.py's own copies of the models gave there before they moved to
# core/counts.py
TABLE_FLOPS = {
    ("batched_update", (8192, 40, 33), 32): 217841664.0,
    ("batched_update", (8192, 104, 65), 64): 3682074624.0,
    ("batched_update", (64, 128, 192), 64): 215109632.0,
    ("batched_update", (32, 128, 192), 64): 107554816.0,
    ("batched_update", (1, 128, 192), 64): 3361088.0,
    ("batched_geqrt", (128, 64, 128), 64): 144019456.0,
    ("batched_geqrt", (64, 64, 128), 64): 72009728.0,
    ("batched_geqrt", (2, 64, 128), 64): 2250304.0,
    ("panel_factor", (1, 4096, 64), 0): 43162400.0,
    ("panel_factor", (1, 8192, 64), 0): 86547232.0,
    ("panel_factor", (1, 4096, 32), 1024): 8376720.0,
    ("panel_factor", (1, 65536, 64), 0): 693934880.0,
    ("apply_factors", (1, 4096, 4032), (64, 0)): 5246261504.0,
    ("apply_factors", (1, 8192, 964), (64, 0)): 2521529216.0,
    ("apply_factors", (1, 4096, 2048), (32, 2048)): 666529920.0,
    ("apply_factors", (1, 65536, 128), (64, 0)): 2716602624.0,
}


@pytest.mark.parametrize("case", list(TABLE_FLOPS), ids=lambda c: f"{c[0]}-{c[1]}")
def test_kernel_models_keep_the_tables_counts(case):
    """The moved closed forms give the counts the table's bounds were
    computed from, exactly."""
    from repro_torch.core import counts

    name, shape, param = case
    fn = {"batched_update": counts.update_flops, "batched_geqrt": counts.geqrt_flops,
          "panel_factor": counts.panel_flops, "apply_factors": counts.apply_flops}[name]
    args = param if isinstance(param, tuple) else (param,)
    assert fn(shape, *args) == TABLE_FLOPS[case]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_meta_branches_count_without_launching(dtype):
    """B3/B4 on meta tensors: the plain versions' output shapes and dtypes
    (held at a small shape on the CPU), the table's operation counts at its
    shapes and one tallied launch a call (B4: one a 128 transforms); the
    kernels' ``launches`` and ``shapes`` records unchanged."""
    from repro_torch.core import counts
    from repro_torch.kernels import ggr_apply, ggr_panel

    before = (ggr_panel.panel_factor.launches, ggr_apply.apply_factors.launches,
              set(ggr_panel.panel_factor.shapes), set(ggr_apply.apply_factors.shapes))
    x = torch.randn((2, 40, 8), dtype=dtype)
    c = torch.randn((2, 40, 12), dtype=dtype)
    R, V, T = ggr_panel.panel_factor(x)
    want = [(o.shape, o.dtype) for o in (R, V, T, ggr_apply.apply_factors(V, T, c))]
    with counts.kernel_tally() as tally:
        mR, mV, mT = ggr_panel.panel_factor(x.to("meta"))
        mC = ggr_apply.apply_factors(mV, mT, c.to("meta"))
        ggr_panel.panel_factor(torch.empty((1, 4096, 64), dtype=dtype, device="meta"))
        ggr_apply.apply_factors(*(torch.empty((1, 4096, 64), dtype=dtype, device="meta"),) * 2,
                                torch.empty((1, 4096, 4032), dtype=dtype, device="meta"))
        ggr_apply.apply_factors(*(torch.empty((1, 300, 200), dtype=dtype, device="meta"),) * 2,
                                torch.empty((1, 300, 8), dtype=dtype, device="meta"))
    assert [(o.shape, o.dtype) for o in (mR, mV, mT, mC)] == want
    assert all(o.device.type == "meta" for o in (mR, mV, mT, mC))
    assert tally["panel_factor"] == {
        "launches": 2, "flops": counts.panel_flops((2, 40, 8), 0) + 43162400.0}
    assert tally["apply_factors"] == {
        "launches": 1 + 1 + 2,
        "flops": (counts.apply_flops((2, 40, 12), 8, 0) + 5246261504.0
                  + counts.apply_flops((1, 300, 8), 200, 0))}
    after = (ggr_panel.panel_factor.launches, ggr_apply.apply_factors.launches,
             set(ggr_panel.panel_factor.shapes), set(ggr_apply.apply_factors.shapes))
    assert after == before


def test_fused_driver_runs_on_meta_tensors():
    """``ggr_triangularize_blocked(schedule="fused")`` on a meta batch: a
    meta result of the input's shape, one B3 launch a panel and one B4
    launch a panel with trailing columns (as the card's count)."""
    from repro_torch.core import counts
    from repro_torch.core.blocked import ggr_triangularize_blocked

    X = torch.empty((3, 300, 130), device="meta")
    with counts.kernel_tally() as tally:
        out = ggr_triangularize_blocked(X, 129, schedule="fused")
    assert out.shape == X.shape and out.device.type == "meta"
    # tile 64 over 129 pivots: 3 panels after padding them to 192, each with
    # trailing columns (the padded pivots' zeros and the last column)
    assert tally["panel_factor"]["launches"] == 3
    assert tally["apply_factors"]["launches"] == 3
    assert tally["panel_factor"]["flops"] > 0


def test_run_cell_caches_and_records_errors(tmp_path, monkeypatch):
    """``sweep.run_cell``: a cell runs in a subprocess once, then comes back
    from its file; a failing cell (an optimizer the CLI refuses) writes
    ``{"error": ...}``."""
    from repro_torch.launch import sweep

    monkeypatch.setattr(sweep, "RESULTS_DIR", str(tmp_path))
    res, cached = sweep.run_cell("xlstm-125m", "decode_32k", False, probe=False, timeout=600)
    assert not cached and res["chips"] == 256, res
    again, cached = sweep.run_cell("xlstm-125m", "decode_32k", False, probe=False)
    assert cached and again == res
    bad, cached = sweep.run_cell("olmo-1b", "decode_32k", False, probe=False, timeout=600,
                                 extra=("--optimizer", "nonsense"))
    assert not cached and "error" in bad
    assert json.loads(Path(sweep.cell_path("olmo-1b", "decode_32k", False)).read_text()) == bad
    assert Path(sweep.cell_path("olmo-1b", "decode_32k", True)).name == \
        "olmo-1b__decode_32k__pod2.json"
