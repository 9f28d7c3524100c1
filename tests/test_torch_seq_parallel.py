"""Sequence parallelism (``models.blocks.constrain_act``) and the dry run
held against a real mesh.

One group of 4 spawned gloo ranks (``repro_torch.testing.spawn``) on a 2x2
mesh of the host runs, at smoke widths and float32 compute: one train step
of each case under the dry run's ``LocalWork`` (its collectives recorded
as ``lower_cell`` records them on a fake 2x2 mesh), and a ``Trainer`` step
with sequence parallelism, held by the mesh tests' rule (every leaf's
update within 1e-4 of its rms over the elements the step determines, every
state leaf within 1e-4) against the one-device step.  The 16x16 comparison
runs on the fake production mesh in this process."""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models.config import ShapeConfig
from repro_torch.testing.mesh_check import UniformBatches, flat_global, split_state

ARCH = "olmo-1b"
LR, SEQ, BATCH = 1e-3, 32, 16
GAP = 1e-4
MESH = ((2, 2), ("data", "model"))
SHAPE = ShapeConfig("smoke_train", SEQ, BATCH, "train")
# (optimizer, sequence parallel): the step's collectives, fake against real
CASES = [("adamw", False), ("orthant", False), ("adamw", True)]
SP_OPTS = ("adamw", "orthant")


def case_id(case) -> str:
    return f"{case[0]}{'-sp' if case[1] else ''}"


def smoke():
    from repro_torch.testing.lm_check import no_drop_f32

    return no_drop_f32(get_config(ARCH, smoke=True))


def with_sp(cfg):
    return cfg.scaled(act_dp_axes=("data",), act_sp_axis="model")


def rank_main() -> dict:
    """Every case on this rank of the 2x2 group; rank 0's results."""
    import torch.distributed as dist

    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer
    from repro_torch.optim import make_optimizer
    from repro_torch.parallel import MeshRules, batch_spec, placements
    from repro_torch.train import Trainer
    from repro_torch.train.trainer import _block, shard_tree

    torch.set_num_threads(1)
    mesh = make_debug_mesh(*MESH[0], device_type="cpu")
    out = {"collectives": {}, "sp": {}, "local_bytes": {}}
    for case in CASES:
        opt, sp = case
        cfg = with_sp(smoke()) if sp else smoke()
        rules = MeshRules(mesh, sequence_parallel=sp)
        params = shard_tree(transformer.init_lm(cfg, torch.Generator().manual_seed(3)),
                            cfg, rules)
        state = shard_tree(make_optimizer(opt)[0](params), cfg, rules)
        batch = UniformBatches(cfg.vocab, SEQ, BATCH).batch_at(0, device="cpu")
        place = placements(batch_spec("tokens", rules), mesh)
        batch = {k: _block(v, mesh, place) for k, v in batch.items()}
        with dryrun.LocalWork() as work:
            dryrun.run_step(cfg, SHAPE, rules, opt, (params, state, batch))
        out["collectives"][case_id(case)] = dryrun.collective_bytes(work.records)
    for opt in SP_OPTS:
        tr = Trainer(with_sp(smoke()), mesh=mesh, optimizer=opt, seq_len=SEQ,
                     global_batch=BATCH, lr=LR, device="cpu")
        out["local_bytes"][opt] = {"params": specs.local_nbytes(tr.params),
                                   "opt": specs.local_nbytes(tr.opt_state)}
        tr.data = UniformBatches(tr.cfg.vocab, SEQ, BATCH)
        losses = tr.run(1, log_fn=lambda *_: None)
        out["sp"][opt] = (losses, flat_global({"params": tr.params, "opt": tr.opt_state}))
    return out if dist.get_rank() == 0 else {}


@pytest.fixture(scope="module")
def real():
    from repro_torch.testing.spawn import spawn_ranks

    return spawn_ranks(rank_main, 4)[0]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_fake_mesh_records_the_real_meshs_collectives(real, case):
    """One train step on the fake 2x2 mesh (meta tensors) records the
    collectives of the same step on 4 real gloo ranks: the same kinds, the
    same count and the same result bytes, exactly."""
    opt, sp = case
    *_, record = dryrun.lower_cell(ARCH, SHAPE, False, optimizer=opt, seq_parallel=sp,
                                   cfg_override=smoke(), mesh_shape=MESH)
    assert record.collectives == real["collectives"][case_id(case)]
    assert record.collectives["count"] > 0


@pytest.mark.parametrize("opt", SP_OPTS)
def test_specs_lay_out_a_real_meshs_bytes(real, opt):
    """``launch.specs``' parameter and optimizer-state trees on a fake 2x2
    mesh hold exactly the bytes rank 0 of a real 2x2 ``Trainer`` holds
    (``chip_smoke.py`` phase 15 (c) holds olmo-1b at full width so)."""
    from repro_torch.launch import specs
    from repro_torch.optim import make_optimizer
    from repro_torch.parallel import MeshRules

    cfg = with_sp(smoke())
    with dryrun.fake_mesh(*MESH) as mesh:
        rules = MeshRules(mesh)
        p = specs.param_specs(cfg, rules)
        o = specs.opt_specs(p, cfg, rules, make_optimizer(opt)[0])
        laid = {"params": specs.local_nbytes(p), "opt": specs.local_nbytes(o)}
    assert laid == real["local_bytes"][opt]


@pytest.mark.parametrize("opt", SP_OPTS)
def test_seq_parallel_step_matches_one_device(real, opt):
    """A ``Trainer`` step with sequence parallelism on 2x2 within 1e-4 of
    each leaf's rms (update and state) of the one-device step."""
    from repro_torch.testing.step_check import step_gaps
    from repro_torch.train import Trainer

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run: the plain versions' small ops
    try:
        tr = Trainer(smoke(), optimizer=opt, seq_len=SEQ, global_batch=BATCH, lr=LR,
                     device="cpu")
        tr.data = UniformBatches(tr.cfg.vocab, SEQ, BATCH)
        p0 = flat_global(tr.params)
        want_loss = tr.run(1, log_fn=lambda *_: None)
        want = flat_global({"params": tr.params, "opt": tr.opt_state})
    finally:
        torch.set_num_threads(threads)
    losses, got = real["sp"][opt]
    r = step_gaps(p0, split_state(got), split_state(want), LR, opt)
    assert abs(losses[0] - want_loss[0]) <= 1e-5 * abs(want_loss[0]), (losses, want_loss)
    assert r["update"][1] <= GAP and r["state"][1] <= GAP and r["steps"] == (1, 1), r


def test_seq_parallel_trades_all_reduce_on_the_production_mesh():
    """olmo-1b's train_4k cell at its published widths, 2 layers deep, on the
    fake 16x16 mesh: with ``--seq-parallel`` it reads fewer all-reduce bytes
    than without, and nonzero reduce-scatter and all-gather bytes; the same
    FLOPs within 1e-6 relative or fewer (norms and elementwise ops on 1/16 of
    the tokens count no FLOPs)."""
    cfg = dryrun.with_depth(get_config(ARCH), 2)
    *_, plain = dryrun.lower_cell(ARCH, "train_4k", False, cfg_override=cfg)
    *_, sp = dryrun.lower_cell(ARCH, "train_4k", False, seq_parallel=True, cfg_override=cfg)
    assert sp.collectives["all-reduce"] < plain.collectives["all-reduce"]
    assert sp.collectives["reduce-scatter"] > 0 and sp.collectives["all-gather"] > 0
    assert sp.flops <= plain.flops * (1 + 1e-6)


def test_constrain_act_on_plain_tensors():
    """Without ``act_sp_axis`` a plain tensor passes through (the same
    object); with it set, a plain tensor has no mesh to be constrained on and
    raises."""
    from repro_torch.models.blocks import constrain_act

    h = torch.randn(2, 8, 4)
    assert constrain_act(h, smoke()) is h
    with pytest.raises(ValueError, match="act_sp_axis"):
        constrain_act(h, with_sp(smoke()))


def test_constrain_act_shards_the_sequence():
    """On a fake 2x2 mesh a ``DTensor`` residual stream is placed
    P("data", "model", None): batch over data, sequence over model."""
    from repro_torch.launch import specs
    from repro_torch.models.blocks import constrain_act
    from repro_torch.parallel import PartitionSpec as P

    with dryrun.fake_mesh(*MESH) as mesh:
        h = specs.meta_dtensor((BATCH, SEQ, 8), torch.float32, P("data", None, None), mesh)
        out = constrain_act(h, with_sp(smoke()))
        assert specs.spec_of(out) == P("data", "model", None)
        assert constrain_act(out, with_sp(smoke())) is out
