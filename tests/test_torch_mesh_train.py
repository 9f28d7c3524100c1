"""The port's ``Trainer(mesh=...)`` on gloo ranks of the host against its
one-device ``Trainer`` and the JAX package's mesh ``Trainer``.

One group of 4 spawned ranks (``repro_torch.testing.spawn``) runs every
case in turn on 2x2, 1x4 and 4x1 meshes (``launch.mesh.make_debug_mesh``),
then a group of 2 resumes a 2x2 snapshot on 1x2; meanwhile the reference
trains on a 2x2 Auto mesh of host devices in a subprocess, and the CLI runs
a 2x2 mesh of its own.  Each case is held by ``testing.step_check``: every
leaf's update within 1e-4 of its rms over the elements the step determines,
every state leaf within 1e-4 over every element.  Smoke-size configs at
float32 compute, as the one-device parity tests."""
import dataclasses
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.testing.mesh_check import (UniformBatches, block_digests, flat_global,
                                            held_per_step, replicas_differ, split_state)

_REPO = Path(__file__).resolve().parents[1]
WORLD = 4
# 512 uniform tokens a step (``UniformBatches``): a weight's one-step
# gradient then has full rank at the smoke widths but for LayerNorm's null
# vector (``step_check.leading_columns``), an MoE expert's too (it sees about
# 256 tokens); the Trainer's own stream (a slow random walk) leaves it
# rank-deficient, with directions that roundoff sets
LR, SEQ, BATCH = 1e-3, 32, 16
GAP = 1e-4
MESHES = ((2, 2), (1, 4), (4, 1))
# one arch of each family the Trainer trains (encdec needs frames the
# Trainer's stream does not draw: its step runs through make_train_step)
FAMILIES = ("olmo-1b", "mixtral-8x22b", "phi-3-vision-4.2b", "zamba2-1.2b", "xlstm-125m")
ORTHANT = ("olmo-1b", "mixtral-8x22b")
CASES = ([(m, a, "adamw") for m in MESHES for a in FAMILIES]
         + [(m, a, "orthant") for m in MESHES for a in ORTHANT])
ENCDEC = "seamless-m4t-large-v2"
ELASTIC = "adamw"  # the optimizer of the elastic-resume runs


def case_id(case) -> str:
    (d, m), arch, opt = case
    return f"{d}x{m}-{arch}-{opt}"


def smoke(arch: str):
    from repro_torch.configs import get_config
    from repro_torch.testing.lm_check import no_drop_f32

    return no_drop_f32(get_config(arch, smoke=True))


def uniform(vocab: int) -> UniformBatches:
    return UniformBatches(vocab, SEQ, BATCH)


def _train(mesh, arch, opt, steps, keep_at=(), **kw):
    """A mesh Trainer run ``steps`` steps on ``UniformBatches``: (trainer,
    losses, the replicas' digests after each step, {step: global arrays}
    after each step of ``keep_at``)."""
    from repro_torch.train import Trainer

    tr = Trainer(smoke(arch), mesh=mesh, optimizer=opt, seq_len=SEQ, global_batch=BATCH,
                 lr=LR, device="cpu", **kw)
    tr.data = uniform(tr.cfg.vocab)
    seen, losses, states = [], [], {}
    while tr.step_num < steps:
        losses += tr.run(tr.step_num + 1, log_fn=lambda *_: None)
        seen.append(block_digests({"params": tr.params, "opt": tr.opt_state}))
        if tr.step_num in keep_at:
            states[tr.step_num] = flat_global({"params": tr.params, "opt": tr.opt_state})
    return tr, losses, seen, states


class ArrayBatches:
    """Batches read from the reference's dump, as the Trainer's ``data``."""

    def __init__(self, arrays: dict):
        self.arrays = arrays

    def batch_at(self, step, device="cuda"):
        return {k: torch.as_tensor(self.arrays[f"{k}{step}"]).to(device)
                for k in ("tokens", "labels")}

    def state(self, step):
        return {"seed": 0, "step": int(step)}


def _wait_for(path: Path, timeout_s: float = 900.0) -> None:
    import time

    t0 = time.time()
    while not path.exists():
        if time.time() - t0 > timeout_s:
            raise TimeoutError(f"no {path}")
        time.sleep(0.5)


def rank_main(work: str) -> dict:
    """Every case on this rank of the 4-rank group; rank 0 returns the
    global arrays, every rank its blocks' digests."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import encdec
    from repro_torch.parallel import MeshRules, batch_spec, placements
    from repro_torch.train import make_train_step
    from repro_torch.train.trainer import Trainer, _block, shard_tree

    torch.set_num_threads(1)
    rank = dist.get_rank()
    meshes = {s: make_debug_mesh(*s, device_type="cpu") for s in MESHES}
    out = {"cases": {}, "digests": {}}

    def keep(key, tr, losses, seen, _=None):
        state = flat_global({"params": tr.params, "opt": tr.opt_state})
        if rank == 0:
            out["cases"][key] = (losses, state)
        out["digests"][key] = seen

    for case in CASES:
        shape, arch, opt = case
        keep(case_id(case), *_train(meshes[shape], arch, opt, 1))

    # encdec: one AdamW train_step on mesh-placed params and a frames batch
    cfg = smoke(ENCDEC)
    g = torch.Generator().manual_seed(5)
    params = encdec.init_encdec(cfg, g)
    batch = {"tokens": torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=g),
             "frames": torch.randn((BATCH, SEQ // cfg.enc_downsample, cfg.d_model), generator=g)}
    batch["labels"] = torch.roll(batch["tokens"], -1, 1)
    opt_init, step = make_train_step(cfg, optimizer="adamw", lr=LR)
    for shape in MESHES:
        mesh = meshes[shape]
        rules = MeshRules(mesh)
        p = shard_tree(params, cfg, rules)
        b = {k: _block(v, mesh, placements(batch_spec("tokens" if v.ndim == 2 else "frames",
                                                      rules), mesh))
             for k, v in batch.items()}
        with implicit_replication():
            new_p, new_s, metrics = step(p, opt_init(p), b)
        state = flat_global({"params": new_p, "opt": new_s})
        if rank == 0:
            out["cases"][f"{shape[0]}x{shape[1]}-{ENCDEC}-adamw"] = ([float(metrics["loss"])],
                                                                    state)

    # elastic resume: a 2x2 run saved at step 2, resumed on 2x2 to step 4,
    # beside the uninterrupted run (1x2 and no mesh resume it later)
    ck = os.path.join(work, "ckpt")
    _train(meshes[(2, 2)], "olmo-1b", ELASTIC, 2, ckpt_dir=ck, ckpt_every=2)
    whole = _train(meshes[(2, 2)], "olmo-1b", ELASTIC, 4, keep_at=(3, 4))
    again = _train(meshes[(2, 2)], "olmo-1b", ELASTIC, 4, ckpt_dir=ck, ckpt_every=100,
                   resume=True)
    out["digests"]["elastic-whole"], out["digests"]["elastic-again"] = whole[2], again[2]
    if rank == 0:
        out["cases"]["elastic-whole"] = (whole[1], whole[3])
    keep("elastic-again", *again)

    # the reference's 2x2 Auto-mesh run: its step-0 snapshot and batches
    ref = Path(work) / "ref"
    _wait_for(ref / "done")
    with np.load(ref / "batches.npz") as f:
        arrays = {k: f[k] for k in f.files}
    tr = Trainer(dataclasses.replace(smoke("olmo-1b"), compute_dtype="float32"),
                 mesh=meshes[(2, 2)], optimizer="adamw", seq_len=SEQ, global_batch=BATCH,
                 lr=LR, device="cpu", ckpt_dir=str(ref / "ckpt"), resume=True)
    tr.data = ArrayBatches(arrays)
    assert tr.step_num == 0
    for step in (1, 2):
        keep(f"reference-2x2-{step}", tr, tr.run(step, log_fn=lambda *_: None), [])
    return out


def resume_main(work: str) -> dict:
    """The 2x2 snapshot resumed on a 1x2 mesh: the restored leaves and the
    run on to step 4."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train import Trainer

    torch.set_num_threads(1)
    mesh = make_debug_mesh(1, 2, device_type="cpu")
    tr = Trainer(smoke("olmo-1b"), mesh=mesh, optimizer=ELASTIC, seq_len=SEQ,
                 global_batch=BATCH, lr=LR, device="cpu", ckpt_dir=os.path.join(work, "ckpt"),
                 ckpt_every=100, resume=True)
    tr.data = uniform(tr.cfg.vocab)
    restored = (tr.step_num, flat_global({"params": tr.params, "opt": tr.opt_state}))
    losses, states = [], {}
    for step in (3, 4):
        losses += tr.run(step, log_fn=lambda *_: None)
        states[step] = flat_global({"params": tr.params, "opt": tr.opt_state})
    return {"restored": restored, "losses": losses, "states": states}


_REFERENCE = """
import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np

from repro.configs import get_config
from repro.train import Trainer

out = Path(sys.argv[1])
cfg = get_config("olmo-1b", smoke=True)
cfg = dataclasses.replace(cfg, compute_dtype="float32")
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
tr = Trainer(cfg, mesh=mesh, optimizer="adamw", lr=%r, seq_len=%d, global_batch=%d,
             ckpt_dir=str(out / "ckpt"), ckpt_every=1)
tr.save()
batches = {}
for s in range(2):
    for k, v in tr.data.batch_at(s).items():
        batches[f"{k}{s}"] = np.asarray(v)
np.savez(out / "batches.npz", **batches)
tr.ckpt_dir = None
for step in (1, 2):
    losses = tr.run(step, log_fn=lambda *a: None)
    flat = {}
    tree = {"params": tr.params, "opt": tr.opt_state}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = [str(p.key) if hasattr(p, "key") else f".{p.name}" if hasattr(p, "name")
               else str(p.idx) for p in path]
        flat["/".join(key)] = np.asarray(x)
    np.savez(out / f"step{step}.npz", loss=np.float64(losses[0]), **flat)
(out / "done").touch()
""" % (LR, SEQ, BATCH)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything at once: the reference subprocess, the 4-rank group then
    the 2-rank group then the CLI (in a thread), and meanwhile the
    one-device runs each case is held against, on one intra-op thread (the
    ranks take one each: the module runs beside other test workers)."""
    from repro_torch.testing.spawn import spawn_ranks

    work = tmp_path_factory.mktemp("mesh")
    (work / "ref").mkdir()
    env = dict(os.environ, PYTHONPATH=str(_REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REFERENCE), str(work / "ref")],
                           env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    got = {}

    def ranks():
        try:
            got["mesh"] = spawn_ranks(rank_main, WORLD, str(work))
            got["resume"] = spawn_ranks(resume_main, 2, str(work))
            got["cli"] = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch", "olmo-1b",
                 "--smoke", "--device", "cpu", "--mesh", "2x2", "--steps", "3", "--seq-len",
                 str(SEQ), "--global-batch", str(BATCH)],
                env={"PYTHONPATH": str(_REPO / "src"), "PATH": "/usr/bin:/bin"},
                capture_output=True, text=True, timeout=900)
        except BaseException as e:  # re-raised in the test process below
            got["error"] = e

    th = threading.Thread(target=ranks)
    th.start()
    one = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for case in CASES:
            one[case_id(case)] = one_device(case[1], case[2], 1)
    finally:
        torch.set_num_threads(threads)
        th.join()
        _, err = ref.communicate(timeout=900)
    if "error" in got:
        raise got["error"]
    assert ref.returncode == 0, err[-3000:]
    cli = got["cli"]
    yield {"work": work, "mesh": got["mesh"], "resume": got["resume"], "one": one,
           "cli": (cli.returncode, cli.stdout, cli.stderr)}


def one_device(arch: str, opt: str, steps: int):
    """(initial params, losses, state) of the one-device Trainer."""
    from repro_torch.train import Trainer

    tr = Trainer(smoke(arch), optimizer=opt, seq_len=SEQ, global_batch=BATCH, lr=LR,
                 device="cpu")
    tr.data = uniform(tr.cfg.vocab)
    p0 = flat_global(tr.params)
    losses = tr.run(steps, log_fn=lambda *_: None)
    return p0, losses, flat_global({"params": tr.params, "opt": tr.opt_state})


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_one_mesh_step_matches_one_device(runs, case):
    """Every family the Trainer trains, on 2x2, 1x4 and 4x1, with AdamW,
    and olmo-1b and an MoE with Orthant: the first step within the parity
    rule of the one-device step from the same seed."""
    from repro_torch.testing.step_check import step_gaps

    p0, want_loss, want = runs["one"][case_id(case)]
    losses, got = runs["mesh"][0]["cases"][case_id(case)]
    r = step_gaps(p0, split_state(got), split_state(want), LR, case[2])
    assert abs(losses[0] - want_loss[0]) <= 1e-5 * abs(want_loss[0]), (losses, want_loss)
    assert r["update"][1] <= GAP and r["state"][1] <= GAP and r["steps"] == (1, 1), r


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_encdec_step_on_a_mesh(runs, shape):
    """The encoder-decoder family through ``make_train_step`` on the mesh
    against the same step on one device."""
    from repro_torch.models import encdec
    from repro_torch.train import make_train_step

    cfg = smoke(ENCDEC)
    g = torch.Generator().manual_seed(5)
    params = encdec.init_encdec(cfg, g)
    batch = {"tokens": torch.randint(0, cfg.vocab, (BATCH, SEQ), generator=g),
             "frames": torch.randn((BATCH, SEQ // cfg.enc_downsample, cfg.d_model), generator=g)}
    batch["labels"] = torch.roll(batch["tokens"], -1, 1)
    opt_init, step = make_train_step(cfg, optimizer="adamw", lr=LR)
    p0 = flat_global(params)
    new_p, new_s, metrics = step(params, opt_init(params), batch)
    from repro_torch.testing.step_check import step_gaps

    losses, got = runs["mesh"][0]["cases"][f"{shape[0]}x{shape[1]}-{ENCDEC}-adamw"]
    want = split_state(flat_global({"params": new_p, "opt": new_s}))
    r = step_gaps(p0, split_state(got), want, LR, "adamw")
    assert abs(losses[0] - float(metrics["loss"])) <= 1e-5 * float(metrics["loss"])
    assert r["update"][1] <= GAP and r["state"][1] <= GAP, r


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_replicas_stay_bitwise_equal(runs, shape):
    """After every step of every case on the mesh, each rank's copy of a
    replicated block has the bits of every other rank's."""
    ranks = runs["mesh"]
    keys = [k for k in ranks[0]["digests"] if k.startswith(f"{shape[0]}x{shape[1]}-")]
    if shape == (2, 2):
        keys += ["elastic-whole", "elastic-again"]
    assert keys
    for key in keys:
        seen = [r["digests"][key] for r in ranks]
        assert seen[0] and not replicas_differ(seen), (key, replicas_differ(seen)[:5])


def test_same_mesh_resume_is_bitwise(runs):
    """Saved at step 2 on 2x2 and resumed on 2x2 to step 4: the losses and
    every leaf the uninterrupted run's, bit for bit."""
    cases = runs["mesh"][0]["cases"]
    (wl, states), (al, again) = cases["elastic-whole"], cases["elastic-again"]
    whole = states[4]
    assert al == wl[2:]
    assert sorted(again) == sorted(whole)
    assert [k for k in whole if not np.array_equal(whole[k], again[k])] == []


def _snapshot(work) -> tuple:
    """(a one-device Trainer resumed from the 2x2 step-2 snapshot, the
    snapshot's arrays)."""
    from repro_torch.train import Trainer

    tr = Trainer(smoke("olmo-1b"), optimizer=ELASTIC, seq_len=SEQ, global_batch=BATCH,
                 lr=LR, device="cpu", ckpt_dir=str(work / "ckpt"), resume=True)
    tr.data = uniform(tr.cfg.vocab)
    with np.load(work / "ckpt" / "step_00000002" / "leaves.npz") as f:
        return tr, {k: f[k] for k in f.files}


def test_elastic_resume_on_a_smaller_mesh_and_without_one(runs):
    """The 2x2 step-2 snapshot restores bitwise on 1x2 and with no mesh;
    each runs on to step 4, every step within the parity rule of the
    uninterrupted 2x2 run's."""
    work = runs["work"]
    tr, saved = _snapshot(work)
    assert tr.step_num == 2
    step, restored = runs["resume"][0]["restored"]
    assert step == 2 and sorted(restored) == sorted(saved)
    assert [k for k in saved if not np.array_equal(saved[k], restored[k])] == []
    here = flat_global({"params": tr.params, "opt": tr.opt_state})
    assert [k for k in saved if not np.array_equal(saved[k], here[k])] == []

    p2 = {k[len("params/"):]: v for k, v in saved.items() if k.startswith("params/")}
    want_l, whole = runs["mesh"][0]["cases"]["elastic-whole"]
    states = {}
    losses = []
    for s in (3, 4):
        losses += tr.run(s, log_fn=lambda *_: None)
        states[s] = flat_global({"params": tr.params, "opt": tr.opt_state})
    for got, got_l in ((runs["resume"][0]["states"], runs["resume"][0]["losses"]),
                       (states, losses)):
        for s, r in held_per_step(p2, got, whole, LR, ELASTIC):
            assert r["update"][1] <= GAP and r["state"][1] <= GAP and r["steps"] == (s, s), (
                s, r)
        assert np.allclose(got_l, want_l[2:], rtol=1e-5), (got_l, want_l)


def test_the_reference_reads_a_mesh_snapshot(runs):
    """The JAX package's ``ckpt.restore`` reads the 2x2 snapshot: every leaf
    the saved global array."""
    import jax

    from repro import checkpoint as jckpt
    from repro.configs import get_config as jax_get_config
    from repro.models import transformer as jtmod
    from repro.optim import make_optimizer

    work = runs["work"]
    _, saved = _snapshot(work)
    jcfg = jax_get_config("olmo-1b", smoke=True)
    params = jtmod.init_lm(jcfg, jax.random.PRNGKey(0))
    like = {"params": params, "opt": make_optimizer(ELASTIC)[0](params)}
    state, extra = jckpt.restore(str(work / "ckpt"), 2, like)
    assert extra["data"]["step"] == 2
    got = {}
    for path, x in jax.tree_util.tree_flatten_with_path(state)[0]:
        key = [str(p.key) if hasattr(p, "key") else f".{p.name}" if hasattr(p, "name")
               else str(p.idx) for p in path]
        got["/".join(key)] = np.asarray(x)
    assert sorted(got) == sorted(saved)
    assert [k for k in saved if not np.array_equal(saved[k], got[k])] == []


def test_mesh_run_matches_the_references_mesh_run(runs):
    """olmo-1b (smoke, float32 compute, AdamW) from the reference's step-0
    snapshot and on its batches: the port on a 2x2 gloo mesh and the JAX
    package on a 2x2 Auto mesh of host devices, 2 steps, each step's
    update (from that step's own parameters) and the state after it within
    the one-step parity rule."""
    from repro_torch.testing.step_check import step_gaps

    ref = runs["work"] / "ref"
    with np.load(ref / "ckpt" / "step_00000000" / "leaves.npz") as f:
        p0 = {k[len("params/"):]: f[k] for k in f.files if k.startswith("params/")}
    want, got = {}, {}
    for step in (1, 2):
        with np.load(ref / f"step{step}.npz") as f:
            want[step] = {k: f[k] for k in f.files if k != "loss"}
            want_loss = float(f["loss"])
        losses, got[step] = runs["mesh"][0]["cases"][f"reference-2x2-{step}"]
        assert abs(losses[0] - want_loss) <= 1e-5 * abs(want_loss), (step, losses, want_loss)
    for step, r in held_per_step(p0, got, want, LR, "adamw"):
        assert r["update"][1] <= GAP and r["state"][1] <= GAP and r["steps"] == (step, step), (
            step, r)


def test_cli_trains_on_a_2x2_mesh(runs):
    rc, out, err = runs["cli"]
    assert rc == 0, err[-2000:]
    lines = out.strip().splitlines()
    assert lines[0].startswith("mesh 2x2 ('data', 'model'): 4 ranks, gloo on the CPU"), lines
    assert lines[-1].startswith("done: 3 steps, final loss "), lines
    assert " s/step, " in lines[-2] and f"(batch {BATCH} x {SEQ}, adamw, CPU)" in lines[-2], lines


def _bf16_rank(shape, optimizer: str) -> dict:
    """One step of smoke olmo-1b at its bfloat16 compute on a mesh of this
    group; the state as global arrays."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train import Trainer

    torch.set_num_threads(1)
    cfg = get_config("olmo-1b", smoke=True)
    tr = Trainer(cfg, mesh=make_debug_mesh(*shape, device_type="cpu"), optimizer=optimizer,
                 seq_len=SEQ, global_batch=BATCH, lr=LR, device="cpu")
    tr.data = uniform(cfg.vocab)
    tr.run(1, log_fn=lambda *_: None)
    return flat_global({"params": tr.params, "opt": tr.opt_state})


def print_bf16_readings() -> None:
    """The first step of smoke olmo-1b at bfloat16 compute on each mesh of
    ``MESHES`` (4 gloo ranks of the host) against the one-device step at
    bfloat16 and at float32: the worst leaf's update and state gap, and
    the one-device bfloat16 step's own distance from the float32 one."""
    from repro_torch.configs import get_config
    from repro_torch.testing.spawn import spawn_ranks
    from repro_torch.testing.step_check import step_gaps
    from repro_torch.train import Trainer

    for opt in ("orthant", "adamw"):
        one = {}
        for cd in ("bfloat16", "float32"):
            cfg = dataclasses.replace(get_config("olmo-1b", smoke=True), compute_dtype=cd)
            tr = Trainer(cfg, optimizer=opt, seq_len=SEQ, global_batch=BATCH, lr=LR,
                         device="cpu")
            tr.data = uniform(cfg.vocab)
            p0 = flat_global(tr.params)
            tr.run(1, log_fn=lambda *_: None)
            one[cd] = split_state(flat_global({"params": tr.params, "opt": tr.opt_state}))
        r = step_gaps(p0, one["bfloat16"], one["float32"], LR, opt)
        print(f"{opt}: one-device bf16 vs f32: update {r['update']}, state {r['state']}")
        for shape in MESHES:
            got = split_state(spawn_ranks(_bf16_rank, WORLD, shape, opt)[0])
            a = step_gaps(p0, got, one["float32"], LR, opt)
            b = step_gaps(p0, got, one["bfloat16"], LR, opt)
            print(f"{opt} {shape[0]}x{shape[1]}: vs f32 update {a['update']}, state "
                  f"{a['state']}; vs one-device bf16 update {b['update'][1]:.3e}, state "
                  f"{b['state'][1]:.3e}")


if __name__ == "__main__" and sys.argv[1:] == ["bf16"]:
    print_bf16_readings()
