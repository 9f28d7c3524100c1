"""The port's ``Trainer`` and ``launch.train`` against the JAX package's
(``tests/test_train_stack.py``'s trainer tests, and a snapshot of either
package resumed by the other).  Smoke-size olmo-1b on the CPU."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.train import Trainer as JaxTrainer
from repro_torch.checkpoint.ckpt import _walk
from repro_torch.convert import from_numpy
from repro_torch.launch import train as launch_train
from repro_torch.models.config import ArchConfig
from repro_torch.testing.step_check import rms_gap, update_of
from repro_torch.train import Trainer

_REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: the port's plain kernel versions
    (Orthant on the CPU) run as many small ops, which several test workers'
    thread pools would otherwise fight over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(**kw):
    jcfg = dataclasses.replace(jax_get_config("olmo-1b", smoke=True), **kw)
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg))


def quiet(*_):
    pass


def leaves(tree) -> dict:
    return {"/".join(p): np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
            for p, x in _walk(tree)}


def test_orthant_trains_tiny_lm():
    """The counterpart of ``test_orthant_trains_tiny_lm``."""
    tr = Trainer(cfgs()[1], optimizer="orthant", seq_len=32, global_batch=4, lr=3e-3,
                 device="cpu")
    losses = tr.run(12, log_every=100, log_fn=quiet)
    assert losses[-1] < losses[0], losses
    assert len(tr.step_times) == 12 and all(t["wall_s"] > 0 for t in tr.step_times)


def test_checkpoint_roundtrip_and_resume(tmp_path):
    """The counterpart of ``test_checkpoint_roundtrip_and_resume``, and a
    resume bit for bit: 4 steps, a restart from the step-4 snapshot and 2
    more steps give the same params, state and losses as 6 uninterrupted."""
    cfg = cfgs()[1]
    kw = dict(seq_len=32, global_batch=2, lr=1e-3, device="cpu")
    tr = Trainer(cfg, ckpt_dir=str(tmp_path / "a"), ckpt_every=4, **kw)
    tr.run(8, log_fn=quiet)
    tr2 = Trainer(cfg, ckpt_dir=str(tmp_path / "a"), resume=True, **kw)
    assert tr2.step_num == 8
    for k, v in leaves(tr.params).items():
        assert np.array_equal(v, leaves(tr2.params)[k]), k

    whole = Trainer(cfg, **kw)
    want = whole.run(6, log_fn=quiet)
    first = Trainer(cfg, ckpt_dir=str(tmp_path / "b"), ckpt_every=4, **kw)
    got = first.run(4, log_fn=quiet)
    again = Trainer(cfg, ckpt_dir=str(tmp_path / "b"), ckpt_every=4, resume=True, **kw)
    assert again.step_num == 4
    got += again.run(6, log_fn=quiet)
    assert got == want
    for a, b in ((whole.params, again.params), (whole.opt_state, again.opt_state)):
        b = leaves(b)
        for k, v in leaves(a).items():
            assert np.array_equal(v, b[k]), k


class ReferenceBatches:
    """The reference's stream as the port's ``Trainer.data``: the same
    batches, as tensors on the asked device."""

    def __init__(self, data):
        self.data = data

    def batch_at(self, step, device="cuda"):
        return from_numpy({k: np.asarray(v) for k, v in self.data.batch_at(step).items()},
                          device=device)

    def state(self, step):
        return self.data.state(step)


LR, MORE, GAP = 1e-3, 2, 1e-4


def _same_state(port, ref):
    """The port's and the reference's (params, opt state) leaf for leaf,
    bitwise (one of them was just restored from the other's snapshot)."""
    for a, b in ((port.params, ref.params), (port.opt_state, ref.opt_state)):
        a, b = leaves(a), jax.tree.map(np.asarray, b)
        b = {"/".join(p): x for p, x in _walk(b)}
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def _close_after(port, ref, steps):
    """Both run on to ``steps`` on the reference's batches: each leaf's
    update since the snapshot, (p_then - p_now) / lr, and each state leaf
    within ``GAP`` of its rms of the reference's, over every element, and
    every parameter within 2.5·lr a step."""
    port.data = ReferenceBatches(ref.data)
    p0 = leaves(port.params)
    ref.run(steps, log_fn=quiet)
    port.run(steps, log_fn=quiet)
    gaps = {}
    for name, a, b in (("params", port.params, ref.params), ("state", port.opt_state, ref.opt_state)):
        got, want = leaves(a), {"/".join(p): np.asarray(x)
                                for p, x in _walk(jax.tree.map(np.asarray, b))}
        for k in want:
            if name == "params":
                gaps[k] = rms_gap(update_of(p0[k], got[k], LR), update_of(p0[k], want[k], LR))
            elif not k.endswith(".step"):
                gaps[k] = rms_gap(got[k], want[k])
    worst = max(gaps.items(), key=lambda kv: kv[1])
    span = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    print(f"cross-package resume: worst leaf {worst[0]} {worst[1]:.2e} of rms, every element "
          f"within {span / LR:.3f} lr")
    assert worst[1] <= GAP, worst
    assert span <= 2.5 * LR * MORE, span


@pytest.mark.parametrize("first", ["reference", "port"])
def test_cross_package_resume(first, tmp_path):
    """One package trains 4 steps and saves; the other's ``Trainer(resume=
    True)`` picks the snapshot up at step 4 (params, optimizer state, data
    step, bitwise); then both run 2 more steps on the reference's batches,
    each leaf's update and state within 1e-4 of its rms of the
    reference's, every element within 2.5·lr a step.  At float32 compute, as the parity tests of one step: at
    bfloat16 XLA and PyTorch round in different places, which
    ``tests/test_torch_train.py``'s bfloat16 rule holds."""
    jcfg, tcfg = cfgs(compute_dtype="float32")
    kw = dict(seq_len=16, global_batch=2, lr=LR, ckpt_dir=str(tmp_path), ckpt_every=4)
    if first == "reference":
        ref = JaxTrainer(jcfg, **kw)
        ref.run(4, log_fn=quiet)
        port = Trainer(tcfg, resume=True, device="cpu", **kw)
    else:
        port = Trainer(tcfg, device="cpu", **kw)
        port.run(4, log_fn=quiet)
        ref = JaxTrainer(jcfg, resume=True, **kw)
    assert port.step_num == ref.step_num == 4
    _same_state(port, ref)
    _close_after(port, ref, 4 + MORE)


def test_mesh_and_int8_ef_are_not_ported():
    """A mesh needs its ranks (``tests/test_torch_mesh_train.py`` trains on
    them); ``grad_compression="int8_ef"`` still raises, as the reference's
    Trainer cannot run it."""
    from repro_torch.launch.mesh import make_debug_mesh

    cfg = cfgs()[1]
    with pytest.raises(ValueError, match="needs 2 ranks.*no process group"):
        Trainer(cfg, mesh=make_debug_mesh(2, 1, device_type="cpu"), device="cpu")
    with pytest.raises(NotImplementedError, match="4-argument step"):
        Trainer(cfg, grad_compression="int8_ef", device="cpu")


def test_the_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfgs()[1])


def test_cli_trains_on_the_cpu():
    env = {"PYTHONPATH": str(_REPO / "src"), "PATH": "/usr/bin:/bin"}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "olmo-1b",
                        "--smoke", "--device", "cpu", "--steps", "3", "--seq-len", "16",
                        "--global-batch", "2"], capture_output=True, text=True, env=env,
                       timeout=240)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[-1].startswith("done: 3 steps, final loss "), lines
    assert " s/step, " in lines[-2] and "tok/s (batch 2 x 16, adamw, CPU)" in lines[-2], lines


@pytest.mark.parametrize("args,says", [((), "CUDA"),
                                       (("--device", "cpu", "--mesh", "16x16"), "needs 256 ranks"),
                                       (("--device", "cpu", "--mesh", "prod2"), "needs 512 ranks"),
                                       (("--device", "cpu", "--grad-compression", "int8_ef"),
                                        "4-argument step")])
def test_cli_refuses_what_it_cannot_run(args, says, capsys):
    if not args and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exc:
        launch_train.main(["--arch", "olmo-1b", "--smoke", "--steps", "3", *args])
    assert exc.value.code not in (0, None) and says in str(exc.value.code)
