"""The port's training step (``repro_torch.train.step``) and the models'
gradients against the JAX package's ``train/step.py`` and
``jax.value_and_grad``.

The reference's own parameters (its ``init_lm`` / ``init_encdec``, as
numpy) and the same numpy batch go through both packages; smoke-size
configs only, MoE at ``lm_check.no_drop_f32``'s capacity so that no token
is dropped.  At float32 compute the loss and ``grad_norm`` are held within
1e-5 relative and every leaf's gradient within 1e-4 of its rms.  At
bfloat16 compute ``tests/test_torch_models.py``'s rule for a tree holds:
the port's worst leaf within the larger of 2e-2 and 1.5x the reference's
own bfloat16-vs-float32 distance, the largest over the leaves; the
reference's bfloat16 run there rounds every op to its dtype, as PyTorch
does (a subprocess with ``--xla_allow_excess_precision=false``: by default
XLA keeps a fusion's intermediates in float32, which moves single elements
of sparse gradients and flips near-tied MoE routes).  One optimizer step
holds each leaf's update and state within 1e-4 of its rms of the
reference's, over the elements the step determines
(``repro_torch.testing.step_check``).  Remat is checked within the port:
bitwise equal to a remat-free run.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs
from repro.optim import compress as jcompress
from repro.train.step import make_loss_fn as jax_loss_fn
from repro.train.step import make_train_step as jax_train_step
from repro.models import encdec as je
from repro.models import transformer as jt
from repro_torch.checkpoint.ckpt import _rebuild, _walk
from repro_torch.configs import list_archs as port_archs
from repro_torch.convert import from_numpy
from repro_torch.models import blocks as tb
from repro_torch.models.config import ArchConfig
from repro_torch.optim import compress as tcompress
from repro_torch.testing.lm_check import rel_err
from repro_torch.testing.step_check import (leading_columns, off_ties, rms_gap,
                                             sign_determined, update_of)
from repro_torch.train.step import make_loss_fn, make_train_step, value_and_grad

F32_LOSS, F32_GRAD, BF16 = 1e-5, 1e-4, 2e-2
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module: the port's plain kernel versions
    (Orthant on the CPU) run as many small ops, which several test workers'
    thread pools would otherwise fight over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(arch: str, compute: str = "float32", **kw):
    """The reference's smoke config at ``compute`` (an MoE with capacity for
    every token) and the port's with equal fields."""
    jcfg = jax_get_config(arch, smoke=True)
    if jcfg.family == "moe":
        kw["capacity_factor"] = jcfg.n_experts / jcfg.top_k
    jcfg = dataclasses.replace(jcfg, compute_dtype=compute, **kw)
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def ref_params(arch: str) -> dict:
    jcfg = jax_get_config(arch, smoke=True)
    key = jax.random.PRNGKey(1)
    p = je.init_encdec(jcfg, key) if jcfg.family == "encdec" else jt.init_lm(jcfg, key)
    return jax.tree.map(np.asarray, p)


@functools.lru_cache(maxsize=None)
def ref_batch(arch: str) -> dict:
    jcfg = jax_get_config(arch, smoke=True)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if jcfg.family == "vlm":
        batch["patch_embs"] = rng.standard_normal(
            (B, jcfg.n_patches, jcfg.vision_dim)).astype(np.float32)
    if jcfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, S // jcfg.enc_downsample, jcfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def ref_value_and_grad(arch: str, compute: str):
    """The reference's (loss, {path: grad}, grad_norm) as numpy."""
    jcfg, _ = pair(arch, compute)
    loss, grads = jax.jit(jax.value_and_grad(jax_loss_fn(jcfg)))(ref_params(arch),
                                                                ref_batch(arch))
    flat = {"/".join(p): np.asarray(g, np.float64) for p, g in _walk(grads)}
    gnorm = np.sqrt(sum(np.sum(g ** 2) for g in flat.values()))
    return float(loss), flat, float(gnorm)


def port_value_and_grad(arch: str, compute: str):
    _, tcfg = pair(arch, compute)
    loss, grads = value_and_grad(make_loss_fn(tcfg), from_numpy(ref_params(arch), device="cpu"),
                                 from_numpy(ref_batch(arch), device="cpu"))
    flat = {"/".join(p): g for p, g in _walk(grads)}
    return loss, flat


def rel(got, want) -> float:
    return rel_err(got.detach().double(), torch.as_tensor(np.asarray(want, np.float64)))


def test_both_packages_list_the_same_archs():
    assert port_archs() == list_archs()


def f32_readings(arch: str) -> dict:
    """The port's float32 loss, gradients and grad_norm against the
    reference's: relative loss and norm gaps, and each leaf's max|diff| /
    rms."""
    want_loss, want, want_norm = ref_value_and_grad(arch, "float32")
    loss, got = port_value_and_grad(arch, "float32")
    assert sorted(got) == sorted(want)
    gnorm = float(torch.sqrt(sum(g.double().square().sum() for g in got.values())))
    return {"loss": abs(float(loss) - want_loss) / abs(want_loss),
            "grads": {k: rel(got[k], want[k]) for k in want},
            "grad_norm": abs(gnorm - want_norm) / want_norm}


@pytest.mark.parametrize("arch", list_archs())
def test_loss_and_gradients_match_the_reference_f32(arch):
    """The counterpart of ``test_arch_forward_and_train_step``: every leaf
    gets a gradient, each within 1e-4 of its rms of ``jax.value_and_grad``'s."""
    r = f32_readings(arch)
    assert r["loss"] <= F32_LOSS
    worst = r["grads"]
    assert max(worst.values()) <= F32_GRAD, sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    assert r["grad_norm"] <= F32_LOSS


def dump_reference_bf16(path: str) -> None:
    """The reference's bfloat16 loss and gradients of every arch into an
    ``.npz`` at ``path`` (run in a process whose XLA rounds every op)."""
    jax.config.update("jax_enable_x64", True)  # as tests/conftest.py
    out = {}
    for arch in list_archs():
        loss, grads, _ = ref_value_and_grad(arch, "bfloat16")
        out[f"{arch}:loss"] = np.float64(loss)
        out.update({f"{arch}:{k}": g for k, g in grads.items()})
    np.savez(path, **out)


def start_reference_bf16(path) -> subprocess.Popen:
    """``dump_reference_bf16(path)`` in a subprocess whose XLA rounds every
    op to its dtype."""
    repo = Path(__file__).resolve().parents[1]
    # one thread: it runs beside the module's own tests
    env = dict(os.environ, PYTHONPATH=str(repo / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false "
                         "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    return subprocess.Popen([sys.executable, __file__, str(path)], env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def load_reference_bf16(proc: subprocess.Popen, path) -> dict:
    """arch -> (loss, {path: grad}) of the reference at bfloat16 compute,
    once ``proc`` has written them."""
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-2000:]
    out = {}
    with np.load(path) as data:
        for key in data.files:
            arch, leaf = key.split(":", 1)
            entry = out.setdefault(arch, [None, {}])
            if leaf == "loss":
                entry[0] = float(data[key])
            else:
                entry[1][leaf] = data[key]
    return out


@pytest.fixture(scope="module", autouse=True)
def ref_bf16_run(tmp_path_factory):
    """The reference's bfloat16 run, started with the module so that it
    runs beside the float32 tests; (process, npz path)."""
    path = tmp_path_factory.mktemp("bf16") / "ref.npz"
    proc = start_reference_bf16(path)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def ref_bf16(ref_bf16_run) -> dict:
    return load_reference_bf16(*ref_bf16_run)


def bf16_readings(arch: str, ref: dict) -> dict:
    """The port's bfloat16 loss and gradients against the reference's
    (``ref``: ``load_reference_bf16``'s) and the rule's bounds: the loss's
    relative gap and its bound, the worst leaf's max|diff| / rms and the
    tree's bound (the largest leaf bound)."""
    ref32_loss, ref32, _ = ref_value_and_grad(arch, "float32")
    want_loss, want = ref[arch]
    loss, got = port_value_and_grad(arch, "bfloat16")
    assert sorted(got) == sorted(want)
    dist = {k: rel(got[k], want[k]) for k in want}
    return {"loss": abs(float(loss) - want_loss) / abs(want_loss),
            "loss_bound": max(BF16, 1.5 * abs(want_loss - ref32_loss) / abs(ref32_loss)),
            "worst": max(dist.items(), key=lambda kv: kv[1]),
            "bound": max(max(BF16, 1.5 * rel(torch.as_tensor(want[k]), ref32[k]))
                         for k in want)}


@pytest.mark.parametrize("arch", list_archs())
def test_loss_and_gradients_match_the_reference_bf16(arch, ref_bf16):
    """At bfloat16 compute the worst leaf within max(2e-2, 1.5x the
    reference's own bfloat16-vs-float32 distance, the largest over the
    leaves); the loss likewise."""
    r = bf16_readings(arch, ref_bf16)
    assert r["loss"] <= r["loss_bound"]
    assert r["worst"][1] <= r["bound"], r


# ------------------------------------------------------------------ one step
STEP_CASES = {"adamw": ("adamw", 1, None), "adamw-accum2": ("adamw", 2, None),
              "orthant": ("orthant", 1, None), "orthant-accum2": ("orthant", 2, None),
              "adamw-int8_ef": ("adamw", 1, "int8_ef")}
# neither is the packages' default, so that a step that drops either shows
LR, WD = 1e-3, 0.3
# a leaf's update and each state leaf, rms of the gap over rms, over the
# elements the step determines (``step_check``); at most this share masked
STEP_GAP, MASKED = 1e-4, 0.05
B1 = 0.9  # AdamW's, both packages' default


@functools.lru_cache(maxsize=None)
def step_batch() -> dict:
    """256 tokens of olmo-1b's smoke vocab: after one step a weight's
    gradient has rank at most the token count, so the step's batch has
    more tokens than the narrow width (128 here); what rank is left is
    LayerNorm's (``step_check.leading_columns``)."""
    toks = np.random.default_rng(8).integers(0, 512, (4, 65)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@functools.lru_cache(maxsize=None)
def ref_step(case: str):
    """The reference's (params, opt_state, metrics[, ef_state]) after one
    ``train_step`` of olmo-1b (smoke, float32 compute), as numpy."""
    optimizer, accum, comp = STEP_CASES[case]
    jcfg, _ = pair("olmo-1b")
    opt_init, step = jax_train_step(jcfg, optimizer=optimizer, lr=LR, accum=accum,
                                    grad_compression=comp, weight_decay=WD)
    params = ref_params("olmo-1b")
    args = [params, opt_init(params), step_batch()]
    if comp:
        args.append(jcompress.init(params))
    return jax.tree.map(np.asarray, jax.jit(step)(*args))


@functools.lru_cache(maxsize=None)
def port_step(case: str):
    """The port's (params, opt_state, metrics[, ef_state]) after the same
    step (the tests only read it)."""
    optimizer, accum, comp = STEP_CASES[case]
    _, tcfg = pair("olmo-1b")
    opt_init, step = make_train_step(tcfg, optimizer=optimizer, lr=LR, accum=accum,
                                     grad_compression=comp, weight_decay=WD)
    params = from_numpy(ref_params("olmo-1b"), device="cpu")
    args = [params, opt_init(params), from_numpy(step_batch(), device="cpu")]
    if comp:
        args.append(tcompress.init(params))
    return step(*args)


def leaves(tree) -> dict:
    return {"/".join(p): np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
            for p, x in _walk(tree)}


def step_gaps(case: str, got, want) -> dict:
    """One step ``got`` against ``want`` (each as ``ref_step`` gives it):
    for every leaf the update's and every state leaf's ``rms_gap`` over the
    elements ``want`` determines, the worst of each as (leaf, gap); the
    largest share masked; and, for Orthant, each leaf's momentum ranks (a
    list, one a matrix) and how far (1, ..., 1) is from its null space,
    max|M·1| / max|M| along the narrow side."""
    optimizer, _, comp = STEP_CASES[case]
    p0 = leaves(ref_params("olmo-1b"))
    (wp, ws), (gp, gs) = (leaves(want[0]), leaves(want[1])), (leaves(got[0]), leaves(got[1]))
    if comp:
        ws.update(leaves(want[3]))
        gs.update(leaves(got[3]))
    assert sorted(gp) == sorted(wp) and sorted(gs) == sorted(ws)
    masks, ranks, null = {}, {}, {}
    for k, p in p0.items():
        if comp:
            masks[k] = off_ties(ws[".residual/" + k])
        elif optimizer == "orthant" and p.ndim >= 2 and min(p.shape[-2:]) > 1:
            mom = ws[".momentum/" + k].astype(np.float64)
            masks[k], ranks[k] = leading_columns(mom)
            narrow = -1 if p.shape[-2] >= p.shape[-1] else -2
            null[k] = float(np.abs(mom.sum(narrow)).max() / np.abs(mom).max())
        else:
            masks[k] = sign_determined(ws[(".m/" if optimizer == "adamw" else ".momentum/") + k])
    update = {k: rms_gap(update_of(p0[k], gp[k], LR), update_of(p0[k], wp[k], LR), masks[k])
              for k in wp}
    state = {}
    for k in ws:
        if k.endswith(".step"):
            assert int(gs[k]) == int(ws[k]) == 1
        else:
            leaf = k.split("/", 1)[1]
            # the residual is the payload's rounding error, a quantum's size:
            # held against the gradient it came from, m / (1 - b1)
            of = ws[".m/" + leaf] / (1 - B1) if k.startswith(".residual/") else None
            state[k] = rms_gap(gs[k], ws[k], masks[leaf] if comp else None, of)
    return {"update": max(update.items(), key=lambda kv: kv[1]),
            # every element, the masked ones too, in units of lr
            "span": max(float(np.abs(update_of(gp[k], wp[k], LR)).max()) for k in wp),
            "state": max(state.items(), key=lambda kv: kv[1]),
            "masked": max(1 - float(m.mean()) for m in masks.values()),
            "ranks": ranks, "null": null}


def step_readings(case: str) -> dict:
    """One step of the port against the reference's: the metrics' relative
    gaps and ``step_gaps``."""
    want, got = ref_step(case), port_step(case)
    out = {k: abs(float(got[2][k]) - float(want[2][k])) / abs(float(want[2][k]))
           for k in ("loss", "grad_norm")}
    return {**out, **step_gaps(case, got, want)}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_one_train_step_matches_the_reference(case):
    """Each leaf's update (p0 - p1) / lr and each state leaf (moments,
    error-feedback residual) within 1e-4 of its rms of the reference's, over
    the elements the step determines: AdamW's where |g| >= 1e-2 of rms (its
    first update is about sign(g)), int8's away from a rounding tie,
    Orthant's leading columns up to its momentum's rank, which is n - 1
    (LayerNorm's null vector, checked); loss and grad_norm within 1e-5
    relative; and every element of the new params, masked ones too,
    within 2.5·lr (the scale of one update, ``tests/test_train_stack.py``'s
    accumulation test)."""
    r = step_readings(case)
    assert r["loss"] <= F32_LOSS and r["grad_norm"] <= F32_LOSS, r
    assert r["update"][1] <= STEP_GAP and r["state"][1] <= STEP_GAP, r
    assert r["masked"] <= MASKED and r["span"] <= 2.5, r
    shapes = {k: p.shape for k, p in leaves(ref_params("olmo-1b")).items()}
    for k, ranks in r["ranks"].items():
        assert ranks == [min(shapes[k][-2:]) - 1] * len(ranks), (k, ranks)
        assert r["null"][k] <= 1e-5, (k, r["null"][k])


@pytest.mark.parametrize("optimizer", ["adamw", "orthant"])
def test_accumulation_matches_the_full_batch(optimizer):
    """``accum=2`` against ``accum=1`` inside the port, as the reference's
    ``test_grad_accumulation_matches_full_batch`` does, by the rule above."""
    one, two = port_step(optimizer), port_step(f"{optimizer}-accum2")
    assert abs(float(one[2]["loss"]) - float(two[2]["loss"])) <= F32_LOSS * float(one[2]["loss"])
    r = step_gaps(optimizer, two, one)
    assert r["update"][1] <= STEP_GAP and r["state"][1] <= STEP_GAP and r["span"] <= 2.5, r


def test_train_step_refuses_an_unknown_compression():
    with pytest.raises(ValueError, match="int8_ef"):
        make_train_step(pair("olmo-1b")[1], grad_compression="fp8")


@pytest.mark.parametrize("shape", [(2, 256, 64), (2, 64, 200), (2, 64, 64)])
def test_momentum_readings_see_both_faults_on_a_centred_momentum(shape):
    """``orthant_check.momentum_readings`` on ill-conditioned momenta (cond
    1e4) with LayerNorm's null vector along the narrow side, as trained
    ones have: every column but the dependent last one held, each within
    20 x u·cond_k of the float64 direction and of its sign (phase 12 (b)'s
    rule; on the host the kernels' plain versions); a flipped first column
    and a float16-rounded R each fail it."""
    from repro_torch.testing.orthant_check import momentum_readings

    A = np.random.default_rng(1).standard_normal(shape)
    U, _, Vt = np.linalg.svd(A, full_matrices=False)
    n = min(shape[-2:])
    M = U @ (np.logspace(0, -4, n)[:, None] * Vt)
    M -= M.mean(-1 if shape[-2] >= shape[-1] else -2, keepdims=True)
    r = momentum_readings(torch.as_tensor(M.astype(np.float32)), faults=True)
    cols = r["columns"]
    assert cols["determined"].tolist() == [n - 1, n - 1]
    assert cols["signs_off"].tolist() == [0, 0] and bool((cols["ratio"] <= 20).all())
    assert cols["flipped"][1].tolist() == [1, 1]
    assert bool((cols["half"][0] > 20).all())
    assert bool((r["gram"]["kernels"] <= 1e-6).all())


# ------------------------------------------------------------------ remat
REMAT_CASES = {"olmo-1b full": ("olmo-1b", "full"), "olmo-1b dots": ("olmo-1b", "dots"),
               "mixtral-8x22b": ("mixtral-8x22b", "full"),
               "phi-3-vision-4.2b": ("phi-3-vision-4.2b", "full"),
               "zamba2-1.2b": ("zamba2-1.2b", "full"), "xlstm-125m": ("xlstm-125m", "full"),
               "seamless-m4t-large-v2": ("seamless-m4t-large-v2", "full")}


class _MatmulCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


def remat_run(arch: str, policy: str, monkeypatch=None):
    """(loss, grads, tensors saved for backward outside the checkpointed
    bodies, weight products run in the backward pass) of one port
    ``value_and_grad``; with ``monkeypatch`` every body runs without remat."""
    _, tcfg = pair(arch, remat_policy=policy)
    if monkeypatch is not None:
        monkeypatch.setattr(tb, "checkpointed", lambda fn, *a, policy="full": fn(*a))
    params = from_numpy(ref_params(arch), device="cpu")
    batch = from_numpy(ref_batch(arch), device="cpu")
    live = [p.detach().requires_grad_() for _, p in _walk(params)]
    saved = [0]

    def pack(t):
        saved[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = make_loss_fn(tcfg)(_rebuild(params, iter(live)), batch)
    with _MatmulCount() as mm:
        grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    return loss.detach(), grads, saved[0], mm.n


@pytest.mark.parametrize("case", sorted(REMAT_CASES))
def test_remat_changes_no_bit_and_saves_less(case, monkeypatch):
    arch, policy = REMAT_CASES[case]
    loss, grads, saved, mm = remat_run(arch, policy)
    loss0, grads0, saved0, mm0 = remat_run(arch, policy, monkeypatch)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))
    assert saved < saved0, (saved, saved0)
    # "dots" keeps the layers' weight products: the backward pass runs only
    # one more than without remat, the loss chunk's logits (recomputed);
    # "full" recomputes them all
    assert (mm == mm0 + 1) if policy == "dots" else (mm > mm0 + 1), (mm, mm0)


def test_no_remat_without_grad():
    """Under ``torch.no_grad`` the bodies run plainly: no checkpoint."""
    calls = []
    out = torch.no_grad()(tb.checkpointed)(lambda x: calls.append(1) or x + 1, torch.ones(2))
    assert calls == [1] and not out.requires_grad


def print_readings() -> None:
    """Every reading the parity tests hold, printed (``python
    tests/test_torch_train.py readings`` from the repository root)."""
    import tempfile

    jax.config.update("jax_enable_x64", True)  # as tests/conftest.py
    with tempfile.TemporaryDirectory() as d:
        proc = start_reference_bf16(Path(d) / "ref.npz")
        for arch in list_archs():
            r = f32_readings(arch)
            k, v = max(r["grads"].items(), key=lambda kv: kv[1])
            print(f"f32 {arch}: loss {r['loss']:.2e}, worst gradient {k} {v:.2e} of rms, "
                  f"grad_norm {r['grad_norm']:.2e}")
        ref = load_reference_bf16(proc, Path(d) / "ref.npz")
    for arch in list_archs():
        r = bf16_readings(arch, ref)
        print(f"bf16 {arch}: loss {r['loss']:.2e} (bound {r['loss_bound']:.2e}), worst "
              f"leaf {r['worst'][0]} {r['worst'][1]:.3e} (bound {r['bound']:.3e}, "
              f"{r['worst'][1] / r['bound']:.3f} of it)")
    for case in sorted(STEP_CASES):
        r = step_readings(case)
        ranks = sorted({x for v in r["ranks"].values() for x in v})
        print(f"step {case}: loss {r['loss']:.1e}, grad_norm {r['grad_norm']:.1e}, update "
              f"{r['update'][0]} {r['update'][1]:.2e}, state {r['state'][0]} "
              f"{r['state'][1]:.2e} of rms, masked <= {r['masked']:.2%}, every element "
              f"<= {r['span']:.3f} lr"
              + (f", momentum ranks {ranks}, max|M·1|/max|M| <= {max(r['null'].values()):.1e}"
                 if ranks else ""))


if __name__ == "__main__":
    if sys.argv[1] == "readings":
        print_readings()
    else:
        dump_reference_bf16(sys.argv[1])
