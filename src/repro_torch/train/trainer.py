"""Trainer: mesh-aware loop with checkpoint/restart and elastic resume.

Fault-tolerance contract (the JAX package's ``train/trainer.py``):
  * checkpoints are atomic + step-tagged (see checkpoint/ckpt.py), in the
    format both packages read, so either resumes the other's snapshot;
  * ``Trainer(..., resume=True)`` picks up the latest good step;
  * the data stream is a pure function of the step, so restarts are
    bit-reproducible;
  * the mesh is a constructor argument — after a node failure the launcher
    re-forms a smaller mesh from survivors and the same checkpoint restores
    onto it (param shardings are recomputed from the same logical rules).

On a mesh (a ``torch.distributed`` ``DeviceMesh`` with a "model" axis, one
process a rank) parameters and optimizer moments are ``DTensor``s placed by
``parallel.param_pspecs``, each batch is split by ``batch_spec("tokens")``,
and ``DTensor`` carries the forward and backward pass (``models.mesh_ops``
for what it cannot shard), so a sharded run computes what the one-device
run computes.  ``grad_compression="int8_ef"`` raises: the reference's
``Trainer`` cannot run it (its ``make_train_step`` returns the 4-argument
step, its ``run`` calls the step with 3); ``train.step.make_train_step``
ports the step itself.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.data import SyntheticTokens
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tmod
from repro_torch.models.config import ArchConfig
from repro_torch.models import mesh_ops
from repro_torch.parallel import MeshRules, batch_spec, map_named, param_pspec, placements
from repro_torch.parallel.collectives import gather_with_c10d_on_gloo
from repro_torch.serve.dispatch import resolve_device
from repro_torch.train.step import make_grads_fn, make_update_fn


def _block(x: torch.Tensor, mesh, places):
    """This rank's block of the whole tensor ``x`` as a ``DTensor`` with
    ``places``: sliced locally from the replica every rank holds, with no
    communication."""
    from torch.distributed.tensor import DTensor, Replicate

    whole = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return whole.redistribute(mesh, places)


def shard_tree(tree, cfg: ArchConfig, rules: MeshRules):
    """``tree`` (parameters, or an optimizer state over them) placed on
    ``rules.mesh`` by ``param_pspec``: each leaf a ``DTensor`` of this rank's
    block, cut locally from a whole leaf every rank holds (a ``DTensor``
    leaf is redistributed); a 0-d leaf (a scalar step count) stays whole."""
    mesh = rules.mesh

    def place(name, x):
        if x.ndim == 0:
            return x
        p = placements(param_pspec(name, x, cfg, rules), mesh)
        return x.redistribute(mesh, p) if mesh_ops.is_dtensor(x) else _block(x, mesh, p)

    return map_named(place, tree)


def refuse_grad_compression(grad_compression: Optional[str]) -> None:
    """``NotImplementedError`` for any ``grad_compression``: the reference's
    ``Trainer`` cannot run one."""
    if grad_compression is not None:
        raise NotImplementedError(
            f"Trainer(grad_compression={grad_compression!r}): the reference's "
            "Trainer cannot run it (train/step.py:83 returns the 4-argument "
            "step, train/trainer.py:110 calls it with 3); use "
            "train.step.make_train_step(grad_compression=...) directly")


def _mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``; on a card shared under gloo, the
    all-gather ``DTensor`` issues goes through gloo's c10d all-gather
    (``parallel.collectives``)."""
    if mesh.device_type != "cuda":
        return torch.device(mesh.device_type)
    import torch.distributed as dist

    if any(dist.get_backend(mesh.get_group(i)) == "gloo" for i in range(mesh.ndim)):
        gather_with_c10d_on_gloo()
    return torch.device("cuda", torch.cuda.current_device())


class Trainer:
    """``step_times`` holds one dict a step run: its host wall ``wall_s``
    (the step's work finished on the device), and on the card
    ``fwd_bwd_ms`` / ``opt_ms``, the device time of the loss and gradients
    and of the update (CUDA events).

    ``device`` (default: the card) is where a run without a mesh trains; on
    a mesh each rank trains on its own device of the mesh (``cuda``: the
    current card), and ``device``, when given, must be of the mesh's type.
    Every rank draws the whole parameter tree from the same seeded generator
    and keeps its block, so a mesh run starts from the one-device run's
    parameters bit for bit."""

    def __init__(
        self,
        cfg: ArchConfig,
        mesh=None,
        optimizer: str = "adamw",
        lr: float = 3e-4,
        seq_len: int = 512,
        global_batch: int = 8,
        accum: int = 1,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 50,
        resume: bool = True,
        seed: int = 0,
        grad_compression: Optional[str] = None,
        device=None,
    ):
        refuse_grad_compression(grad_compression)
        self.cfg = cfg
        self.mesh = mesh
        self.rules = MeshRules(mesh) if mesh is not None else None
        if mesh is None:
            self.device = resolve_device("cuda" if device is None else device)
        else:
            self.device = _mesh_device(mesh)
            if device is not None and torch.device(device).type != self.device.type:
                raise ValueError(f"Trainer(device={str(device)!r}) on a {mesh.device_type} mesh")
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.data = SyntheticTokens(cfg.vocab, seq_len, global_batch, seed)
        self.step_num = 0
        self.step_times: list[dict] = []

        gen = torch.Generator(device=self.device).manual_seed(seed)
        init = encdec_mod.init_encdec if cfg.family == "encdec" else tmod.init_lm
        self.params = init(cfg, gen)
        opt_init, self._update = make_update_fn(optimizer, lr)
        self._grads = make_grads_fn(cfg, accum)
        self._shardings = None
        if self.rules is None:
            self.opt_state = opt_init(self.params)
        else:
            self.params = shard_tree(self.params, cfg, self.rules)
            # optimizer moments mirror the param tree (same leaf names), so the
            # same name-based rules place them
            self.opt_state = shard_tree(opt_init(self.params), cfg, self.rules)
            # elastic resume restores onto these (the current mesh's) shardings
            self._shardings = map_named(
                lambda _, x: (mesh, x.placements) if mesh_ops.is_dtensor(x) else None,
                {"params": self.params, "opt": self.opt_state})

        if resume and ckpt_dir:
            last = ckpt.latest_step(ckpt_dir)
            if last is not None:
                self.restore(last)

    # ------------------------------------------------------------------
    def _step(self, batch) -> dict:
        on_card = self.device.type == "cuda"
        t0 = time.perf_counter()
        if on_card:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
        with _implicit_replication(self.mesh):
            loss, grads = self._grads(self.params, batch)
        if on_card:
            ev[1].record()
        self.params, self.opt_state, metrics = self._update(
            self.params, self.opt_state, loss, grads)
        del grads
        times = {}
        if on_card:
            ev[2].record()
            ev[2].synchronize()
            times = {"fwd_bwd_ms": ev[0].elapsed_time(ev[1]),
                     "opt_ms": ev[1].elapsed_time(ev[2])}
        metrics = {k: float(v) for k, v in metrics.items()}
        self.step_times.append({"wall_s": time.perf_counter() - t0, **times})
        return metrics

    def _place_batch(self, batch: dict) -> dict:
        """On a mesh, each rank's rows of the batch every rank drew."""
        if self.rules is None:
            return batch
        spec = batch_spec("tokens", self.rules)
        return {k: _block(v, self.mesh, placements(spec, self.mesh)) for k, v in batch.items()}

    def run(self, steps: int, log_every: int = 10, log_fn=print):
        """Steps until ``step_num`` reaches ``steps``; returns their losses."""
        t0 = time.time()
        losses = []
        while self.step_num < steps:
            metrics = self._step(self._place_batch(
                self.data.batch_at(self.step_num, device=self.device)))
            self.step_num += 1
            losses.append(metrics["loss"])
            if self.step_num % log_every == 0:
                dt = time.time() - t0
                log_fn(
                    f"step {self.step_num:5d} loss {losses[-1]:.4f} "
                    f"({dt / max(1, self.step_num):.2f}s/step)"
                )
            if self.ckpt_dir and self.step_num % self.ckpt_every == 0:
                self.save()
        return losses

    # ------------------------------------------------------------------
    def save(self):
        state = {"params": self.params, "opt": self.opt_state}
        ckpt.save(
            self.ckpt_dir,
            self.step_num,
            state,
            extra={"data": self.data.state(self.step_num)},
        )

    def restore(self, step: int):
        like = {"params": self.params, "opt": self.opt_state}
        # elastic: the shardings are those of the CURRENT mesh
        state, extra = ckpt.restore(self.ckpt_dir, step, like, self._shardings)
        self.params, self.opt_state = state["params"], state["opt"]
        self.step_num = extra["data"]["step"]


def _implicit_replication(mesh):
    """On a mesh, plain tensors the model makes (positions, masks, running
    sums) join ``DTensor`` ops as replicated; without one, nothing."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()
