"""Trainer: the training loop with checkpoint/restart, on one device.

Fault-tolerance contract (the JAX package's ``train/trainer.py``):
  * checkpoints are atomic + step-tagged (see checkpoint/ckpt.py), in the
    format both packages read, so either resumes the other's snapshot;
  * ``Trainer(..., resume=True)`` picks up the latest good step;
  * the data stream is a pure function of the step, so restarts are
    bit-reproducible.

The mesh half (``mesh=``: sharded parameters and batches over a device
mesh) is not ported: ``mesh`` other than ``None`` raises.  So does
``grad_compression="int8_ef"``: the reference's ``Trainer`` cannot run it
(its ``make_train_step`` returns the 4-argument step, its ``run`` calls the
step with 3); ``train.step.make_train_step`` ports the step itself.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.data import SyntheticTokens
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tmod
from repro_torch.models.config import ArchConfig
from repro_torch.serve.dispatch import resolve_device
from repro_torch.train.step import make_grads_fn, make_update_fn


class Trainer:
    """``step_times`` holds one dict a step run: its host wall ``wall_s``
    (the step's work finished on the device), and on the card
    ``fwd_bwd_ms`` / ``opt_ms``, the device time of the loss and gradients
    and of the update (CUDA events)."""

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
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...): the mesh half of the training stack is not "
                "ported yet (ROADMAP A9); the port trains on one device")
        if grad_compression is not None:
            raise NotImplementedError(
                f"Trainer(grad_compression={grad_compression!r}): the reference's "
                "Trainer cannot run it (train/step.py:83 returns the 4-argument "
                "step, train/trainer.py:110 calls it with 3); use "
                "train.step.make_train_step(grad_compression=...) directly")
        self.cfg = cfg
        self.device = resolve_device(device)
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
        self.opt_state = opt_init(self.params)

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

    def run(self, steps: int, log_every: int = 10, log_fn=print):
        """Steps until ``step_num`` reaches ``steps``; returns their losses."""
        t0 = time.time()
        losses = []
        while self.step_num < steps:
            metrics = self._step(self.data.batch_at(self.step_num, device=self.device))
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
        state, extra = ckpt.restore(self.ckpt_dir, step, like)
        self.params, self.opt_state = state["params"], state["opt"]
        self.step_num = extra["data"]["step"]
