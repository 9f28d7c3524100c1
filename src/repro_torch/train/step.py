"""train_step: loss and gradients (microbatch accumulation, remat) and the
optimizer update.

The JAX package's ``train/step.py``.  Gradients come from
``torch.autograd.grad`` over the parameter tree's leaves (detached views
of them, so the caller's tensors carry no graph); remat is the models' own
(``models.blocks.checkpointed``).  The optimizers are ``optim``'s pure
functions over tensor trees.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.ckpt import _rebuild, _walk
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import mesh_ops
from repro_torch.models import transformer as tmod
from repro_torch.models.config import ArchConfig
from repro_torch.optim import compress as compress_mod
from repro_torch.optim import make_optimizer
from repro_torch.optim._tree import tree_map, zeros_f32


def make_loss_fn(cfg: ArchConfig) -> Callable:
    if cfg.family == "encdec":
        return functools.partial(encdec_mod.encdec_loss, cfg=cfg)
    return functools.partial(tmod.lm_loss, cfg=cfg)


def value_and_grad(loss_fn: Callable, params, batch) -> tuple:
    """(loss, grads): ``loss_fn(params, batch)`` detached and its gradient
    with respect to every leaf of ``params`` (zeros for a leaf the loss does
    not read, as ``jax.value_and_grad`` gives), a tree shaped like it.

    On ``DTensor`` parameters (a mesh) the loss comes back whole, and each
    leaf's gradient in its parameter's placements: the sums the sharded
    forward pass left partial (the data-parallel all-reduce) are taken here,
    before any update reads them."""
    live = [p.detach().requires_grad_() for _, p in _walk(params)]
    with torch.enable_grad():
        loss = mesh_ops.whole(loss_fn(_rebuild(params, iter(live)), batch))
        grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    grads = [g.redistribute(p.device_mesh, p.placements) if mesh_ops.is_dtensor(g) else g
             for g, p in zip(grads, live)]
    return loss.detach(), _rebuild(params, iter(grads))


def global_norm(grads) -> torch.Tensor:
    """The f32 norm of a gradient tree, its squares summed leaf by leaf in
    the tree's order."""
    return torch.sqrt(sum(g.to(torch.float32).square().sum() for _, g in _walk(grads)))


def make_grads_fn(cfg: ArchConfig, accum: int = 1) -> Callable:
    """``grads_of(params, batch) -> (loss, grads)``.  With ``accum > 1`` the
    batch splits into ``accum`` microbatches along its first axis; their
    losses and f32 gradients are summed in order, then scaled by 1/accum,
    as the reference's scan does."""
    loss_fn = make_loss_fn(cfg)
    if accum == 1:
        return functools.partial(value_and_grad, loss_fn)

    def grads_of(params, batch):
        for x in batch.values():
            if x.shape[0] % accum:
                raise ValueError(f"a batch of {x.shape[0]} does not split into "
                                 f"{accum} microbatches")
        micro = {k: v.chunk(accum) for k, v in batch.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=next(iter(batch.values())).device)
        g_sum = zeros_f32(params)
        for i in range(accum):
            loss, g = value_and_grad(loss_fn, params, {k: v[i] for k, v in micro.items()})
            loss_sum = loss_sum + loss
            g_sum = tree_map(lambda a, b: a + b.to(torch.float32), g_sum, g)
        inv = 1.0 / accum
        return loss_sum * inv, tree_map(lambda g: g * inv, g_sum)

    return grads_of


def make_update_fn(optimizer: str = "adamw", lr: float = 3e-4,
                   weight_decay: float = 0.1) -> tuple:
    """``(init_opt, update)``: ``update(params, opt_state, loss, grads) ->
    (params, opt_state, metrics)``, the metrics ``loss`` and ``grad_norm``."""
    opt_init, opt_update = make_optimizer(optimizer)

    def update(params, opt_state, loss, grads):
        gnorm = global_norm(grads)
        new_params, new_opt = opt_update(grads, opt_state, params, lr=lr,
                                         weight_decay=weight_decay)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return opt_init, update


def make_train_step(
    cfg: ArchConfig,
    optimizer: str = "adamw",
    lr: float = 3e-4,
    accum: int = 1,
    grad_compression: Optional[str] = None,
    weight_decay: float = 0.1,
):
    """Returns (init_opt, train_step).

    train_step(params, opt_state, batch[, ef_state]) -> (params, opt_state,
    metrics[, ef_state]).  With accum > 1 the global batch is split into
    microbatches and gradients accumulate over them (activation memory /
    accum).  ``grad_compression="int8_ef"`` gives the 4-argument step: the
    gradients go through ``optim.compress.compress_grads`` with the
    error-feedback state (``optim.compress.init(params)``) before the norm
    and the update.
    """
    grads_of = make_grads_fn(cfg, accum)
    opt_init, update = make_update_fn(optimizer, lr, weight_decay)

    if grad_compression is None:

        def train_step(params, opt_state, batch):
            return update(params, opt_state, *grads_of(params, batch))

        return opt_init, train_step

    if grad_compression != "int8_ef":
        raise ValueError(f"grad_compression {grad_compression!r}: only 'int8_ef'")

    def train_step_c(params, opt_state, batch, ef_state):
        loss, grads = grads_of(params, batch)
        grads, ef_state = compress_mod.compress_grads(grads, ef_state)
        return (*update(params, opt_state, loss, grads), ef_state)

    return opt_init, train_step_c
