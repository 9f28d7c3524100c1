"""Optimizers: AdamW, Orthant (GGR-orthogonalized momentum), compression.

Parameter, gradient and state trees are nested dicts of tensors."""
from . import adamw, compress, orthant
from .adamw import AdamWState
from .compress import EFState
from .orthant import OrthantState


def make_optimizer(name: str):
    """(init_fn, update_fn) by name: 'adamw' | 'orthant'."""
    mod = {"adamw": adamw, "orthant": orthant}[name]
    return mod.init, mod.update


__all__ = ["AdamWState", "EFState", "OrthantState", "adamw", "compress",
           "make_optimizer", "orthant"]
