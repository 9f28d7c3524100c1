"""Carry state across packages: numpy-array trees <-> the port's tensor trees.

The serving engine's state is the ``(R, d)`` factor pairs and the model
matrices of the requests; the optimizers' is their moment trees.
``from_numpy`` and ``to_numpy`` convert whole trees of them —
``KalmanState``, ``RLSState``, ``LstsqResult``, ``PivotedLstsq``, the request
tuples of ``make_workload``, ``AdamWState``, ``EFState``, ``OrthantState``,
and any tuple/list/dict nesting of arrays — so the same inputs can be handed
to the JAX package (as numpy) and to the port (as tensors), and results
compared.

A named tuple converts to the port's class of the same name when there is
one (a JAX ``KalmanState`` becomes ``repro_torch.solvers.KalmanState``);
other values (strings, ints, None) pass through.  Within one conversion an
array that appears several times becomes ONE tensor, so a fleet-shared model
matrix stays shared and the kalman executor still broadcasts it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim import AdamWState, EFState, OrthantState
from repro_torch.ranks import PivotedLstsq, PivotedQR
from repro_torch.solvers import KalmanState, LstsqResult, RLSState

__all__ = ["from_numpy", "to_numpy"]

_PORT_TYPES = {cls.__name__: cls for cls in
               (AdamWState, EFState, KalmanState, LstsqResult, OrthantState,
                PivotedLstsq, PivotedQR, RLSState)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _convert(tree, leaf, types, memo):
    if id(tree) in memo:
        return memo[id(tree)]
    if _is_namedtuple(tree):
        cls = types.get(type(tree).__name__, type(tree))
        out = cls(*(_convert(v, leaf, types, memo) for v in tree))
    elif isinstance(tree, (tuple, list)):
        out = type(tree)(_convert(v, leaf, types, memo) for v in tree)
    elif isinstance(tree, dict):
        out = {k: _convert(v, leaf, types, memo) for k, v in tree.items()}
    else:
        out = leaf(tree)
    memo[id(tree)] = out
    return out


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A tensor of ``a``'s values; a bfloat16 array (``ml_dtypes``' type, as
    JAX hands it out) goes across bit for bit through its 16-bit pattern,
    so neither side needs ``ml_dtypes``."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(a)


def from_numpy(tree, device="cuda"):
    """Every array leaf (numpy, or anything ``np.asarray`` takes, such as a
    JAX array) becomes a tensor on ``device`` — the card unless the caller
    asks for the CPU; bfloat16 leaves keep their bits.  Tensors move to
    ``device``."""
    dev = torch.device(device)

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, np.ndarray) or hasattr(x, "__array__"):
            return _tensor(np.array(x)).to(dev)
        return x

    return _convert(tree, leaf, _PORT_TYPES, {})


def to_numpy(tree):
    """Every tensor leaf becomes a numpy array on the host; a bfloat16
    tensor becomes float32, which holds each of its values exactly (numpy
    has no bfloat16).  Numpy arrays and other leaves pass through.  Named
    tuples keep their class."""

    def leaf(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        return x

    return _convert(tree, leaf, {}, {})
