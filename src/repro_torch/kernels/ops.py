"""Public kernel entry points (the JAX package's ``kernels.ops`` names).

``batched_geqrt`` and ``batched_update`` keep the JAX signatures minus
``interpret``: the tensor's device decides — a CPU tensor runs the plain
PyTorch version, a CUDA tensor the hand-written kernel (or raises).

Not ported yet (the fused schedule's kernels, next slice): ``panel_qr``,
``apply_panel``, ``tsqrt`` and ``ggr_qr_pallas``.
"""
from __future__ import annotations

from .backend import Precision, resolve_precision
from .ggr_panel import batched_geqrt
from .ggr_update import batched_update

__all__ = [
    "Precision",
    "resolve_precision",
    "batched_geqrt",
    "batched_update",
]
