"""GGR kernels for the H100, each a hand-written CUDA kernel with a plain
PyTorch version beside it (the version CPU tensors run).

kernels:
  backend    — precision policies and the degraded-mode schedule override
  ggr_panel  — batched dense GEQRT tile sweep (``csrc/ggr_panel.cu``)
  ggr_update — batched row-append sweep (``csrc/ggr_update.cu``) + the
               pad_batch / pad_to_tile padding primitives
  ops        — the public entry points
  _cuda      — nvcc build into ``build/kernels`` and the ctypes binding
"""
from .ggr_update import pad_batch, pad_to_tile
from .ops import Precision, batched_geqrt, batched_update, resolve_precision

__all__ = [
    "Precision",
    "batched_geqrt",
    "batched_update",
    "pad_batch",
    "pad_to_tile",
    "resolve_precision",
]
