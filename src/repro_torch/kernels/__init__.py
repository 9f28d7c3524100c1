"""GGR kernels for the H100, each a hand-written CUDA kernel with a plain
PyTorch version beside it (the version CPU tensors run).

kernels:
  backend    — precision policies and the degraded-mode schedule override
  ggr_panel  — fused panel factorization (``csrc/ggr_panel_factor.cu``) and
               batched dense GEQRT tile sweep (``csrc/ggr_panel.cu``)
  ggr_apply  — fused DET2-grid trailing update (``csrc/ggr_apply.cu``)
  ggr_update — batched row-append sweep (``csrc/ggr_update.cu``) + the
               pad_batch / pad_to_tile padding primitives
  ops        — the public entry points, incl. the full-QR fused driver
  ref        — plain-PyTorch oracles over ``core.ggr``
  _cuda      — nvcc build into ``build/kernels`` and the ctypes binding
"""
from .ggr_update import pad_batch, pad_to_tile
from .ops import (
    Precision,
    apply_panel,
    batched_geqrt,
    batched_update,
    ggr_qr_pallas,
    panel_qr,
    resolve_precision,
    tsqrt,
)

__all__ = [
    "Precision",
    "apply_panel",
    "batched_geqrt",
    "batched_update",
    "ggr_qr_pallas",
    "pad_batch",
    "pad_to_tile",
    "panel_qr",
    "resolve_precision",
    "tsqrt",
]
