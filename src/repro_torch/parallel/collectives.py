"""The all-gather ``DTensor`` issues, on gloo groups of CUDA tensors.

Several ranks can share one card only under gloo (NCCL refuses two ranks on
one device).  There, the functional all-gather that ``DTensor`` redistributes
with (``torch.ops._c10d_functional.all_gather_into_tensor``) crashes the
process in its wait on torch 2.11, while gloo's c10d all-gather
(``dist.all_gather_into_tensor``) and the functional all-reduce,
reduce-scatter and all-to-all work on the same tensors.
``gather_with_c10d_on_gloo`` registers, for CUDA tensors, a kernel of that
functional op that calls the c10d all-gather on the op's group: the same
blocks in the same rank order, with nothing left for the op's wait to wait
on.  ``Trainer(mesh=...)`` installs it when its mesh runs gloo on the card.
"""
from __future__ import annotations

import torch

__all__ = ["gather_with_c10d_on_gloo"]

_LIB = None


def _all_gather_into_tensor(x: torch.Tensor, group_size: int, group_name: str) -> torch.Tensor:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = _resolve_process_group(group_name)
    x = x.contiguous()
    out = x.new_empty((group_size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def gather_with_c10d_on_gloo(dispatch_key: str = "CUDA") -> None:
    """Route the functional all-gather of ``dispatch_key`` tensors through
    gloo's c10d all-gather, in this process, from now on (idempotent)."""
    global _LIB
    if _LIB is not None:
        return
    import warnings

    lib = torch.library.Library("_c10d_functional", "IMPL")
    with warnings.catch_warnings():  # it replaces the op's own kernel on purpose
        warnings.simplefilter("ignore")
        lib.impl("all_gather_into_tensor", _all_gather_into_tensor, dispatch_key)
    _LIB = lib
