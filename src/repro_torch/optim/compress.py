"""Gradient compression for cross-pod all-reduce: error-feedback int8.

Where a gradient all-reduce crosses a slow network, int8 quantization with
error feedback cuts those bytes 4x with no asymptotic loss in convergence
(the residual is replayed into the next step).  The quantize / dequantize
pair models the information loss of the int8 payload, and the residual
carries the quantization error to the next step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.checkpoint.ckpt import _walk

from ._tree import tree_map, zeros_f32


class EFState(NamedTuple):
    residual: dict  # error-feedback residual per parameter


def init(params) -> EFState:
    return EFState(residual=zeros_f32(params))


def quantize(x: torch.Tensor):
    """Symmetric per-tensor int8; returns (q, scale).  Rounds half to even,
    as ``jnp.round`` does."""
    xf = x.to(torch.float32)
    scale = xf.abs().max() / 127.0 + 1e-30
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads, state: EFState):
    """Apply the error-feedback int8 round trip to a gradient tree.

    Returns (compressed_grads, new_state): the gradients as the int8 payload
    gives them back, and the residual the round trip lost.
    """

    def one(g, r):
        gf = g.to(torch.float32) + r
        q, s = quantize(gf)
        gq = dequantize(q, s)
        return gq.to(g.dtype), gf - gq

    gq, res = tree_map(one, grads, state.residual, n_out=2)
    return gq, EFState(residual=res)


def compressed_bytes(params) -> int:
    """Bytes on the wire per step with int8 payload (+4-byte scale/tensor)."""
    return sum(leaf.numel() + 4 for _, leaf in _walk(params))
