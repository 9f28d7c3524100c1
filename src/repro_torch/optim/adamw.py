"""Minimal-state AdamW on tensor trees (f32 master math, params stay in
their own dtype)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ._tree import tree_map, zeros_f32


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict


def init(params) -> AdamWState:
    z = zeros_f32(params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32), m=z,
                      v=tree_map(torch.clone, z))


def update(
    grads,
    state: AdamWState,
    params,
    lr: float | torch.Tensor,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
):
    step = state.step + 1
    b1t = 1.0 - b1 ** step.to(torch.float32)
    b2t = 1.0 - b2 ** step.to(torch.float32)

    def upd(g, m, v, p):
        g = g.to(torch.float32)
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        mh = m2 / b1t
        vh = v2 / b2t
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m2, v2

    new_params, new_m, new_v = tree_map(upd, grads, state.m, state.v, params, n_out=3)
    return new_params, AdamWState(step=step, m=new_m, v=new_v)
