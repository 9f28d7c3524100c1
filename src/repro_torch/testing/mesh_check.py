"""Checks of ``Trainer(mesh=...)`` runs: their state as global arrays, the
replicas' bits across ranks, and steps held by ``step_check``'s rule.

    from repro_torch.testing.mesh_check import UniformBatches, flat_global

The CPU tests and ``chip_smoke.py`` hold mesh runs to one-device runs with
these.  ``flat_global`` and ``block_digests`` run on every rank of a mesh
(``flat_global`` gathers); the rest are plain functions of their results.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import _walk
from repro_torch.testing.step_check import step_gaps

__all__ = ["UniformBatches", "block_digests", "flat_global", "held_per_step",
           "replicas_differ", "split_state"]


class UniformBatches:
    """A Trainer's ``data``: batch ``step`` is (batch, seq + 1) tokens drawn
    uniformly from the vocabulary by a numpy generator seeded with ``seed +
    step``.  Where a step has more tokens than a weight's narrow width, its
    one-step gradient has full rank but for LayerNorm's null vector, which
    ``step_check.leading_columns`` expects; the Trainer's own stream (a slow
    random walk) leaves it rank-deficient, with directions that roundoff
    sets."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 1000):
        self.vocab, self.seq_len, self.batch, self.seed = vocab, seq_len, batch, seed

    def batch_at(self, step, device="cuda") -> dict:
        rng = np.random.default_rng(self.seed + int(step))
        toks = rng.integers(0, self.vocab, (self.batch, self.seq_len + 1)).astype(np.int32)
        toks = torch.as_tensor(toks).to(device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def state(self, step) -> dict:
        return {"seed": self.seed, "step": int(step)}


def flat_global(tree) -> dict:
    """{path: numpy} of a tree, a ``DTensor`` leaf as its global array (a
    collective: every rank of its mesh calls it)."""
    from torch.distributed.tensor import DTensor

    return {"/".join(p): (x.full_tensor() if isinstance(x, DTensor) else x).detach().cpu().numpy()
            for p, x in _walk(tree)}


def block_digests(tree, replicated_only: bool = False) -> dict:
    """{path: (which mesh dimensions shard it, this rank's coordinate, sha1
    of this rank's block)} of each ``DTensor`` leaf (``replicated_only``:
    of each leaf that some other rank holds a copy of)."""
    from torch.distributed.tensor import DTensor, Shard

    out = {}
    for p, x in _walk(tree):
        if isinstance(x, DTensor):
            if replicated_only and all(isinstance(q, Shard) or x.device_mesh.size(i) == 1
                                       for i, q in enumerate(x.placements)):
                continue
            local = x.to_local().detach().contiguous().cpu().numpy()
            out["/".join(p)] = (tuple(isinstance(q, Shard) for q in x.placements),
                                tuple(x.device_mesh.get_coordinate()),
                                hashlib.sha1(local.tobytes()).hexdigest())
    return out


def replicas_differ(seen: list) -> list:
    """(step, path) of every leaf whose copies differ, from each rank's list
    of ``block_digests`` (one a step): ranks at the same coordinates on the
    mesh dimensions that shard a leaf hold the same block, and must hold the
    same bits."""
    bad = []
    for i in range(len(seen[0])):
        for path in seen[0][i]:
            groups = {}
            for rank_seen in seen:
                sharded, coord, sha = rank_seen[i][path]
                key = tuple(c for c, s in zip(coord, sharded) if s)
                groups.setdefault(key, set()).add(sha)
            bad += [(i + 1, path) for shas in groups.values() if len(shas) > 1]
    return bad


def split_state(state: dict) -> tuple:
    """({leaf: param}, {state path: leaf}) of a flattened ``{"params": ...,
    "opt": ...}`` tree."""
    return ({k[len("params/"):]: v for k, v in state.items() if k.startswith("params/")},
            {k[len("opt/"):]: v for k, v in state.items() if k.startswith("opt/")})


def held_per_step(start: dict, got: dict, want: dict, lr: float, optimizer: str) -> list:
    """[(step, ``step_gaps``)] of each step of ``got`` against ``want``
    ({step: flattened state}, both from the parameters ``start``): each
    step's update from that run's own parameters before it, over the
    elements ``want``'s step determines, and the state after it."""
    out = []
    before = got_before = start
    for step in sorted(want):
        (gp, gs), (wp, ws) = split_state(got[step]), split_state(want[step])
        shifted = {k: v - (got_before[k] - before[k]) for k, v in gp.items()}
        out.append((step, step_gaps(before, (shifted, gs), (wp, ws), lr, optimizer)))
        before, got_before = wp, gp
    return out
