"""Meta-tensor ``DTensor`` stand-ins for every model input: global shape and
dtype, placed on a mesh by the sharding rules, with nothing allocated.  The
dry run (``launch.dryrun``) runs a step against these.

The JAX package's ``launch/specs.py``, where a ``ShapeDtypeStruct`` with a
``NamedSharding`` becomes a ``DTensor`` over a ``DeviceMesh`` whose local
tensor is on the ``meta`` device: each rank's block has the shape the
placements give it and no storage.  ``spec_of`` reads a leaf's placements
back as the ``PartitionSpec`` they stand for.  A 0-d leaf (the optimizer's
step count, decode's position) is a plain meta tensor, whole on every rank,
as ``train.Trainer`` keeps it.
"""
from __future__ import annotations

import torch

from repro_torch.models import serve
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.parallel import (MeshRules, PartitionSpec as P, add_dp_axis, batch_spec,
                                  cache_pspec, map_named, mesh_axes, param_pspec,
                                  placements, sanitize_spec)

__all__ = ["batch_specs", "decode_specs", "local_nbytes", "meta_dtensor", "opt_specs",
           "param_specs", "spec_of"]


def meta_dtensor(shape, dtype, spec, mesh):
    """A ``DTensor`` of global ``shape`` and ``dtype`` placed by ``spec`` on
    ``mesh``, its local block a meta tensor (nothing allocated).  A 0-d
    ``shape`` gives a plain meta tensor.  ``spec`` must divide ``shape``
    (``sanitize_spec``)."""
    shape = tuple(shape)
    if not shape:
        return torch.empty((), dtype=dtype, device="meta")
    from torch.distributed.tensor import DTensor, Shard

    place = placements(spec, mesh)
    local = list(shape)
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            if local[p.dim] % mesh.size(i):
                raise ValueError(f"spec {spec!r} does not divide {shape}")
            local[p.dim] //= mesh.size(i)
    block = torch.empty(local, dtype=dtype, device="meta")
    stride = torch.empty(shape, dtype=dtype, device="meta").stride()
    return DTensor.from_local(block, mesh, place, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def spec_of(x) -> P:
    """The ``PartitionSpec`` a leaf's placements stand for, one entry a
    dimension (a plain tensor: whole, ``P()``)."""
    from repro_torch.models.mesh_ops import is_dtensor

    if not is_dtensor(x):
        return P()
    from torch.distributed.tensor import Shard

    names = list(mesh_axes(x.device_mesh))
    entries = [[] for _ in range(x.ndim)]
    for axis, p in zip(names, x.placements):
        if isinstance(p, Shard):
            entries[p.dim % x.ndim].append(axis)
    return P(*(None if not e else e[0] if len(e) == 1 else tuple(e) for e in entries))


def local_nbytes(tree) -> int:
    """Bytes of this rank's blocks of every tensor leaf of ``tree`` (a
    ``DTensor``'s local tensor, a plain tensor whole)."""
    from repro_torch.models.mesh_ops import is_dtensor

    total = 0

    def add(_, x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            t = x.to_local() if is_dtensor(x) else x
            total += t.numel() * t.element_size()
        return x

    map_named(add, tree)
    return total


def _placed(rules: MeshRules, kind: str, shape, dtype):
    spec = sanitize_spec(batch_spec(kind, rules), shape, rules.mesh)
    return meta_dtensor(shape, dtype, spec, rules.mesh)


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, rules: MeshRules) -> dict:
    """Input specs for a train/prefill step: the token batch (+ modality
    frontend stubs: precomputed patch/frame embeddings)."""
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": _placed(rules, "tokens", (B, S), torch.int32),
           "labels": _placed(rules, "labels", (B, S), torch.int32)}
    if cfg.family == "vlm":
        out["patch_embs"] = _placed(rules, "patch_embs", (B, cfg.n_patches, cfg.vision_dim),
                                    torch.float32)
    if cfg.family == "encdec":
        out["frames"] = _placed(rules, "frames", (B, S // cfg.enc_downsample, cfg.d_model),
                                torch.float32)
    return out


def decode_specs(cfg: ArchConfig, shape: ShapeConfig, rules: MeshRules):
    """(cache, token, pos) specs for one ``decode_step`` token."""
    B, S = shape.global_batch, shape.seq_len
    mesh = rules.mesh
    spec_fn = cache_pspec(cfg, rules, B)
    cache = {name: meta_dtensor(s.shape, s.dtype, spec_fn(name, s), mesh)
             for name, s in serve.cache_spec(cfg, B, S).items()}
    tok_spec = P(rules._dp()) if B % rules.dp_size == 0 else P()
    token = meta_dtensor((B,), torch.int32, tok_spec, mesh)
    pos = torch.empty((), dtype=torch.int32, device="meta")
    return cache, token, pos


def param_specs(cfg: ArchConfig, rules: MeshRules) -> dict:
    """The parameter tree as placed meta ``DTensor``s: drawn by ``init_lm`` /
    ``init_encdec`` on the meta device (shapes only), placed by
    ``param_pspec``."""
    from repro_torch.models import encdec as encdec_mod
    from repro_torch.models import transformer as tmod

    init = encdec_mod.init_encdec if cfg.family == "encdec" else tmod.init_lm
    shapes = init(cfg, torch.Generator(), device="meta")
    return map_named(lambda name, s: meta_dtensor(s.shape, s.dtype,
                                                  param_pspec(name, s, cfg, rules), rules.mesh),
                     shapes)


def opt_specs(params, cfg: ArchConfig, rules: MeshRules, opt_init, zero1: bool = False):
    """Optimizer-state specs: ``opt_init`` over the meta parameters, each
    leaf placed by the same name-based rules; ``zero1`` additionally shards
    the moments over the data axes (ZeRO-1, ``add_dp_axis``): the update runs
    on 1/DP of each moment and the refreshed parameters are gathered back to
    their own placements."""
    state = opt_init(params)

    def place(name, s):
        if s.ndim == 0:
            return meta_dtensor((), s.dtype, P(), rules.mesh)
        spec = param_pspec(name, s, cfg, rules)
        if zero1:
            spec = add_dp_axis(spec, s.shape, rules)
        return meta_dtensor(s.shape, s.dtype, spec, rules.mesh)

    return map_named(place, state)

