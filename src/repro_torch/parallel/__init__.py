"""repro_torch.parallel — device meshes and sharding rules.

``sharding`` holds both halves of the JAX package's module of the same
name: the 1-D batch mesh that ``QRServer(mesh=...)`` shards request groups
over, and the LM's rules (``MeshRules``, ``param_pspecs``, ``batch_spec``,
...) that ``train.Trainer(mesh=...)`` places ``DTensor``s by.
"""
from .sharding import (SERVE_BATCH_AXIS, BatchMesh, MeshRules, MeshShape, PartitionSpec,
                       activation_spec, add_dp_axis, batch_shard_spec, batch_spec,
                       cache_pspec, canonical_device, make_batch_mesh, map_named, mesh_axes,
                       param_pspec, param_pspecs, placements, sanitize_spec, shard_batch)

__all__ = [
    "SERVE_BATCH_AXIS",
    "BatchMesh",
    "MeshRules",
    "MeshShape",
    "PartitionSpec",
    "activation_spec",
    "add_dp_axis",
    "batch_shard_spec",
    "batch_spec",
    "cache_pspec",
    "canonical_device",
    "make_batch_mesh",
    "map_named",
    "mesh_axes",
    "param_pspec",
    "param_pspecs",
    "placements",
    "sanitize_spec",
    "shard_batch",
]
