"""repro_torch.parallel — device meshes.

``sharding`` holds the serving half of the JAX package's module of the same
name: the 1-D batch mesh that ``QRServer(mesh=...)`` shards request groups
over.
"""
from .sharding import (SERVE_BATCH_AXIS, BatchMesh, batch_shard_spec, canonical_device,
                       make_batch_mesh, shard_batch)

__all__ = [
    "SERVE_BATCH_AXIS",
    "BatchMesh",
    "batch_shard_spec",
    "canonical_device",
    "make_batch_mesh",
    "shard_batch",
]
