"""Training meshes: ``torch.distributed`` ``DeviceMesh``es with the JAX
package's shapes and axis names (functions, not constants — importing this
module touches no process group).

A mesh spans the default process group, one rank a mesh position: its
shape's product must equal the world size.  ``repro_torch.launch.train
--mesh DxM`` starts the ranks of a debug mesh on one host (or joins the
group ``torchrun`` started); the production meshes' 256 and 512 ranks span
many hosts.  ``parallel.MeshShape`` gives their rules with no ranks at all.
"""
from __future__ import annotations

import math

__all__ = ["PRODUCTION_SHAPES", "make_debug_mesh", "make_production_mesh", "make_mesh"]

# (shape, axis names) of the production meshes: one pod, and two
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group.  ``ValueError`` naming both the ranks the shape needs and
    the ranks there are when no group is initialized or its world size is
    another."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(shape), tuple(axes)
    need = math.prod(shape)
    name = "x".join(map(str, shape))
    have = dist.get_world_size() if dist.is_available() and dist.is_initialized() else None
    if have != need:
        where = ("no process group is initialized" if have is None
                 else f"the process group has {have}")
        raise ValueError(f"a {name} mesh {axes} needs {need} ranks, one a mesh position, "
                         f"and {where}; start them with torchrun or "
                         f"`python -m repro_torch.launch.train --mesh {name}` (which "
                         "forms at most one rank a CPU core on one host)")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 = 256 ranks a pod; multi_pod adds the 2-pod axis (512 ranks).
    No single host forms either: the ranks come from a multi-host launch."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_mesh(shape, axes, device_type)


def make_debug_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A (data, model) mesh of ``data * model`` ranks for tests and one-host
    runs."""
    return make_mesh((data, model), ("data", "model"), device_type)
