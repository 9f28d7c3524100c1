"""Sharding for the serving path: a 1-D batch mesh of devices.

The solver front-door shards micro-batched request groups over a 1-D batch
axis: a flushed group is zero-padded so every shard gets the same number of
problems, split into contiguous slices (one per device of the mesh), each
slice runs the single-device batched function on its device, and the results
are gathered in order on the device the batch was stacked on.  One process
drives every shard, as the JAX package's ``shard_map`` dispatch does.

A ``BatchMesh`` may name one device several times: four shards on one card
(or on the host) run the sharded path, slice by slice, without four devices.
``make_batch_mesh(N, device="cpu")`` builds such a mesh on the host, the
counterpart of the JAX package's forced host device count.

The LM half of the reference module (``MeshRules``, parameter and activation
specs) is not part of this module.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["SERVE_BATCH_AXIS", "BatchMesh", "batch_shard_spec", "canonical_device",
           "make_batch_mesh", "shard_batch"]

SERVE_BATCH_AXIS = "batch"


def canonical_device(device) -> torch.device:
    """``torch.device`` with the index of a bare ``"cuda"`` filled in (the
    current card), so two names of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class BatchMesh:
    """A 1-D mesh: the devices of the shards, in order, and the axis name.

    Frozen and hashable, so it keys executor caches.  ``shape`` maps the axis
    to the shard count (``mesh.shape[axis]``, as a JAX mesh reads); an axis
    the mesh lacks raises ``KeyError``.
    """

    devices: tuple
    axis: str = SERVE_BATCH_AXIS

    def __post_init__(self):
        devices = tuple(canonical_device(d) for d in self.devices)
        if not devices:
            raise ValueError("a batch mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}


def make_batch_mesh(num_devices: int | None = None, axis: str = SERVE_BATCH_AXIS,
                    device="cuda") -> BatchMesh:
    """1-D mesh for sharded batch serving (``QRServer(mesh=...)``).

    On ``"cuda"`` it takes ``num_devices`` distinct cards (``None``: every
    visible card) and raises ``ValueError`` when fewer are visible.  On
    ``"cpu"`` it returns ``num_devices`` shards on the host (``None``: one).
    Flushed request groups are padded to a multiple of ``shards x block_b``
    and split over ``axis`` — see
    ``repro_torch.solvers.qr_update.qr_append_rows_batched``.
    """
    dev = torch.device(device)
    if dev.type == "cpu":
        n = 1 if num_devices is None else num_devices
        devices = (torch.device("cpu"),) * n
    elif dev.type == "cuda":
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = avail if num_devices is None else num_devices
        if n > avail:
            raise ValueError(f"requested a {n}-device batch mesh but only {avail} "
                             "devices are visible")
        devices = tuple(torch.device("cuda", i) for i in range(n))
    else:
        raise ValueError(f"unsupported device type {dev.type!r} for a batch mesh")
    if n < 1:
        raise ValueError(f"a batch mesh needs at least one device, got {n}")
    return BatchMesh(devices, axis)


def batch_shard_spec(ndim: int, axis: str = SERVE_BATCH_AXIS) -> tuple:
    """Per-dimension placement of a stacked batch: dim 0 (the stacked-request
    dim) split over ``axis``, every other dim whole (``None``) — the
    reference's ``PartitionSpec(axis, None, ...)`` as a tuple."""
    return (axis,) + (None,) * (ndim - 1)


def shard_batch(fn, mesh: BatchMesh, axis: str = SERVE_BATCH_AXIS):
    """``fn`` mapped over the shards of ``mesh``'s ``axis``.

    The returned callable takes tensors whose dim 0 is the batch (a multiple
    of the shard count; callers pad first), splits each into contiguous
    slices, runs ``fn`` on each slice on its shard's device, and gathers each
    output (a tensor or a tuple of tensors) in shard order on the device of
    the first argument.  ``fn`` sees exactly what the single-device path
    would for that slice, so a per-problem function gives the same bits
    sharded as alone.
    """
    shards = mesh.shape[axis]

    def sharded(*args):
        home = args[0].device
        B = args[0].shape[0]
        if B % shards or any(a.shape[0] != B for a in args):
            raise ValueError(f"sharded batch of {[a.shape[0] for a in args]} over "
                             f"{shards} shards: pad dim 0 to a common multiple first")
        per = B // shards
        outs = [fn(*(a[i * per:(i + 1) * per].to(dev) for a in args))
                for i, dev in enumerate(mesh.devices)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat([o[j].to(home) for o in outs])
                         for j in range(len(outs[0])))
        return torch.cat([o.to(home) for o in outs])

    return sharded
