"""Fault-tolerant checkpointing: atomic step-tagged saves.

* atomicity — write to ``<dir>/tmp.<step>``, fsync the manifest, then
  ``os.rename`` to ``step_<n>`` (rename is atomic on POSIX); a crashed save
  never shadows the previous good checkpoint.
* one format for both packages — leaves are saved host-side as
  ``leaves.npz`` keyed by their tree paths, spelled as the JAX package spells
  them (a named-tuple field ``.R``, a dict key or a sequence index as its
  ``str``, nested paths joined by ``/``; ``None`` holds no leaf), beside a
  ``manifest.json`` with the sorted keys and the caller's ``extra`` dict.  A
  snapshot written by either package restores in the other.
* ``restore`` places each leaf on the device of ``like``'s leaf, with that
  leaf's dtype.  With ``shardings=`` (a tree shaped like ``like`` of
  ``torch.distributed.tensor.Shard(dim)`` / ``Replicate()`` / ``None``) each
  rank of the default process group keeps its contiguous block of a sharded
  leaf — the shard ``jax.device_put(arr, NamedSharding(mesh, P(...)))`` gives
  device r — as a plain tensor, so a job resumes on another number of ranks.
  A ``(DeviceMesh, placements)`` leaf of ``shardings`` (the counterpart of a
  ``NamedSharding``) gives a ``DTensor`` holding this rank's block.
* a ``DTensor`` leaf is saved as its global array: every rank gathers it
  (``full_tensor``), rank 0 writes, and all ranks meet at a barrier of the
  default process group after the publish, so a snapshot taken on a mesh
  restores on any other mesh, without one, and in the JAX package.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

__all__ = ["latest_step", "restore", "save"]


def _walk(tree, path: tuple = ()):
    """``(path, leaf)`` pairs in the JAX package's flattening order: named
    tuples by field, sequences by index, dicts by sorted key."""
    if tree is None:
        return
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _walk(v, path + (f".{name}",))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    else:
        yield path, tree


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, leaves) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    if isinstance(tree, dict):
        # values in sorted-key order (the order ``_walk`` took them), keys
        # back in the caller's order
        done = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    return next(leaves)


def _is_dtensor(leaf) -> bool:
    if not isinstance(leaf, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def _host(leaf) -> np.ndarray:
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    return {"/".join(path): _host(leaf) for path, leaf in _walk(tree)}


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    """Publish ``tree`` as ``<ckpt_dir>/step_<step>``; returns its path.  A
    tree with ``DTensor`` leaves is a collective of the default process
    group: call it on every rank."""
    if any(_is_dtensor(leaf) for _, leaf in _walk(tree)):
        import torch.distributed as dist

        flat = _flatten(tree)  # every rank takes part in each gather
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if dist.get_rank() == 0:
            _publish(ckpt_dir, step, flat, extra)
        dist.barrier()
        return final
    return _publish(ckpt_dir, step, _flatten(tree), extra)


def _publish(ckpt_dir: str, step: int, flat: dict, extra: dict | None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "leaves.npz"), **flat)
    manifest = {"step": step, "keys": sorted(flat), "extra": extra or {}}
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))
    ]
    return max(steps) if steps else None


def _placements(like, shardings):
    """One placement per leaf of ``like``, in ``_walk``'s order: the leaf of
    ``shardings`` at the same path, or the placement (``None`` replicates)
    that ``shardings`` holds over the subtree around it."""
    tree = (tuple, list, dict)
    on_mesh = (isinstance(shardings, tuple) and len(shardings) == 2
               and hasattr(shardings[0], "mesh_dim_names"))
    if on_mesh or not (isinstance(like, tree) and isinstance(shardings, tree)):
        yield from (shardings for _ in _walk(like))
    elif isinstance(like, dict):
        for k in sorted(like):
            yield from _placements(like[k], shardings[k])
    else:
        for v, s in zip(like, shardings, strict=True):
            yield from _placements(v, s)


def _mesh_block(arr: np.ndarray, mesh, places) -> np.ndarray:
    """This rank's block of ``arr`` on ``mesh`` under ``places`` (one
    placement a mesh dimension): each ``Shard(d)`` splits dimension d
    evenly, the mesh's earlier dimensions major, as ``DTensor`` does."""
    from torch.distributed.tensor import Replicate, Shard

    for i, p in enumerate(places):
        if isinstance(p, Shard):
            arr = _local_block(arr, p, mesh.size(i), mesh.get_local_rank(i))
        elif not isinstance(p, Replicate):
            raise ValueError(f"restore: unsupported placement {p!r}")
    return arr


def _local_block(arr: np.ndarray, placement, world: int, rank: int) -> np.ndarray:
    """This rank's block of ``arr`` under ``placement``."""
    from torch.distributed.tensor import Replicate, Shard

    if placement is None or isinstance(placement, Replicate):
        return arr
    if not isinstance(placement, Shard):
        raise ValueError(f"restore: unsupported placement {placement!r}")
    dim = placement.dim % arr.ndim
    if arr.shape[dim] % world:
        raise ValueError(f"restore: dimension {dim} of a {arr.shape} leaf does not "
                         f"split evenly over {world} ranks")
    size = arr.shape[dim] // world
    return np.take(arr, range(rank * size, (rank + 1) * size), axis=dim)


def restore(ckpt_dir: str, step: int, like, shardings=None):
    """Restore into the structure of ``like``: each leaf becomes a tensor on
    the device of ``like``'s leaf, with that leaf's dtype.  Returns
    ``(tree, extra)``.

    ``shardings`` (optional) is a tree shaped like ``like`` whose leaves are
    ``Shard(dim)``, ``Replicate()`` or ``None`` (replicated), over the default
    process group: rank r gets the r-th contiguous block of a sharded leaf's
    ``dim`` (``ValueError`` if it does not split evenly), as a plain tensor.
    A leaf ``(mesh, placements)`` (a ``DeviceMesh`` and one placement a mesh
    dimension) gives a ``DTensor`` of this rank's block instead.
    """
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    pairs = [("/".join(p), leaf) for p, leaf in _walk(like)]
    if sorted(k for k, _ in pairs) != manifest["keys"]:
        raise ValueError(
            f"checkpoint/structure mismatch: {path} holds {manifest['keys']}, "
            f"like has {sorted(k for k, _ in pairs)}")
    if shardings is None:
        places, world, rank = [None] * len(pairs), 1, 0
    else:
        import torch.distributed as dist

        if not dist.is_initialized():
            raise ValueError("restore(shardings=...) places leaves over the default "
                             "process group, which is not initialized")
        places = list(_placements(like, shardings))
        world, rank = dist.get_world_size(), dist.get_rank()
    with np.load(os.path.join(path, "leaves.npz")) as data:
        out = []
        for (key, leaf), place in zip(pairs, places):
            if isinstance(place, tuple):
                from torch.distributed.tensor import DTensor

                mesh, mplaces = place
                local = torch.as_tensor(_mesh_block(data[key], mesh, mplaces)).to(
                    device=leaf.device, dtype=leaf.dtype)
                out.append(DTensor.from_local(local, mesh, mplaces, run_check=False))
                continue
            arr = _local_block(data[key], place, world, rank)
            if isinstance(leaf, torch.Tensor):
                out.append(torch.as_tensor(arr).to(device=leaf.device, dtype=leaf.dtype))
            else:
                out.append(torch.as_tensor(arr.astype(np.asarray(leaf).dtype)))
    return _rebuild(like, iter(out)), manifest["extra"]
