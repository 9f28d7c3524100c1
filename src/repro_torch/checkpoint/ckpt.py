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
  leaf's dtype.  Restoring onto a sharded layout (the JAX package's
  ``shardings=``) waits for the port's distributed paths.
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


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    return {"/".join(path): _host(leaf) for path, leaf in _walk(tree)}


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(tree)
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


def restore(ckpt_dir: str, step: int, like, shardings=None):
    """Restore into the structure of ``like``: each leaf becomes a tensor on
    the device of ``like``'s leaf, with that leaf's dtype.  Returns
    ``(tree, extra)``."""
    if shardings is not None:
        raise NotImplementedError(
            "restore(shardings=...) places leaves on a device mesh; the port's "
            "distributed paths are not ported yet")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    pairs = [("/".join(p), leaf) for p, leaf in _walk(like)]
    if sorted(k for k, _ in pairs) != manifest["keys"]:
        raise ValueError(
            f"checkpoint/structure mismatch: {path} holds {manifest['keys']}, "
            f"like has {sorted(k for k, _ in pairs)}")
    with np.load(os.path.join(path, "leaves.npz")) as data:
        out = []
        for key, leaf in pairs:
            if isinstance(leaf, torch.Tensor):
                out.append(torch.as_tensor(data[key]).to(device=leaf.device,
                                                         dtype=leaf.dtype))
            else:
                out.append(torch.as_tensor(data[key].astype(np.asarray(leaf).dtype)))
    return _rebuild(like, iter(out)), manifest["extra"]
