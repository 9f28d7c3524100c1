"""Maps over nested dicts (and tuples / lists) of tensors, in the order
``checkpoint.ckpt._walk`` takes their leaves — the port's ``jax.tree.map``."""
from __future__ import annotations

import torch

from repro_torch.checkpoint.ckpt import _rebuild, _walk


def tree_map(fn, tree, *rest, n_out: int = 1):
    """``fn`` over the leaves of ``tree`` and of each tree of ``rest`` (the
    same structure, else ``ValueError``): a tree shaped like ``tree``, or
    with ``n_out > 1`` (``fn`` returning that many values a leaf) a tuple of
    ``n_out`` such trees."""
    walked = [list(_walk(t)) for t in (tree, *rest)]
    paths = [p for p, _ in walked[0]]
    if any([p for p, _ in w] != paths for w in walked[1:]):
        raise ValueError("tree_map: the trees differ in structure")
    outs = [fn(*leaves) for leaves in zip(*([x for _, x in w] for w in walked))]
    if n_out == 1:
        return _rebuild(tree, iter(outs))
    return tuple(_rebuild(tree, iter([o[j] for o in outs])) for j in range(n_out))


def zeros_f32(tree):
    """An f32 zero tensor beside each leaf of ``tree``, on its device (a
    ``DTensor`` leaf's with its placements)."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32,
                                               memory_format=torch.contiguous_format), tree)
