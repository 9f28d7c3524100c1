"""The models on a device mesh: what the LM needs to run on ``DTensor``
parameters (``train.Trainer(mesh=...)``), and nothing more.

``DTensor``'s own sharding rules carry the matmuls, norms and attention
(PyTorch's counterpart of GSPMD's propagation).  Two kinds of op need more:

- the vocab-parallel embedding lookup: ``DTensor``'s rule for an index into
  a table sharded by rows fails in the forward pass (its masked partial
  meets the next op) and in the backward (a partial sum cannot become a
  masked partial).  ``vocab_parallel_lookup`` is Megatron's: each rank
  looks up the tokens of its own vocabulary block, zeroes the rest, and the
  blocks' rows are summed over the vocabulary axis;
- the cross-entropy's ``logsumexp`` and gold-label gather over vocab-sharded
  logits: ``DTensor``'s gather yields a masked partial that the next op
  cannot take, so a chunk's loss runs on each rank's rows (``batchwise_sum``)
  with the vocabulary gathered whole;
- attention's core (``headwise``): ``DTensor``'s einsum rules cannot fold
  a batch sharded over one mesh dimension and heads sharded over another
  into one matmul batch, so the core runs on each rank's (batch, heads)
  block;
- a projection split into heads where the model axis splits a head
  (``split_heads``: GQA's few key/value heads): made whole first;
- a layer stack whose stacked dimension the rules shard (arctic's
  3-D dense-residual MLP weights take the expert rule): ``unstack``
  gathers it first (``unsharded``), as ``unbind`` has no rule there;
- the ops in ``REPLICATED_OPS``, which have no rule or whose grouping of
  tokens a sharded batch would change: they run on their inputs
  redistributed to ``Replicate()`` on every mesh dimension, their outputs
  replicated, as GSPMD runs an op it has no rule for;
- the tensor-parallel blocks' ends, placed as Megatron places them: a
  row-parallel output's partial sums are reduced into the residual
  stream's placements where they leave the block (``reduced_like``: an
  all-reduce, or with sequence parallelism a reduce-scatter), and a
  sequence split over the mesh is gathered where a block reads it, the
  gradient reduced there in the backward pass (``seq_gathered``; heads
  merged for the row-parallel product keep their gradient in placements
  the heads can be split from, ``merge_heads``).  Left to
  ``DTensor``, partial sums (of activations forward, of gradients backward)
  flow on into the next block, whose products its strategies may then run
  on the partial sums with the weights gathered whole (a model-axis-fold
  of their work), and a sequence-split input cannot be flattened into a
  product's rows;
- a decode step's write into a cache whose sequence is whole
  (``cache_write``: on each rank's block; ``index_copy_`` has no rule).

Everything here is the identity on plain tensors: one device's results keep
their bits.
"""
from __future__ import annotations

import functools

import torch

# functions of ``models`` that run replicated on a mesh (``replicated``)
REPLICATED_OPS = (
    "blocks.moe_fwd",  # MoE dispatch: routing groups and capacity span the batch
    "ssm.mamba2_fwd",  # the SSD scan and its causal convolution
    "ssm.mlstm_fwd",  # the mLSTM scan (chunked gated linear attention)
    "ssm.slstm_fwd",  # the sLSTM recurrence over time steps
)


def _dtensor_cls():
    from torch.distributed.tensor import DTensor

    return DTensor


def is_dtensor(x) -> bool:
    return isinstance(x, torch.Tensor) and isinstance(x, _dtensor_cls())


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient comes back contiguous: a ``DTensor``'s
    local tensor must have the layout its global strides describe, and the
    gradient a plain op leaves for a local input may be a strided view."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local(x):
    """This rank's block of a ``DTensor`` (differentiable, its gradient
    contiguous)."""
    return _ContiguousGrad.apply(x.to_local()) if x.requires_grad else x.to_local()


def whole(x):
    """A ``DTensor`` as the plain tensor it stands for (``Replicate()`` on
    every mesh dimension, this rank's copy; differentiable); anything else
    as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return local(x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim))


def unsharded(x, dim: int):
    """A ``DTensor`` with dimension ``dim`` whole (``Replicate()`` on each
    mesh dimension that shards it; differentiable); anything else as it
    is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim %= x.ndim
    place = [Replicate() if p in (Shard(dim), Shard(dim - x.ndim)) else p for p in x.placements]
    return x if place == list(x.placements) else x.redistribute(x.device_mesh, place)


def split_heads(x, n_heads: int, head_dim: int):
    """``x`` (..., n_heads·head_dim) as (..., n_heads, head_dim).  A
    ``DTensor`` whose last dimension is split over more blocks than
    ``n_heads`` divides into (a block would hold part of a head) is made
    whole along it first, as ``DTensor`` cannot unflatten it."""
    if is_dtensor(x):
        from torch.distributed.tensor import Shard

        last = x.ndim - 1
        blocks = 1
        for i, p in enumerate(x.placements):
            if p in (Shard(last), Shard(-1)):
                blocks *= x.device_mesh.size(i)
        if n_heads % blocks:
            x = unsharded(x, -1)
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


def batchwise_sum(fn):
    """``fn(*tensors)``, a sum over rows that are independent along dim 0 (the
    batch), run on each rank's rows: every other dimension of each input is
    made whole, dim 0 stays split over the mesh dimensions where all inputs
    split it, and the 0-d result is a partial sum over those (``Partial()``),
    replicated over the rest.  With no ``DTensor`` argument, ``fn`` itself."""

    @functools.wraps(fn)
    def run(*args):
        if not any(is_dtensor(x) for x in args):
            return fn(*args)
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        mesh = next(x.device_mesh for x in args if is_dtensor(x))
        args = [x if is_dtensor(x) else DTensor.from_local(
            x, mesh, [Replicate()] * mesh.ndim, run_check=False) for x in args]
        split = [all(x.placements[i] == Shard(0) for x in args) for i in range(mesh.ndim)]
        place = [Shard(0) if s else Replicate() for s in split]
        args = [x if list(x.placements) == place else x.redistribute(mesh, place) for x in args]
        out = fn(*(local(x) for x in args))
        return DTensor.from_local(out, mesh, [Partial() if s else Replicate() for s in split],
                                  run_check=False)

    return run


def headwise(fn):
    """``fn(q, k, v, *rest)``, an attention core that is independent across
    the batch (dim 0) and the heads (dim 2), run on each rank's block: q, k
    and v keep ``Shard(0)`` and ``Shard(2)`` where all three agree (and each
    rank's block of query heads reads its own block of key/value heads),
    anything else is made whole first; the output, shaped like q, comes back
    with q's placements.  ``DTensor``'s own einsum rules cannot flatten two
    sharded dimensions into one batch dimension of a matmul.  With no
    ``DTensor`` among q, k, v, ``fn`` itself."""

    @functools.wraps(fn)
    def run(q, k, v, *rest):
        if not any(is_dtensor(x) for x in (q, k, v)):
            return fn(q, k, v, *rest)
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh = next(x.device_mesh for x in (q, k, v) if is_dtensor(x))
        if not all(is_dtensor(x) for x in (q, k, v)):
            q, k, v = (x if is_dtensor(x) else DTensor.from_local(
                x, mesh, [Replicate()] * mesh.ndim, run_check=False) for x in (q, k, v))
        place = []
        for i in range(mesh.ndim):
            ps = {x.placements[i] for x in (q, k, v)}
            ok = (len(ps) == 1 and ps <= {Shard(0), Shard(2)}
                  and (ps != {Shard(2)} or k.shape[2] % mesh.size(i) == 0))
            place.append(ps.pop() if ok else Replicate())
        q, k, v = (x if list(x.placements) == place else x.redistribute(mesh, place)
                   for x in (q, k, v))
        out = fn(local(q), local(k), local(v), *rest)
        return DTensor.from_local(out, mesh, place, run_check=False)

    return run


def replicated(fn):
    """``fn`` run on its arguments made whole (``whole``), each tensor it
    returns replicated over the mesh of the first ``DTensor`` argument.
    With no ``DTensor`` among the arguments, ``fn`` itself."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        mesh = next((x.device_mesh for x in _leaves((args, kwargs)) if is_dtensor(x)), None)
        if mesh is None:
            return fn(*args, **kwargs)
        from torch.distributed.tensor import DTensor, Replicate

        out = fn(*_map(whole, args), **_map(whole, kwargs))
        rep = [Replicate()] * mesh.ndim
        return _map(lambda t: DTensor.from_local(t, mesh, rep, run_check=False)
                    if isinstance(t, torch.Tensor) else t, out)

    return run


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over ``group`` in the forward pass, the identity in
    the backward: the output is replicated over the group, so each rank's
    gradient is already the whole gradient (Megatron's "g" operator)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def vocab_parallel_lookup(table, tokens):
    """``table[tokens]`` for a ``DTensor`` table whose rows (the vocabulary)
    are sharded over one mesh dimension, as Megatron looks up a
    vocab-parallel embedding.  ``tokens`` is a ``DTensor`` (or a plain tensor,
    replicated) whose placements are ``Shard(0)`` (the batch) or
    ``Replicate()``; the rows come back as a ``DTensor`` with the tokens'
    placements.  The table's gradient is this rank's block: a partial sum
    over the mesh dimensions that shard the batch."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    vocab_dims = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    if len(vocab_dims) > 1:
        raise NotImplementedError(f"vocab_parallel_lookup: rows sharded over {len(vocab_dims)} "
                                  "mesh dimensions; one is supported")
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    tok_place = [p if p in (Shard(0), Replicate()) else Replicate() for p in tokens.placements]
    for i in vocab_dims:
        tok_place[i] = Replicate()  # every rank of the vocabulary axis sees the same tokens
    if list(tokens.placements) != tok_place:
        tokens = tokens.redistribute(mesh, tok_place)
    # the table sharded by rows only; its gradient is partial where the batch is split
    tab_place = [Shard(0) if i in vocab_dims else Replicate() for i in range(mesh.ndim)]
    if list(table.placements) != tab_place:
        table = table.redistribute(mesh, tab_place)
    grad_place = [Shard(0) if i in vocab_dims
                  else Partial() if tok_place[i] == Shard(0) else Replicate()
                  for i in range(mesh.ndim)]
    local = table.to_local(grad_placements=grad_place)
    tok = tokens.to_local()
    if vocab_dims:
        (dim,) = vocab_dims
        lo = mesh.get_local_rank(dim) * local.shape[0]
        mask = (tok >= lo) & (tok < lo + local.shape[0])
        rows = torch.where(mask[..., None], local[torch.where(mask, tok - lo, 0)], 0.0)
        if mesh.size(dim) > 1:
            rows = _SumOver.apply(rows, mesh.get_group(dim))
    else:
        rows = local[tok]
    return DTensor.from_local(rows, mesh, tok_place, run_check=False)


class _Reduce(torch.autograd.Function):
    """Partial sums reduced into ``place`` in the forward pass; in the
    backward the gradient as it comes (Megatron's "g" operator: the
    gradient of a sum is each term's), placed as the partial sums were with
    each ``Partial()`` replicated.  ``DTensor``'s own backward of the
    reduction leaves the gradient partial, and the row-parallel product's
    backward then runs on partial sums with its weight gathered whole.
    With sequence parallelism the gradient comes back split along the
    sequence, and the product's backward flattens (batch, sequence) into
    rows, which torch 2.11's ``DTensor`` refuses on a split sequence: it is
    gathered here (the all-gather that is a reduce-scatter's backward)."""

    @staticmethod
    def forward(ctx, y, place):
        from torch.distributed.tensor import Partial, Replicate

        ctx.place = tuple(Replicate() if isinstance(p, Partial) else p for p in y.placements)
        return y.redistribute(y.device_mesh, place)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.place:
            g = g.redistribute(g.device_mesh, ctx.place)
        return g, None


def reduced_like(y, like):
    """A block's output ``y`` whose partial sums (``Partial()`` placements,
    a row-parallel product's) are reduced into the placements of ``like``,
    the residual stream the block read; anything else as it is."""
    if not is_dtensor(y):
        return y
    from torch.distributed.tensor import Partial, Replicate

    if not any(isinstance(p, Partial) for p in y.placements):
        return y
    # a stream itself partial (a norm's mean over a dimension the model axis
    # splits) takes the sums whole
    return _Reduce.apply(y, tuple(Replicate() if isinstance(p, Partial) else p
                                  for p in like.placements))


class _Read(torch.autograd.Function):
    """``x`` in ``place`` in the forward pass (a gather, or nothing); in the
    backward the gradient reduced into ``x``'s own placements (Megatron's
    "f" operator: the column-parallel products leave the gradient of their
    input partial, and the reduction belongs here, before it flows on)."""

    @staticmethod
    def forward(ctx, x, place):
        ctx.place = x.placements
        return x.view_as(x) if tuple(x.placements) == place else x.redistribute(
            x.device_mesh, place)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != tuple(ctx.place):
            g = g.redistribute(g.device_mesh, ctx.place)
        return g, None


def merge_heads(x):
    """``x`` (..., H, D) as (..., H·D).  A ``DTensor``'s gradient comes back
    in the merged tensor's own placements: a row-parallel product's
    backward splits it over the model axis, finer than the heads where they
    do not divide that axis, and ``DTensor`` cannot split such a gradient
    back into heads."""
    flat = x.reshape(*x.shape[:-2], -1)
    return _Read.apply(flat, tuple(flat.placements)) if is_dtensor(flat) else flat


def seq_gathered(x):
    """A (B, S, ...) ``DTensor`` block input with its sequence dimension
    (1) whole (sequence parallelism's all-gather), its gradient reduced into
    its own placements in the backward pass; anything else as it is."""
    if not (is_dtensor(x) and x.ndim >= 3):
        return x
    from torch.distributed.tensor import Partial, Replicate, Shard

    if any(isinstance(p, Partial) for p in x.placements):
        return unsharded(x, 1)  # no gradient can be reduced into partial sums
    place = tuple(Replicate() if p in (Shard(1), Shard(1 - x.ndim)) else p
                  for p in x.placements)
    return _Read.apply(x, place)


def cache_write(cache, new, index) -> None:
    """``cache.index_copy_(1, index, new)`` for a ``DTensor`` cache (B, S,
    ...) with ``index`` one slot: each rank writes its own block, ``new``
    placed as the cache is.  A cache split along the sequence (a long
    context whose batch does not divide the data axes) is written masked:
    each rank takes the slot's place in its block, clamped into it, and
    writes the new row there where the slot lies in the block and the old
    row back where it does not, as the reference's dynamic-update-slice
    writes one block of a sharded cache.  Tensor ops only, with no read of
    ``index`` on the host, so it runs on meta tensors too."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    seq = (Shard(1), Shard(1 - cache.ndim))
    place = [Replicate() if p in seq else p for p in cache.placements]
    if list(new.placements) != place:
        new = new.redistribute(cache.device_mesh, place)
    block, row = cache.to_local(), new.to_local()
    if len(place) == len(cache.placements) and place == list(cache.placements):
        block.index_copy_(1, index, row)
        return
    _, offset = compute_local_shape_and_global_offset(cache.shape, cache.device_mesh,
                                                      cache.placements)
    at = index - offset[1]
    slot = at.clamp(0, max(block.shape[1] - 1, 0))
    if block.shape[1] == 0:
        return
    inside = ((at >= 0) & (at < block.shape[1])).reshape(1, 1, *[1] * (block.ndim - 2))
    block.index_copy_(1, slot, torch.where(inside, row, block.index_select(1, slot)))
