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

The LM half: Megatron-style tensor parallelism assigned by parameter name
(column-parallel up projections, row-parallel down projections,
vocab-parallel embeddings, expert-parallel MoE weights), data parallelism
over (pod, data), and the reference's optional sequence parallelism for
activations.  A spec is a ``PartitionSpec``: one entry per tensor dimension,
each ``None``, an axis name, or a tuple of axis names.  The rules are pure
functions of axis names and sizes: they take a ``torch.distributed``
``DeviceMesh`` (its ``mesh_dim_names``) or a ``MeshShape``, which needs no
process group, so the production meshes' rules are computed anywhere.
``placements`` turns a spec into the ``DTensor`` placements of a mesh.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["SERVE_BATCH_AXIS", "BatchMesh", "MeshRules", "MeshShape", "PartitionSpec",
           "activation_spec", "add_dp_axis", "batch_shard_spec", "batch_spec",
           "cache_pspec", "canonical_device", "make_batch_mesh", "map_named", "mesh_axes",
           "param_pspec", "param_pspecs", "placements", "sanitize_spec", "shard_batch"]

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


# ---------------------------------------------------------------------------
# the LM half: parameter, batch, activation and cache specs
# ---------------------------------------------------------------------------
class PartitionSpec(tuple):
    """Per-dimension placement of a tensor over a mesh's named axes: each
    entry ``None`` (whole), an axis name, or a tuple of axis names (the
    dimension split over all of them, the first major).  Dimensions past
    its length are whole.  The port's own copy of JAX's ``PartitionSpec``:
    ``P("data", None) == ("data", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


P = PartitionSpec


@dataclass(frozen=True)
class MeshShape:
    """A mesh of axis names and sizes with no devices behind it (the
    counterpart of ``jax.sharding.AbstractMesh``): ``MeshShape({"data": 16,
    "model": 16})``.  ``shape[axis]`` reads an axis' size."""

    shape: dict

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (its ``mesh_dim_names``) or
    of anything with ``axis_names`` and ``shape[axis]``, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


@dataclass(frozen=True)
class MeshRules:
    mesh: object
    model_axis: str = "model"
    sequence_parallel: bool = False
    fsdp: bool = False  # additionally shard params over the data axes (ZeRO-3)

    @property
    def axes(self) -> dict:
        return mesh_axes(self.mesh)

    @property
    def data_axes(self) -> tuple:
        return tuple(n for n in self.axes if n != self.model_axis)

    @property
    def model_size(self) -> int:
        return self.axes[self.model_axis]

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.data_axes:
            n *= self.axes[a]
        return n

    def _dp(self):
        """The data axes as one spec entry: a name, or a tuple of names."""
        dp = self.data_axes
        return dp if len(dp) > 1 else dp[0]


# column-parallel (shard OUTPUT dim over model)
_COL = {"wq", "wk", "wv", "w1", "w3", "wup", "wqkv", "in_proj", "wgate",
        "frame_proj", "vision_proj", "lm_head", "wx", "wh"}
# row-parallel (shard INPUT dim over model)
_ROW = {"wo", "w2", "wdown", "out_proj"}
# replicated small params
_REP = {"scale", "A_log", "D", "dt_bias", "conv_w"}


def _rule_for(name, ndim_base: int, cfg, model_axis: str, model_size: int) -> P:
    if name in _REP:
        return P(*([None] * ndim_base))
    if name == "embed":
        return P(model_axis, None)  # vocab-parallel
    if name == "router":
        return P(None, None)
    if name in ("w1", "w2", "w3") and ndim_base == 3:  # MoE expert weights
        # expert-parallel when experts divide the axis, else TP on d_ff
        if cfg.n_experts and cfg.n_experts % max(model_size, 1) == 0:
            return P(model_axis, None, None)
        if name == "w2":
            return P(None, model_axis, None)
        return P(None, None, model_axis)
    if name in _COL:
        return P(*([None] * (ndim_base - 1)), model_axis)
    if name in _ROW:
        return P(model_axis, *([None] * (ndim_base - 1)))
    return P(*([None] * ndim_base))


def sanitize_spec(spec, shape, mesh) -> P:
    """Drop sharding on any dim the mesh axes don't evenly divide (a
    sharded tensor's blocks are equal)."""
    axes = mesh_axes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry)
            continue
        size = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            size *= axes[a]
        out.append(entry if shape[i] % size == 0 else None)
    return P(*out)


def _base_ndim(name, leaf) -> int:
    if name in _REP:
        return 1 if name in ("scale", "A_log", "D", "dt_bias") else 2
    if name in ("w1", "w2", "w3") and len(leaf.shape) >= 3:
        return 3  # MoE (E, d, f); dense w1/w2/w3 are 2-D and hit the branch below
    return min(len(leaf.shape), 2)


def add_dp_axis(spec, shape, rules: MeshRules) -> P:
    """ZeRO-style: put the data axes on the first free, divisible dim."""
    dp = rules._dp()
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for d in range(len(shape)):
        if entries[d] is None and shape[d] % rules.dp_size == 0 and shape[d] >= rules.dp_size:
            entries[d] = dp
            return P(*entries)
    return P(*spec)


def map_named(fn, tree, name=None):
    """``fn(name, leaf)`` over a tree of dicts, named tuples and sequences;
    ``name`` is the last dict key on the leaf's path (``None`` if there is
    none), as the reference's rules read the last ``DictKey``."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_named(fn, v, name) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_named(fn, v, name) for v in tree)
    if isinstance(tree, dict):
        return {k: map_named(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


def param_pspec(name, leaf, cfg, rules: MeshRules) -> P:
    """The spec of one parameter (or optimizer-moment) leaf from its name
    (the last dict key on its path) and its shape (anything with ``shape``)."""
    base = _base_ndim(name, leaf)
    rule = _rule_for(name, base, cfg, rules.model_axis, rules.model_size)
    extra = len(leaf.shape) - base
    if extra > 0:
        rule = P(*([None] * extra), *rule)
    rule = sanitize_spec(rule, leaf.shape, rules.mesh)
    if rules.fsdp and len(leaf.shape) >= 2:
        rule = add_dp_axis(rule, leaf.shape, rules)
    return rule


def param_pspecs(params, cfg, rules: MeshRules):
    """A ``PartitionSpec`` tree matching ``params`` (tensors, or anything
    with a ``shape``); scanned stacks get a leading None for
    every extra (layer/group) dimension."""
    return map_named(lambda name, leaf: param_pspec(name, leaf, cfg, rules), params)


def batch_spec(kind: str, rules: MeshRules) -> P:
    """Input-batch specs: batch over (pod, data)."""
    dp = rules._dp()
    if kind in ("tokens", "labels"):
        return P(dp, None)
    if kind in ("patch_embs", "frames"):
        return P(dp, None, None)
    if kind == "token1":  # decode: (B,)
        return P(dp)
    raise ValueError(kind)


def activation_spec(rules: MeshRules) -> P:
    """Hidden-state constraint between blocks: DP on batch (+ SP on seq)."""
    seq = rules.model_axis if rules.sequence_parallel else None
    return P(rules._dp(), seq, None)


def cache_pspec(cfg, rules: MeshRules, batch: int):
    """KV-cache / state sharding for decode: a function ``(name, leaf) ->
    PartitionSpec`` of a cache leaf's name and shape (``map_named`` maps it
    over a cache tree).  Batch over data when divisible, else shard the
    sequence dim (long_500k: batch=1)."""
    dp = rules._dp()
    dp_size = rules.dp_size
    batch_ok = batch % dp_size == 0 if batch >= dp_size else False

    def spec(name, leaf):
        nd = len(leaf.shape)
        if name in ("k", "v", "xk", "xv"):
            # (L, B, S, Hkv, hd): batch over data if possible else seq over data
            if batch_ok:
                sp = P(None, dp, None, rules.model_axis, None)
            else:
                sp = P(None, None, dp, rules.model_axis, None)
        elif name in ("conv", "ssm", "mlstm"):
            # (G, A, B, ...) recurrent states: batch over data when divisible
            sp = P(None, None, dp, *([None] * (nd - 3))) if batch_ok else P(*([None] * nd))
        elif name in ("slstm",):
            sp = P(None, None, dp, None) if batch_ok else P(*([None] * nd))
        else:
            sp = P(*([None] * nd))
        return sanitize_spec(sp, leaf.shape, rules.mesh)

    return spec


def placements(spec, mesh) -> tuple:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: for each mesh
    dimension, ``Shard(d)`` where entry d of the spec names its axis, else
    ``Replicate()``.  A tuple entry shards its dimension over each named
    axis, the first major (JAX's block order), so its axes must come in the
    mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh_axes(mesh))
    dims = {}
    for d, entry in enumerate(spec):
        names = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        if [order.index(a) for a in names] != sorted(order.index(a) for a in names):
            raise ValueError(f"spec {spec!r}: axes {names} of dim {d} are not in the "
                             f"mesh's order {tuple(order)}")
        for a in names:
            if a in dims:
                raise ValueError(f"spec {spec!r} names axis {a!r} twice")
            dims[a] = d
    return tuple(Shard(dims[a]) if a in dims else Replicate() for a in order)
