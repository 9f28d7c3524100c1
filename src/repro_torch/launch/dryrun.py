"""Multi-pod dry run: lay out one step of every (arch x shape x mesh) cell
at production scale, with no hardware and nothing allocated.

This shows that the distribution config holds together without the
hardware: a fake process group of 256 (16x16) or 512 (2x16x16) ranks forms
the production ``DeviceMesh`` in this one process (rank 0), the parameters,
optimizer state and batch are meta-tensor ``DTensor``s placed by the
sharding rules (``launch.specs``), and one step runs on them: a train step
(forward, backward, the gradients redistributed to the parameters'
placements as ``Trainer(mesh=)`` does, the update), a prefill loss or a
``decode_step``.  A dispatch mode under the step reads rank 0's work from the
ops it runs on its local blocks.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k \\
        [--multi-pod] [--optimizer adamw|orthant] [--seq-parallel] [--zero1] \\
        [--no-probe] [--out result.json]

The result has the JAX package's keys; what each means here:

- ``chips``, ``mesh``: the fake group's world size and the mesh's shape.
- ``compile_seconds``: host seconds the meta step took (there is no
  compile).
- ``per_device.hlo_flops``: the FLOPs of the ops rank 0 runs on its local
  blocks, by ``torch.utils.flop_counter``'s formulas (matrix products and
  attention; elementwise ops count nothing), plus, under ``--optimizer
  orthant``, the operations of the GGR kernels B3/B4 by ``core.counts``'s
  models.  ``FlopCounterMode`` over ``DTensor``s would count the global
  program (the sharding propagation's global-shape ops): the count here
  skips those and reads the local ops only, as XLA's per-device
  ``cost_analysis`` does.
- ``per_device.hlo_bytes``: the bytes each of rank 0's ops (views and
  collectives excepted) reads and writes on its local shapes.  Eager
  PyTorch fuses nothing, so this is larger than XLA's fused count.
- ``per_device.collective_bytes`` and ``collectives``: the result-shape
  bytes of every collective rank 0 issues, by kind (``all-reduce``,
  ``all-gather``, ``reduce-scatter``, ``all-to-all``; ``collective-permute``
  reads 0, as ``DTensor`` issues none), and their ``count``.
- ``per_device.kernels`` (``--optimizer orthant`` only): for B3
  (``panel_factor``) and B4 (``apply_factors``) the launches the step would
  make on one rank and their operations.  Their meta branches compute
  nothing and launch nothing.
- ``roofline_seconds``: FLOPs over ``PEAK_FLOPS``, bytes over ``HBM_BW``,
  collective bytes over ``ICI_BW`` (the H100's), and the ``dominant`` term.
- ``model_flops_global``, ``params``, ``active_params``: the reference's
  formulas; ``hlo_flops_global`` = per-device FLOPs x chips.
- ``memory_analysis``: ``argument_size_bytes`` is rank 0's local bytes of
  the step's inputs (train: parameters, optimizer state and batch; prefill:
  parameters and batch; decode: parameters, cache, token and position),
  ``output_size_bytes`` the same of its outputs; ``temp_size_bytes`` and
  ``generated_code_size_bytes`` are ``None``, with the reason beside them.
- ``unrolled_scans``: the flag as given.  The port's layer and chunk loops
  are Python loops, so every iteration is counted whether or not it is set
  (``counted_iterations``).
- ``depth_probe`` / ``*_corrected``: the reference's method, two steps at
  depths (1, 2) extrapolated to the full depth.  Every iteration is counted
  already, so the corrected numbers read what the full step reads.

Importing this module sets nothing and forms no group; the group is formed
for one step and destroyed after it, also on error.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import cell_is_runnable, get_config, get_shape, list_archs
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_mesh
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.parallel import MeshRules, MeshShape

__all__ = ["HBM_BW", "ICI_BW", "PEAK_FLOPS", "LocalWork", "StepRecord", "analyze",
           "collective_bytes", "depth_probe", "depth_units", "fake_mesh", "lower_cell", "main",
           "placed_inputs", "run_step", "with_depth"]

# H100 SXM constants for the roofline terms (the reference's are a TPU's):
# dense bf16 tensor-core peak, HBM3 bandwidth, NVLink bandwidth each way.
# A 16-wide model axis spans two 8-card hosts, so its collectives cross the
# hosts' network there and the NVLink term is a lower bound.
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
ICI_BW = 450e9

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
# collective ops (functional and c10d) by the reference's kinds
_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "c10d")
# ops of those namespaces that move nothing between ranks
_NOT_COLLECTIVES = frozenset({"wait_tensor", "_wrap_tensor_autograd"})
# ops that move no bytes: allocation without a write, and autograd bookkeeping
_NO_BYTES = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                       "new_empty_strided", "detach", "alias", "lift_fresh"})

_NULL_REASONS = {
    "temp_size_bytes": "eager PyTorch has no compiled program whose scratch a "
                       "compiler sizes; meta tensors allocate nothing",
    "generated_code_size_bytes": "eager PyTorch generates no program code",
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def collective_bytes(records) -> dict:
    """Sum the result-shape bytes of collectives by kind: ``records`` is an
    iterable of (name, result bytes), the name a functional or c10d
    collective (``all_reduce``, ``all_gather_into_tensor``,
    ``reduce_scatter_tensor``, ``all_to_all_single``, ``allreduce_``, ...)
    or a kind itself (``"collective-permute"``).  A name of no known kind
    raises ``ValueError``."""
    out = {k: 0 for k in KINDS}
    out["count"] = 0
    for name, nbytes in records:
        kind = name if name in KINDS else _KIND.get(name)
        if kind is None:
            raise ValueError(f"collective {name!r} has no kind")
        out[kind] += int(nbytes)
        out["count"] += 1
    out["total"] = sum(out[k] for k in KINDS)
    return out


class LocalWork(TorchDispatchMode):
    """A dispatch mode that reads rank 0's work (``per_device``): FLOPs,
    bytes and collectives of the ops run on local blocks.

    A ``DTensor`` op is handed on (``NotImplemented``), so ``DTensor`` runs
    it, and the local ops it runs come back here; the ops of its sharding
    propagation run on ``FakeTensor``s of the global shapes and are
    skipped."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.records: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins = [x for x in tree_leaves((args, kwargs)) if isinstance(x, torch.Tensor)]
        outs = [x for x in tree_leaves(out) if isinstance(x, torch.Tensor)]
        if any(isinstance(x, FakeTensor) for x in ins + outs):
            return out  # DTensor's sharding propagation, on global shapes
        name = func.overloadpacket.__name__
        if func.namespace in _COLLECTIVE_NS:
            if name not in _NOT_COLLECTIVES:
                self.records.append((name, sum(_nbytes(x) for x in outs)))
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and name not in _NO_BYTES:
            self.bytes += sum(_nbytes(x) for x in ins + outs)
        return out


@dataclasses.dataclass
class StepRecord:
    """What one meta step read on rank 0 (``lower_cell``'s counterpart of a
    lowered program)."""

    seconds: float
    flops: float
    bytes: float
    collectives: dict
    kernels: dict
    argument_bytes: int
    output_bytes: int


def depth_units(cfg) -> int:
    """Depth in homogeneous 'units' (per-family loop trip count)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "ssm":
        return cfg.n_layers // cfg.slstm_every
    if cfg.family == "encdec":
        return cfg.enc_layers  # enc and dec scale together
    return cfg.n_layers


def with_depth(cfg, units: int):
    """Config with depth set to ``units`` (same widths — per-unit cost equal)."""
    if cfg.family == "hybrid":
        return cfg.scaled(n_layers=cfg.attn_every * units)
    if cfg.family == "ssm":
        return cfg.scaled(n_layers=cfg.slstm_every * units)
    if cfg.family == "encdec":
        return cfg.scaled(n_layers=units, enc_layers=units, dec_layers=units)
    return cfg.scaled(n_layers=units)


@contextlib.contextmanager
def fake_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` on device type ``"cpu"``
    over a fake process group of ``prod(shape)`` ranks, this process rank 0
    (collectives on it compute nothing); the group is destroyed on exit, also
    on error.  ``RuntimeError`` if a process group is already initialized."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a process group is already initialized in this "
                           "process; the dry run forms its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    try:
        yield make_mesh(shape, axes, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _replace(new, old):
    """``new`` in ``old``'s placements (the step's outputs as its inputs were
    placed, as a donated program's are), where they differ."""
    from repro_torch.models.mesh_ops import is_dtensor

    if is_dtensor(new) and is_dtensor(old) and new.placements != old.placements:
        return new.redistribute(old.device_mesh, old.placements)
    return new


def placed_inputs(cfg, shape, rules, optimizer: str = "adamw", zero1: bool = False) -> tuple:
    """The inputs of one step of ``shape``'s kind as placed meta ``DTensor``s
    (``launch.specs``): train (params, optimizer state, batch), prefill
    (params, batch), decode (params, cache, token, pos)."""
    from repro_torch.train.step import make_update_fn

    params = S.param_specs(cfg, rules)
    if shape.kind == "train":
        opt_init, _ = make_update_fn(optimizer)
        return (params, S.opt_specs(params, cfg, rules, opt_init, zero1=zero1),
                S.batch_specs(cfg, shape, rules))
    if shape.kind == "prefill":
        return params, S.batch_specs(cfg, shape, rules)
    return (params, *S.decode_specs(cfg, shape, rules))


def run_step(cfg, shape, rules, optimizer: str, inputs: tuple):
    """One step of ``shape``'s kind on ``inputs`` (``placed_inputs``'
    layout; meta or real ``DTensor``s): its outputs.  A train step is
    ``Trainer(mesh=)``'s: the loss and gradients (redistributed to the
    parameters' placements) under ``implicit_replication``, then the update,
    the new parameters and state put back in their inputs' placements."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import serve as serve_mod
    from repro_torch.optim._tree import tree_map
    from repro_torch.train.step import make_grads_fn, make_loss_fn, make_update_fn

    if shape.kind == "train":
        params, opt, batch = inputs
        with implicit_replication():
            loss, grads = make_grads_fn(cfg)(params, batch)
        new_params, new_opt, metrics = make_update_fn(optimizer)[1](params, opt, loss, grads)
        return tree_map(_replace, new_params, params), tree_map(_replace, new_opt, opt), metrics
    with torch.no_grad(), implicit_replication():
        if shape.kind == "prefill":
            # prefill cost proxy: the full forward over the request batch
            # (cache writes add O(S·kv) on top, negligible next to attention)
            return make_loss_fn(cfg)(*inputs)
        return serve_mod.decode_step(*inputs, cfg)


def lower_cell(arch: str, shape_name, multi_pod: bool, optimizer: str = "adamw",
               seq_parallel: bool = False, unroll: bool = False, cfg_override=None,
               zero1: bool = False, mesh_shape=None):
    """One meta step of a cell on a fake mesh: ``(cfg, shape, mesh, record)``,
    ``mesh`` a ``MeshShape`` (the group is gone when this returns) and
    ``record`` a ``StepRecord``.

    ``shape_name`` names a shape of ``SHAPES`` or is a ``ShapeConfig``;
    ``mesh_shape`` ((shape, axis names)) replaces the production mesh.
    ``unroll`` is taken for the reference's signature: every loop iteration
    is counted anyway."""
    from repro_torch.core import counts

    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = shape_name if isinstance(shape_name, ShapeConfig) else get_shape(shape_name)
    dims, axes = mesh_shape if mesh_shape is not None else PRODUCTION_SHAPES[multi_pod]
    if os.environ.get("REPRO_REMAT_POLICY"):
        cfg = cfg.scaled(remat_policy=os.environ["REPRO_REMAT_POLICY"])
    if os.environ.get("REPRO_MOE_GROUPS"):
        cfg = cfg.scaled(moe_groups=int(os.environ["REPRO_MOE_GROUPS"]))
    with fake_mesh(dims, axes) as mesh:
        rules = MeshRules(mesh, sequence_parallel=seq_parallel)
        if seq_parallel:
            cfg = cfg.scaled(act_dp_axes=rules.data_axes, act_sp_axis=rules.model_axis)
        inputs = placed_inputs(cfg, shape, rules, optimizer, zero1)
        t0 = time.perf_counter()
        with counts.kernel_tally() as kernels, LocalWork() as work:
            outputs = run_step(cfg, shape, rules, optimizer, inputs)
        seconds = time.perf_counter() - t0
        record = StepRecord(
            seconds=seconds,
            flops=float(work.flops + sum(k["flops"] for k in kernels.values())),
            bytes=float(work.bytes), collectives=collective_bytes(work.records),
            kernels=kernels, argument_bytes=S.local_nbytes(inputs),
            output_bytes=S.local_nbytes(outputs))
    return cfg, shape, MeshShape(dict(zip(axes, dims))), record


def _roofline(flops: float, nbytes: float, coll: float) -> dict:
    terms = {"compute": flops / PEAK_FLOPS, "memory": nbytes / HBM_BW,
             "collective": coll / ICI_BW}
    return {**terms, "dominant": max(terms.items(), key=lambda kv: kv[1])[0]}


# the TPU kernels of the fused schedule that Orthant's update reaches
_KERNEL_IDS = {"panel_factor": "B3", "apply_factors": "B4"}


def analyze(cfg, shape, mesh, record: StepRecord) -> dict:
    """The reference's result keys from one meta step (the module docstring
    says what each means here)."""
    chips = math.prod(mesh.shape.values())
    flops, coll = record.flops, record.collectives
    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        model_flops = 6 * n_active * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        model_flops = 2 * n_active * shape.global_batch * shape.seq_len
    else:
        model_flops = 2 * n_active * shape.global_batch  # one token
    per_device = {
        "hlo_flops": flops,
        "hlo_bytes": record.bytes,
        "collective_bytes": coll["total"],
        "collectives": {k: v for k, v in coll.items() if k != "total"},
    }
    if record.kernels:
        per_device["kernels"] = {name: {"tpu_kernel": _KERNEL_IDS.get(name), **v}
                                 for name, v in sorted(record.kernels.items())}
    hlo_flops_total = flops * chips
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": list(mesh.shape.values()),
        "chips": int(chips),
        "compile_seconds": record.seconds,
        "per_device": per_device,
        "roofline_seconds": _roofline(flops, record.bytes, coll["total"]),
        "model_flops_global": model_flops,
        "hlo_flops_global": hlo_flops_total,
        "useful_flops_ratio": model_flops / hlo_flops_total if hlo_flops_total else None,
        "params": n_params,
        "active_params": n_active,
        "memory_analysis": {
            "argument_size_bytes": record.argument_bytes,
            "output_size_bytes": record.output_bytes,
            "temp_size_bytes": None,
            "generated_code_size_bytes": None,
            "null_reasons": dict(_NULL_REASONS),
        },
    }


def depth_probe(arch, shape_name, multi_pod, optimizer, seq_parallel,
                depths=(1, 2), zero1=False):
    """Cost accounting from reduced-depth steps, the reference's method.

    Every term of the step is linear in depth-units L (homogeneous layers,
    depth-independent embed/head/optimizer base), so two steps at depths
    (a, b) give per-unit and base costs, extrapolated to the full L.  The
    port counts every loop iteration, so the extrapolation reproduces the
    full step's reading; the probe is kept for parity and as a check."""
    cfg_full = get_config(arch)
    L = depth_units(cfg_full)
    a, b = depths
    if L <= b:
        a, b = max(1, L - 1), L
    res = {}
    for d in (a, b):
        *_, record = lower_cell(arch, shape_name, multi_pod, optimizer, seq_parallel,
                                unroll=True, cfg_override=with_depth(cfg_full, d),
                                zero1=zero1)
        res[d] = (record.flops, record.bytes, float(record.collectives["total"]))
    if a == b:
        per_unit = tuple(0.0 for _ in res[b])
        base = res[b]
    else:
        per_unit = tuple((rb - ra) / (b - a) for ra, rb in zip(res[a], res[b]))
        base = tuple(rb - b * pu for rb, pu in zip(res[b], per_unit))
    corrected = tuple(bs + L * pu for bs, pu in zip(base, per_unit))
    return {
        "probe_depths": [a, b],
        "full_depth_units": L,
        "per_unit": {"flops": per_unit[0], "bytes": per_unit[1],
                     "collective_bytes": per_unit[2]},
        "corrected_per_device": {"hlo_flops": corrected[0], "hlo_bytes": corrected[1],
                                 "collective_bytes": corrected[2]},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "orthant"])
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--unroll", action="store_true",
                    help="accepted for parity: every loop iteration is counted anyway")
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the depth-probe cost correction")
    ap.add_argument("--zero1", action="store_true",
                    help="shard optimizer moments over the data axes (ZeRO-1)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    ok, why = cell_is_runnable(args.arch, args.shape)
    if not ok:
        result = {"arch": args.arch, "shape": args.shape,
                  "multi_pod": args.multi_pod, "skipped": why}
    else:
        cfg, shape, mesh, record = lower_cell(
            args.arch, args.shape, args.multi_pod, args.optimizer, args.seq_parallel,
            args.unroll, zero1=args.zero1)
        result = analyze(cfg, shape, mesh, record)
        result["multi_pod"] = args.multi_pod
        result["optimizer"] = args.optimizer
        result["seq_parallel"] = args.seq_parallel
        result["zero1"] = args.zero1
        result["unrolled_scans"] = args.unroll
        result["counted_iterations"] = "all (Python loops; --unroll changes nothing)"
        if not args.no_probe:
            probe = depth_probe(args.arch, args.shape, args.multi_pod, args.optimizer,
                                args.seq_parallel, zero1=args.zero1)
            result["depth_probe"] = probe
            cpd = probe["corrected_per_device"]
            result["roofline_seconds_corrected"] = _roofline(
                cpd["hlo_flops"], cpd["hlo_bytes"], cpd["collective_bytes"])
            total = cpd["hlo_flops"] * result["chips"]
            result["hlo_flops_global_corrected"] = total
            result["useful_flops_ratio_corrected"] = (
                result["model_flops_global"] / total if total else None)
    print(json.dumps(result, indent=2))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
