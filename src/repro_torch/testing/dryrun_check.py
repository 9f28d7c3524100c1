"""Checks of a dry-run result (``launch.dryrun``), shared by the CPU tests
and ``chip_smoke.py``.

    from repro_torch.testing.dryrun_check import RESULT_KEYS, useful_band

``hand_train_flops`` counts one train step of a dense decoder by hand, the
least the step can run on any layout: Megatron tensor parallelism (every
product split over the ranks), every layer and loss chunk checkpointed
(remat "full": a second forward in the backward pass, where non-reentrant
``torch.utils.checkpoint`` stops before a layer's last product, whose
output the backward does not read), attention over every (query, key)
pair of a chunked pass (the causal mask skips nothing), the embedding a
lookup.  ``useful_band`` bounds a result's ``useful_flops_ratio(_corrected)``
by it: the model FLOPs over the hand count at most (within 1e-9), and
``USEFUL_FLOOR`` of that at least, for products a ``DTensor`` strategy may
add (``models.mesh_ops`` says which it did add before the models placed
the tensor-parallel blocks' ends themselves).
"""
from __future__ import annotations

__all__ = ["RESULT_KEYS", "USEFUL_FLOOR", "hand_train_flops", "missing_keys", "useful_band"]

# the JAX package's result keys (src/repro/launch/dryrun.py), nested ones as
# paths; a probed result adds the corrected ones
RESULT_KEYS = (
    "arch", "shape", "mesh", "chips", "compile_seconds",
    "per_device/hlo_flops", "per_device/hlo_bytes", "per_device/collective_bytes",
    "per_device/collectives/all-reduce", "per_device/collectives/all-gather",
    "per_device/collectives/reduce-scatter", "per_device/collectives/all-to-all",
    "per_device/collectives/collective-permute", "per_device/collectives/count",
    "roofline_seconds/compute", "roofline_seconds/memory", "roofline_seconds/collective",
    "roofline_seconds/dominant", "model_flops_global", "hlo_flops_global",
    "useful_flops_ratio", "params", "active_params",
    "memory_analysis/argument_size_bytes", "memory_analysis/output_size_bytes",
    "memory_analysis/temp_size_bytes", "memory_analysis/generated_code_size_bytes",
    "multi_pod", "optimizer", "seq_parallel", "unrolled_scans",
)
PROBE_KEYS = ("depth_probe/probe_depths", "depth_probe/full_depth_units",
              "depth_probe/corrected_per_device/hlo_flops", "roofline_seconds_corrected/dominant",
              "hlo_flops_global_corrected", "useful_flops_ratio_corrected")
# the least share of the hand count's useful ratio a result may read
USEFUL_FLOOR = 0.8


def missing_keys(result: dict, probed: bool = True) -> list:
    """The reference's keys ``result`` lacks (``probed``: the depth probe's
    too)."""
    out = []
    for key in RESULT_KEYS + (PROBE_KEYS if probed else ()):
        node = result
        for part in key.split("/"):
            if not isinstance(node, dict) or part not in node:
                out.append(key)
                break
            node = node[part]
    return out


def hand_train_flops(cfg, shape) -> float:
    """Global FLOPs of one train step of a dense decoder (``cfg.family ==
    "dense"``, remat "full") counted by hand (the module docstring)."""
    if cfg.family != "dense":
        raise ValueError(f"hand_train_flops counts dense decoders, not {cfg.family!r}")
    d, ff, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    qo, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    gated = cfg.activation != "sq_relu"
    layer = 2 * (2 * d * qo + 2 * d * kv + (3 if gated else 2) * d * ff)
    last = 2 * ff * d  # the down projection: the recompute stops before it
    attn = 4 * shape.seq_len * qo  # QK^T and PV over every pair
    head = 2 * d * V
    per_token = L * (4 * layer - last + 4 * attn) + 4 * head
    return float(per_token * shape.global_batch * shape.seq_len)


def useful_band(cfg, shape) -> tuple:
    """(low, high) for a dense train cell's useful-FLOPs ratio: the model
    FLOPs (6·N·D) over the hand count at most (within 1e-9),
    ``USEFUL_FLOOR`` of it at least."""
    model = 6 * cfg.active_param_count() * shape.global_batch * shape.seq_len
    high = model / hand_train_flops(cfg, shape)
    return USEFUL_FLOOR * high, high * (1 + 1e-9)
