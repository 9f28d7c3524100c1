"""Architecture configuration — one dataclass covers all 10 assigned archs.

The JAX package's ``models/config.py`` with the same fields and defaults;
``pdt`` / ``cdt`` give ``torch.dtype``s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention
    head_dim: Optional[int] = None
    rope_theta: float = 10_000.0
    swa_window: Optional[int] = None  # sliding-window attention (mixtral)
    norm: str = "rms"  # rms | layer | nonparam (olmo)
    activation: str = "silu"  # silu | gelu | sq_relu (nemotron)
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    dense_ff: int = 0  # width of the parallel dense MLP (arctic)
    capacity_factor: float = 1.25
    # GShard-style dispatch groups: capacity is per-group. 1 = one global group.
    moe_groups: int = 1

    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    attn_every: int = 0  # hybrid: shared attention block every k mamba blocks
    slstm_every: int = 0  # xlstm: sLSTM block every k mLSTM blocks

    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    enc_downsample: int = 4  # audio frames = seq_len // enc_downsample

    # vlm
    n_patches: int = 0
    vision_dim: int = 0  # stub CLIP embedding dim

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # batch dims over act_dp_axes; optionally megatron-style sequence parallel
    # over act_sp_axis between blocks (``blocks.constrain_act``, on a mesh)
    act_dp_axes: Optional[tuple] = None
    act_sp_axis: Optional[str] = None

    # remat of each dense/moe/vlm layer when grad is on
    # (``blocks.checkpointed``): "dots" keeps the weight products, any other
    # value recomputes the whole layer; changes no value
    remat_policy: str = "full"

    # which of the four shapes apply (long_500k only for sub-quadratic archs)
    supports_long_context: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def pdt(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdt(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def scaled(self, **kw) -> "ArchConfig":
        """A reduced copy (smoke tests): override any field."""
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline bookkeeping)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        if self.family in ("dense", "vlm"):
            per_layer = attn + 3 * d * ff  # gated MLP
            n = self.n_layers * per_layer + v * d * (1 if self.tie_embeddings else 2)
        elif self.family == "moe":
            per_layer = attn + self.n_experts * 3 * d * ff
            if self.moe_dense_residual:
                per_layer += 3 * d * (self.dense_ff or ff)
            n = self.n_layers * per_layer + v * d * 2
        elif self.family == "ssm":
            di = self.ssm_expand * d
            per_layer = 2 * d * di + di * d + di * self.ssm_conv
            n = self.n_layers * per_layer + v * d * 2
        elif self.family == "hybrid":
            di = self.ssm_expand * d
            mamba = 2 * d * di + di * d + di * (self.ssm_state * 2 + self.ssm_conv)
            n = self.n_layers * mamba + attn + 3 * d * ff + v * d * 2
        elif self.family == "encdec":
            enc = self.enc_layers * (attn + 3 * d * ff)
            dec = self.dec_layers * (2 * attn + 3 * d * ff)
            n = enc + dec + v * d * 2
        else:
            raise ValueError(self.family)
        return int(n)

    def active_param_count(self) -> int:
        """MoE: params touched per token (top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        per_layer = attn + self.top_k * 3 * d * ff
        if self.moe_dense_residual:
            per_layer += 3 * d * (self.dense_ff or ff)
        return int(self.n_layers * per_layer + v * d * 2)


# ---------------------------------------------------------------------------
# the four assigned input shapes
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
