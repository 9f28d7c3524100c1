"""Encoder-decoder backbone (seamless-m4t): speech encoder (stub frames) +
text decoder with cross-attention.

The JAX package's ``models/encdec.py`` over the same stacked tree; its layer
scans are Python loops here, each layer rematerialized as the reference's
``jax.checkpoint`` bodies are (when grad is on).
"""
from __future__ import annotations

import torch

from . import blocks, mesh_ops
from .blocks import _normal
from .config import ArchConfig
from .transformer import at, chunked_xent, embed_tokens, unstack

_F32 = torch.float32


def init_encdec(cfg: ArchConfig, gen: torch.Generator, device=None) -> dict:
    """The reference's tree, drawn from ``gen`` at its scales (see
    ``transformer.init_lm``)."""
    device = gen.device if device is None else torch.device(device)
    d, s = cfg.d_model, cfg.d_model ** -0.5
    E, D = (cfg.enc_layers,), (cfg.dec_layers,)
    enc = {"attn": blocks.init_attention(gen, cfg, E, device),
           "mlp": blocks.init_mlp(gen, cfg, None, E, device),
           "n1": blocks.init_norm(cfg, E, device), "n2": blocks.init_norm(cfg, E, device)}
    dec = {"attn": blocks.init_attention(gen, cfg, D, device),
           "xattn": blocks.init_attention(gen, cfg, D, device),
           "mlp": blocks.init_mlp(gen, cfg, None, D, device),
           **{n: blocks.init_norm(cfg, D, device) for n in ("n1", "n2", "n3")}}
    return {
        "embed": _normal(gen, (cfg.vocab, d), s, cfg.pdt, device),
        "lm_head": _normal(gen, (d, cfg.vocab), s, cfg.pdt, device),
        "frame_proj": _normal(gen, (d, d), s, cfg.pdt, device),
        "enc_layers": enc,
        "dec_layers": dec,
        "enc_norm": blocks.init_norm(cfg, device=device),
        "final_norm": blocks.init_norm(cfg, device=device),
    }


@mesh_ops.headwise
def _softmax_attend(q, k, v):
    """Unmasked softmax attention of q (B, S, H, hd) over k, v (B, T, Hkv,
    hd), in float32: (B, S, H, hd)."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    qf = (q * hd ** -0.5).to(_F32).reshape(B, S, Hkv, H // Hkv, hd)
    p = torch.softmax(torch.einsum("bshgd,bthd->bshgt", qf, k.to(_F32)), dim=-1)
    return torch.einsum("bshgt,bthd->bshgd", p, v.to(_F32)).reshape(B, S, H, hd)


def _attend(params, q, k, v, cfg: ArchConfig):
    """Unmasked softmax attention of q (B, S, H, hd) over k, v (B, T, Hkv,
    hd), then the output projection."""
    o = mesh_ops.merge_heads(_softmax_attend(q, k, v)).to(cfg.cdt)
    return o @ params["wo"].to(cfg.cdt)


def _bidir_attention(params, h, cfg: ArchConfig):
    """Encoder self-attention: bidirectional, over the full sequence."""
    S = h.shape[1]
    q, k, v = blocks._qkv(params, h.to(cfg.cdt), cfg)
    pos = torch.arange(S, device=h.device)[None, :]
    inv = blocks.rope_freqs(cfg, h.device)
    q = blocks.apply_rope(q, pos, inv)
    k = blocks.apply_rope(k, pos, inv)
    return mesh_ops.reduced_like(_attend(params, q, k, v, cfg).to(h.dtype), h)


def _cross_kv(params, enc_out, cfg: ArchConfig):
    e = enc_out.to(cfg.cdt)
    k = mesh_ops.split_heads(e @ params["wk"].to(cfg.cdt), cfg.n_kv_heads, cfg.head_dim)
    v = mesh_ops.split_heads(e @ params["wv"].to(cfg.cdt), cfg.n_kv_heads, cfg.head_dim)
    return k, v


def cross_attention(params, h, enc_out, cfg: ArchConfig):
    q = mesh_ops.split_heads(h.to(cfg.cdt) @ params["wq"].to(cfg.cdt), cfg.n_heads,
                             cfg.head_dim)
    k, v = _cross_kv(params, enc_out, cfg)
    return mesh_ops.reduced_like(_attend(params, q, k, v, cfg).to(h.dtype), h)


def _xattn_decode(params, h, xk, xv, cfg: ArchConfig):
    """Cross-attention for one decoder token against precomputed encoder KV."""
    B = h.shape[0]
    q = (h.to(cfg.cdt) @ params["wq"].to(cfg.cdt)).reshape(B, 1, cfg.n_heads, cfg.head_dim)
    return mesh_ops.reduced_like(_attend(params, q, xk, xv, cfg).to(h.dtype), h)


def precompute_cross_kv(params, enc_out, cfg: ArchConfig):
    """Per-decoder-layer cross-attention K/V from encoder output (cache
    fill): two (L, B, S_enc, Hkv, hd) stacks."""
    kv = [_cross_kv(at(params["dec_layers"]["xattn"], i), enc_out, cfg)
          for i in range(cfg.dec_layers)]
    return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])


def encode(params, frames, cfg: ArchConfig):
    """frames: (B, S_enc, d_model) stub frame embeddings (modality frontend)."""
    h = frames.to(cfg.cdt) @ params["frame_proj"].to(cfg.cdt)

    def layer(lp, h):
        h = h + _bidir_attention(lp["attn"], blocks.apply_norm(lp["n1"], h, cfg), cfg)
        return h + blocks.mlp_fwd(lp["mlp"], blocks.apply_norm(lp["n2"], h, cfg), cfg)

    for lp in unstack(params["enc_layers"], cfg.enc_layers):
        h = blocks.checkpointed(layer, lp, h)
    return blocks.apply_norm(params["enc_norm"], h, cfg)


def decode_train(params, tokens, enc_out, cfg: ArchConfig):
    h = embed_tokens(params, tokens, cfg)

    def layer(lp, h):
        h = h + blocks.attention_fwd(lp["attn"], blocks.apply_norm(lp["n1"], h, cfg), cfg)
        h = h + cross_attention(lp["xattn"], blocks.apply_norm(lp["n2"], h, cfg), enc_out, cfg)
        return h + blocks.mlp_fwd(lp["mlp"], blocks.apply_norm(lp["n3"], h, cfg), cfg)

    for lp in unstack(params["dec_layers"], cfg.dec_layers):
        h = blocks.checkpointed(layer, lp, h)
    return blocks.apply_norm(params["final_norm"], h, cfg)


def encdec_loss(params, batch, cfg: ArchConfig):
    """batch: frames (B, S_enc, d), tokens (B, S), labels (B, S)."""
    enc_out = encode(params, batch["frames"], cfg)
    h = decode_train(params, batch["tokens"], enc_out, cfg)
    return chunked_xent(params, h, batch["labels"], cfg)
