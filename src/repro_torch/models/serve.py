"""Serving: KV-cache / recurrent-state containers + one-token decode steps.

The JAX package's ``models/serve.py``: one new token against a cache of
``seq_len`` (ring-buffered to the window for SWA archs; O(1) recurrent state
for SSM/hybrid archs).  The layer scans are Python loops over the stacked
axis.  A decode step writes the attention caches in place and returns the
cache tree with them (the reference returns new arrays); the recurrent
states are new tensors copied into the stacks.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import blocks, ssm
from .config import ArchConfig
from .encdec import _xattn_decode
from .transformer import at, dense_ffn, lm_head


class TensorSpec(NamedTuple):
    """Shape and dtype of one cache leaf (the reference's ShapeDtypeStruct)."""
    shape: tuple
    dtype: torch.dtype


def cache_spec(cfg: ArchConfig, batch: int, seq_len: int, dtype=None) -> dict:
    """``TensorSpec``s of the decode cache."""
    dt = dtype or cfg.cdt
    f32 = torch.float32
    hd = cfg.head_dim
    S = min(seq_len, cfg.swa_window) if cfg.swa_window else seq_len
    if cfg.family in ("dense", "moe", "vlm"):
        shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, hd)
        return {"k": TensorSpec(shape, dt), "v": TensorSpec(shape, dt)}
    if cfg.family == "hybrid":
        n_groups = cfg.n_layers // cfg.attn_every
        di = cfg.ssm_expand * cfg.d_model
        H = max(1, di // 64)
        kv = (n_groups, batch, S, cfg.n_kv_heads, hd)
        return {
            "k": TensorSpec(kv, dt),
            "v": TensorSpec(kv, dt),
            "conv": TensorSpec((n_groups, cfg.attn_every, batch, cfg.ssm_conv - 1, di), dt),
            "ssm": TensorSpec((n_groups, cfg.attn_every, batch, H, cfg.ssm_state, di // H), f32),
        }
    if cfg.family == "ssm":
        n_groups = cfg.n_layers // cfg.slstm_every
        H = cfg.n_heads
        hd2 = cfg.d_model // H
        return {
            "mlstm": TensorSpec((n_groups, cfg.slstm_every - 1, batch, H, hd2, hd2 + 1), f32),
            "slstm": TensorSpec((n_groups, 2, batch, cfg.d_model), f32),
        }
    if cfg.family == "encdec":
        S_enc = seq_len // cfg.enc_downsample
        kv = (cfg.dec_layers, batch, S, cfg.n_kv_heads, hd)
        xkv = (cfg.dec_layers, batch, S_enc, cfg.n_kv_heads, hd)
        return {"k": TensorSpec(kv, dt), "v": TensorSpec(kv, dt),
                "xk": TensorSpec(xkv, dt), "xv": TensorSpec(xkv, dt)}
    raise ValueError(cfg.family)


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device="cuda") -> dict:
    """A zero cache on ``device`` (the card unless the caller asks for the
    CPU)."""
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in cache_spec(cfg, batch, seq_len).items()}


def _logits(params, h, cfg: ArchConfig):
    h = blocks.apply_norm(params["final_norm"], h, cfg)
    return lm_head(params, h, cfg)[:, 0, :]


# ---------------------------------------------------------------------------
# decode steps
# ---------------------------------------------------------------------------
def decode_dense(params, cache, token, pos, cfg: ArchConfig):
    """One-token step for dense/moe/vlm. token: (B,) int; pos: a Python int
    or a 0-d int tensor."""
    h = params["embed"][token].to(cfg.cdt)[:, None, :]  # (B, 1, d): gather, then cast
    for i in range(cfg.n_layers):
        lp = at(params["layers"], i)
        a, _, _ = blocks.attention_decode(lp["attn"], blocks.apply_norm(lp["n1"], h, cfg),
                                          cache["k"][i], cache["v"][i], pos, cfg)
        h = h + a
        h = h + dense_ffn(lp, h, cfg)
    return _logits(params, h, cfg), cache


def decode_hybrid(params, cache, token, pos, cfg: ArchConfig):
    h = params["embed"][token].to(cfg.cdt)[:, None, :]
    shared_attn, shared_norm = params["shared_attn"], params["shared_norm"]
    groups = params["groups"]
    for g in range(cfg.n_layers // cfg.attn_every):
        a, _, _ = blocks.attention_decode(shared_attn, blocks.apply_norm(shared_norm, h, cfg),
                                          cache["k"][g], cache["v"][g], pos, cfg)
        h = h + a
        for j in range(cfg.attn_every):
            o, ncv, nss = ssm.mamba2_fwd(
                at(groups["mamba"], (g, j)),
                blocks.apply_norm(at(groups["norms"], (g, j)), h, cfg), cfg,
                conv_state=cache["conv"][g, j], ssm_state=cache["ssm"][g, j], decode=True)
            cache["conv"][g, j] = ncv
            cache["ssm"][g, j] = nss
            h = h + o
    return _logits(params, h, cfg), cache


def decode_xlstm(params, cache, token, pos, cfg: ArchConfig):
    h = params["embed"][token].to(cfg.cdt)[:, None, :]
    groups = params["groups"]
    for g in range(cfg.n_layers // cfg.slstm_every):
        for j in range(cfg.slstm_every - 1):
            o, cache["mlstm"][g, j] = ssm.mlstm_fwd(at(groups["mlstm"], (g, j)), h, cfg,
                                                    state=cache["mlstm"][g, j], decode=True)
            h = h + o
        o, cache["slstm"][g] = ssm.slstm_fwd(at(groups["slstm"], g), h, cfg,
                                             state=cache["slstm"][g], decode=True)
        h = h + o
    return _logits(params, h, cfg), cache


def decode_encdec(params, cache, token, pos, cfg: ArchConfig):
    """Decoder step with self-attn KV cache + precomputed cross-attn KV."""
    h = params["embed"][token].to(cfg.cdt)[:, None, :]
    for i in range(cfg.dec_layers):
        lp = at(params["dec_layers"], i)
        a, _, _ = blocks.attention_decode(lp["attn"], blocks.apply_norm(lp["n1"], h, cfg),
                                          cache["k"][i], cache["v"][i], pos, cfg)
        h = h + a
        h = h + _xattn_decode(lp["xattn"], blocks.apply_norm(lp["n2"], h, cfg),
                              cache["xk"][i], cache["xv"][i], cfg)
        h = h + blocks.mlp_fwd(lp["mlp"], blocks.apply_norm(lp["n3"], h, cfg), cfg)
    return _logits(params, h, cfg), cache


def decode_step(params, cache, token, pos, cfg: ArchConfig):
    """(logits (B, vocab), cache) after one token; the cache is updated in
    place."""
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return decode_dense(params, cache, token, pos, cfg)
    if fam == "hybrid":
        return decode_hybrid(params, cache, token, pos, cfg)
    if fam == "ssm":
        return decode_xlstm(params, cache, token, pos, cfg)
    if fam == "encdec":
        return decode_encdec(params, cache, token, pos, cfg)
    raise ValueError(fam)
