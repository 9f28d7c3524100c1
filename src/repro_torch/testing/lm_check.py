"""Checks of the LM serving path that need no reference: decode against
prefill, and one step's logits on two devices.

    from repro_torch.testing.lm_check import decode_vs_prefill, rel_err

``chip_smoke.py``'s LM phase and the card tests hold the port to these on
the card; the CPU tests hold it to them on the host.
"""
from __future__ import annotations

import torch

from repro_torch.models import encdec, serve, transformer
from repro_torch.models.config import ArchConfig

__all__ = ["decode_vs_prefill", "no_drop_f32", "rel_err"]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / rms(want), in float64 on ``want``'s device."""
    want = want.double()
    got = got.to(want.device).double()
    rms = float(want.square().mean().sqrt())
    err = float((got - want).abs().max())
    return err / rms if rms > 0 else (0.0 if err == 0 else float("inf"))


def no_drop_f32(cfg: ArchConfig) -> ArchConfig:
    """``cfg`` at float32 compute and, for an MoE, capacity_factor =
    n_experts / top_k.  Capacity depends on the token count, so prefill and
    decode drop different tokens unless no token is dropped."""
    kw = {"compute_dtype": "float32"}
    if cfg.family == "moe":
        kw["capacity_factor"] = cfg.n_experts / cfg.top_k
    return cfg.scaled(**kw)


def decode_vs_prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                      frames: torch.Tensor | None = None) -> float:
    """``rel_err`` of the last position's logits after S decode steps over
    ``tokens`` (B, S) against one prefill of them (``forward_hidden`` +
    ``lm_head``; an enc-dec's ``decode_train`` over the encoded
    ``frames``).  The cache is S long, so a window shorter than S wraps."""
    B, S = tokens.shape
    cache = serve.init_cache(cfg, B, S, device=tokens.device)
    if cfg.family == "encdec":
        enc_out = encdec.encode(params, frames, cfg)
        h = encdec.decode_train(params, tokens, enc_out, cfg)
        xk, xv = encdec.precompute_cross_kv(params, enc_out, cfg)
        # the cache's encoder length follows seq_len: fit it to the frames
        cache["xk"], cache["xv"] = xk.to(cache["k"].dtype), xv.to(cache["v"].dtype)
    else:
        h = transformer.forward_hidden(params, transformer.embed_tokens(params, tokens, cfg), cfg)
    full = transformer.lm_head(params, h[:, -1:], cfg)[:, 0]
    logits = None
    for i in range(S):
        logits, cache = serve.decode_step(params, cache, tokens[:, i], i, cfg)
    return rel_err(logits, full)
