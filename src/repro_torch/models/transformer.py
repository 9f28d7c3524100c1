"""Decoder-only LM covering the dense / moe / vlm / ssm / hybrid families.

The JAX package's ``models/transformer.py`` over the same parameter tree in
its stacked layout (``layers/attn/wq`` is ``(L, d, H·hd)``); its layer
``lax.scan`` is a Python loop over the stacked axis.  Forward only: the
reference's ``jax.checkpoint`` / ``_remat`` changes no forward value and
has no counterpart here.
"""
from __future__ import annotations

from typing import Any

import torch

from . import blocks, ssm
from .blocks import _normal
from .config import ArchConfig

_F32 = torch.float32

# leaves the reference only ever reads cast to the compute dtype (norm
# scales, the router, mLSTM's gate, sLSTM's recurrence and Mamba2's A_log /
# dt_bias stay f32): ``compute_copy`` casts these once
COMPUTE_LEAVES = frozenset({"wq", "wk", "wv", "wo", "w1", "w2", "w3", "in_proj",
                            "conv_w", "D", "out_proj", "wqkv", "wup", "wdown",
                            "embed", "lm_head", "vision_proj", "frame_proj"})


def at(tree, i):
    """Entry ``i`` of every leaf of a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: at(v, i) for k, v in tree.items()}
    return tree[i]


def compute_copy(params, cfg: ArchConfig):
    """The tree with every ``COMPUTE_LEAVES`` leaf cast to ``cfg.cdt`` once;
    other leaves are the same tensors.  The forward functions cast there
    anyway (a no-op on a cast leaf), so results keep their bits while a
    decode step stops re-casting the weights."""
    if isinstance(params, dict):
        return {k: (v.to(cfg.cdt) if k in COMPUTE_LEAVES and isinstance(v, torch.Tensor)
                    else compute_copy(v, cfg)) for k, v in params.items()}
    return params


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_dense_layers(gen, cfg: ArchConfig, L: int, device):
    lead = (L,)
    p = {"attn": blocks.init_attention(gen, cfg, lead, device),
         "n1": blocks.init_norm(cfg, lead, device), "n2": blocks.init_norm(cfg, lead, device)}
    if cfg.family == "moe":
        p["moe"] = blocks.init_moe(gen, cfg, lead, device)
        if cfg.moe_dense_residual:
            p["mlp"] = blocks.init_mlp(gen, cfg, cfg.dense_ff or cfg.d_ff, lead, device)
            p["n3"] = blocks.init_norm(cfg, lead, device)
    else:
        p["mlp"] = blocks.init_mlp(gen, cfg, None, lead, device)
    return p


def init_lm(cfg: ArchConfig, gen: torch.Generator, device=None) -> dict:
    """The reference's parameter tree, stacked, drawn from ``gen`` at the
    reference's scales on ``device`` (default: the generator's).  The draws
    are not JAX's threefry: parity runs carry the reference's own
    parameters across (``LM.from_tree``)."""
    device = gen.device if device is None else torch.device(device)
    d, s = cfg.d_model, cfg.d_model ** -0.5
    params: dict[str, Any] = {
        "embed": _normal(gen, (cfg.vocab, d), s, cfg.pdt, device),
        "final_norm": blocks.init_norm(cfg, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(gen, (d, cfg.vocab), s, cfg.pdt, device)

    if cfg.family in ("dense", "moe", "vlm"):
        params["layers"] = _init_dense_layers(gen, cfg, cfg.n_layers, device)
    elif cfg.family == "hybrid":
        n_groups = cfg.n_layers // cfg.attn_every
        params["groups"] = {
            "mamba": ssm.init_mamba2(gen, cfg, (n_groups, cfg.attn_every), device),
            "norms": {"scale": torch.ones((n_groups, cfg.attn_every, d), dtype=cfg.pdt,
                                          device=device)}}
        params["shared_attn"] = blocks.init_attention(gen, cfg, (), device)
        params["shared_norm"] = blocks.init_norm(cfg, device=device)
    elif cfg.family == "ssm":
        n_groups = cfg.n_layers // cfg.slstm_every
        params["groups"] = {
            "mlstm": ssm.init_mlstm(gen, cfg, (n_groups, cfg.slstm_every - 1), device),
            "slstm": ssm.init_slstm(gen, cfg, (n_groups,), device)}
    else:
        raise ValueError(cfg.family)

    if cfg.family == "vlm":
        params["vision_proj"] = _normal(gen, (cfg.vision_dim, d), cfg.vision_dim ** -0.5,
                                        cfg.pdt, device)
    return params


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------
def dense_ffn(lp, h, cfg: ArchConfig):
    """A dense/moe/vlm layer's second half: the MLP, or the routed experts
    (plus arctic's parallel dense MLP), on the normed residual stream."""
    hn = blocks.apply_norm(lp["n2"], h, cfg)
    if cfg.family == "moe":
        delta = blocks.moe_fwd(lp["moe"], hn, cfg)
        if cfg.moe_dense_residual:
            delta = delta + blocks.mlp_fwd(lp["mlp"], blocks.apply_norm(lp["n3"], h, cfg), cfg)
        return delta
    return blocks.mlp_fwd(lp["mlp"], hn, cfg)


def _dense_layer_fwd(lp, h, cfg: ArchConfig, positions):
    h = h + blocks.attention_fwd(lp["attn"], blocks.apply_norm(lp["n1"], h, cfg), cfg,
                                 positions)
    return h + dense_ffn(lp, h, cfg)


def forward_hidden(params, embeds, cfg: ArchConfig, positions=None):
    """Stack of layers over input embeddings (B, S, d) -> final hidden."""
    S = embeds.shape[1]
    if positions is None:
        positions = torch.arange(S, device=embeds.device)[None, :]
    h = embeds

    if cfg.family in ("dense", "moe", "vlm"):
        for i in range(cfg.n_layers):
            h = blocks.constrain_act(_dense_layer_fwd(at(params["layers"], i), h, cfg,
                                                      positions), cfg)
    elif cfg.family == "hybrid":
        shared_attn, shared_norm = params["shared_attn"], params["shared_norm"]
        groups = params["groups"]
        for g in range(cfg.n_layers // cfg.attn_every):
            # shared attention block (tied weights), then attn_every mamba blocks
            h = h + blocks.attention_fwd(shared_attn, blocks.apply_norm(shared_norm, h, cfg),
                                         cfg, positions)
            for j in range(cfg.attn_every):
                o, _, _ = ssm.mamba2_fwd(at(groups["mamba"], (g, j)),
                                         blocks.apply_norm(at(groups["norms"], (g, j)), h, cfg),
                                         cfg)
                h = h + o
            h = blocks.constrain_act(h, cfg)
    elif cfg.family == "ssm":
        groups = params["groups"]
        for g in range(cfg.n_layers // cfg.slstm_every):
            for j in range(cfg.slstm_every - 1):
                o, _ = ssm.mlstm_fwd(at(groups["mlstm"], (g, j)), h, cfg)
                h = h + o
            o, _ = ssm.slstm_fwd(at(groups["slstm"], g), h, cfg)
            h = h + o
    else:
        raise ValueError(cfg.family)

    return blocks.apply_norm(params["final_norm"], h, cfg)


def embed_tokens(params, tokens, cfg: ArchConfig):
    """Gathers the rows, then casts them: the reference's cast-then-gather
    bits without casting the whole table."""
    return params["embed"][tokens].to(cfg.cdt)


def lm_head(params, h, cfg: ArchConfig):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h.to(cfg.cdt) @ w.to(cfg.cdt)


def forward_vlm_embeds(params, tokens, patch_embs, cfg: ArchConfig):
    """VLM: project stub CLIP patch embeddings, prepend to token embeddings."""
    tok = embed_tokens(params, tokens, cfg)
    img = patch_embs.to(cfg.cdt) @ params["vision_proj"].to(cfg.cdt)
    return torch.cat([img, tok], dim=1)


# ---------------------------------------------------------------------------
# loss: chunked cross-entropy — never materializes the full (B, S, vocab)
# logits
# ---------------------------------------------------------------------------
def chunked_xent(params, h, labels, cfg: ArchConfig, chunk: int = 512):
    B, S, d = h.shape
    C = min(chunk, S)
    while S % C:
        C //= 2
    w = (params["embed"].T if cfg.tie_embeddings else params["lm_head"]).to(cfg.cdt)
    total = torch.zeros((), dtype=_F32, device=h.device)
    for c0 in range(0, S, C):
        logits = (h[:, c0:c0 + C].to(cfg.cdt) @ w).to(_F32)  # (B, C, V)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, c0:c0 + C, None].long())[..., 0]
        total = total + (lse - gold).sum()
    return total / (B * S)


def lm_loss(params, batch, cfg: ArchConfig):
    """batch: {tokens (B,S), labels (B,S)} (+ patch_embs for vlm)."""
    if cfg.family == "vlm" and "patch_embs" in batch:
        embeds = forward_vlm_embeds(params, batch["tokens"], batch["patch_embs"], cfg)
        h = forward_hidden(params, embeds, cfg)
        h = h[:, batch["patch_embs"].shape[1]:, :]  # loss over text positions
    else:
        h = forward_hidden(params, embed_tokens(params, batch["tokens"], cfg), cfg)
    return chunked_xent(params, h, batch["labels"], cfg)
