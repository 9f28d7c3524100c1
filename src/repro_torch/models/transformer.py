"""Decoder-only LM covering the dense / moe / vlm / ssm / hybrid families.

The JAX package's ``models/transformer.py`` over the same parameter tree in
its stacked layout (``layers/attn/wq`` is ``(L, d, H·hd)``); its layer
``lax.scan`` is a Python loop over the stacked axis (``unstack``).  The
reference's remat wraps the same bodies here (``blocks.checkpointed``): each
dense/moe/vlm layer by ``cfg.remat_policy``, each hybrid and xLSTM group,
and each chunk of ``chunked_xent``; it applies only when grad is on and
changes no value.
"""
from __future__ import annotations

from typing import Any

import torch

from . import blocks, mesh_ops, ssm
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


def unstack(tree, n: int) -> list:
    """The ``n`` entries of a stacked tree along its first axis, as a list
    of trees (``torch.unbind``: views, no copy; in the backward pass their
    gradients meet in one stack, not in ``n`` full-size sums)."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return torch.unbind(mesh_ops.unsharded(tree, 0))


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
        def layer(lp, h):
            return blocks.constrain_act(_dense_layer_fwd(lp, h, cfg, positions), cfg)

        for lp in unstack(params["layers"], cfg.n_layers):
            h = blocks.checkpointed(layer, lp, h, policy=cfg.remat_policy)
    elif cfg.family == "hybrid":
        shared_attn, shared_norm = params["shared_attn"], params["shared_norm"]

        def group(gp, h):
            # shared attention block (tied weights), then attn_every mamba blocks
            h = h + blocks.attention_fwd(shared_attn, blocks.apply_norm(shared_norm, h, cfg),
                                         cfg, positions)
            for mp, norm in zip(unstack(gp["mamba"], cfg.attn_every),
                                unstack(gp["norms"], cfg.attn_every)):
                o, _, _ = ssm.mamba2_fwd(mp, blocks.apply_norm(norm, h, cfg), cfg)
                h = h + o
            return blocks.constrain_act(h, cfg)

        for gp in unstack(params["groups"], cfg.n_layers // cfg.attn_every):
            h = blocks.checkpointed(group, gp, h)
    elif cfg.family == "ssm":
        def group(gp, h):
            for mp in unstack(gp["mlstm"], cfg.slstm_every - 1):
                o, _ = ssm.mlstm_fwd(mp, h, cfg)
                h = h + o
            o, _ = ssm.slstm_fwd(gp["slstm"], h, cfg)
            return h + o

        for gp in unstack(params["groups"], cfg.n_layers // cfg.slstm_every):
            h = blocks.checkpointed(group, gp, h)
    else:
        raise ValueError(cfg.family)

    # the head reads the whole sequence (sequence parallelism's last gather)
    return mesh_ops.seq_gathered(blocks.apply_norm(params["final_norm"], h, cfg))


def embed_tokens(params, tokens, cfg: ArchConfig):
    """The rows of ``tokens``, cast to the compute dtype.  Without a
    gradient to take, gathers the rows, then casts them: the reference's
    cast-then-gather bits without casting the whole table.  With one, casts
    the table first as the reference does, so that repeated tokens' row
    gradients sum in the compute dtype as the reference's do.  A table
    sharded over a mesh is looked up vocab-parallel (``mesh_ops``)."""
    e = params["embed"]
    if mesh_ops.is_dtensor(e):
        return mesh_ops.vocab_parallel_lookup(e.to(cfg.cdt), tokens)
    if torch.is_grad_enabled() and e.requires_grad:
        return e.to(cfg.cdt)[tokens]
    return e[tokens].to(cfg.cdt)


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

    def chunk_loss(hx, lx):
        return _xent_sum((hx.to(cfg.cdt) @ w).to(_F32), lx)  # logits (B, C, V)

    total = torch.zeros((), dtype=_F32, device=h.device)
    for c0 in range(0, S, C):
        total = total + blocks.checkpointed(chunk_loss, h[:, c0:c0 + C], labels[:, c0:c0 + C])
    return total / (B * S)


@mesh_ops.batchwise_sum
def _xent_sum(logits, labels):
    """Summed cross-entropy of ``logits`` (B, C, V) against ``labels`` (B, C)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (lse - gold).sum()


def lm_loss(params, batch, cfg: ArchConfig):
    """batch: {tokens (B,S), labels (B,S)} (+ patch_embs for vlm)."""
    if cfg.family == "vlm" and "patch_embs" in batch:
        embeds = forward_vlm_embeds(params, batch["tokens"], batch["patch_embs"], cfg)
        h = forward_hidden(params, embeds, cfg)
        h = h[:, batch["patch_embs"].shape[1]:, :]  # loss over text positions
    else:
        h = forward_hidden(params, embed_tokens(params, batch["tokens"], cfg), cfg)
    return chunked_xent(params, h, batch["labels"], cfg)
