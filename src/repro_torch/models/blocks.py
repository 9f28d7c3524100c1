"""Shared model blocks: norms, RoPE, chunked causal attention, MLP, MoE.

The JAX package's ``models/blocks.py`` function by function, over the same
parameter dicts.  Its ``lax.scan`` over KV chunks is a Python loop here.
Parameters are cast to the compute dtype where the reference casts them
(a no-op on a tensor already in it, so ``transformer.compute_copy`` may
cast them once at load).  ``checkpointed`` is the reference's
``jax.checkpoint``: the callers wrap the same bodies it wraps.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import mesh_ops
from .config import ArchConfig

_F32 = torch.float32


def constrain_act(h, cfg: ArchConfig):
    """Between-block activation sharding constraint (SP when act_sp_axis set).

    With sequence parallelism the residual stream lives sharded over the
    model axis on the sequence dim: a ``DTensor`` ``h`` is redistributed to
    ``P(dp, act_sp_axis, None)``, so each tensor-parallel all-reduce becomes a
    reduce-scatter here plus an all-gather at the next matmul (half the
    bytes), and norms and elementwise ops run on 1/P of the tokens.  Without
    ``act_sp_axis`` it is the identity; a plain tensor with ``act_sp_axis``
    set raises, as there is no mesh to constrain it on.
    """
    if cfg.act_sp_axis is None or cfg.act_dp_axes is None:
        return h
    if not mesh_ops.is_dtensor(h):
        raise ValueError(f"constrain_act: act_sp_axis={cfg.act_sp_axis!r} needs a DTensor on "
                         "a mesh, got a plain tensor")
    from repro_torch.parallel import PartitionSpec, placements

    dp = cfg.act_dp_axes if len(cfg.act_dp_axes) > 1 else cfg.act_dp_axes[0]
    place = placements(PartitionSpec(dp, cfg.act_sp_axis, None), h.device_mesh)
    return h if tuple(h.placements) == place else h.redistribute(h.device_mesh, place)


def checkpointed(fn, *args, policy: str = "full"):
    """``fn(*args)``, rematerialized in the backward pass when grad is on
    (the reference's ``jax.checkpoint``; ``torch.utils.checkpoint``,
    non-reentrant).  ``policy="dots"`` also keeps the outputs of
    ``aten.mm`` / ``aten.addmm`` — the weight products, whose operands are
    flattened to two dimensions — as the reference's
    ``checkpoint_dots_with_no_batch_dims`` keeps its dots without batch
    dimensions; any other policy recomputes everything.  Changes no value."""
    if not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            [torch.ops.aten.mm.default, torch.ops.aten.addmm.default])
    return checkpoint(fn, *args, use_reentrant=False, **kw)


def act_fn(a, cfg: ArchConfig):
    """The gate activation: SiLU, or GELU in its tanh form (``jax.nn.gelu``'s
    default)."""
    return F.silu(a) if cfg.activation == "silu" else F.gelu(a, approximate="tanh")


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def init_norm(cfg: ArchConfig, lead=(), device=None):
    if cfg.norm == "nonparam":  # olmo: non-parametric LayerNorm
        return {}
    return {"scale": torch.ones((*lead, cfg.d_model), dtype=cfg.pdt, device=device)}


def apply_norm(params, x, cfg: ArchConfig, eps: float = 1e-5):
    xf = x.to(_F32)
    if cfg.norm == "rms":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        y = y * params["scale"].to(_F32)
    elif cfg.norm in ("layer", "nonparam"):
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if cfg.norm == "layer":
            y = y * params["scale"].to(_F32)
    else:
        raise ValueError(cfg.norm)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(cfg: ArchConfig, device=None):
    hd = cfg.head_dim
    return 1.0 / (cfg.rope_theta ** (torch.arange(0, hd, 2, dtype=_F32, device=device) / hd))


def apply_rope(x, positions, inv_freqs):
    """x: (..., S, H, D); positions: (..., S) int.  Halves, not interleaved
    pairs, rotate together."""
    ang = positions[..., None].to(_F32) * inv_freqs  # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(_F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _normal(gen, shape, scale, dtype, device):
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def init_attention(gen, cfg: ArchConfig, lead=(), device=None):
    """``lead`` prepends stacked axes (the reference's vmapped layers)."""
    d, hd = cfg.d_model, cfg.head_dim
    s = d ** -0.5
    return {
        "wq": _normal(gen, (*lead, d, cfg.n_heads * hd), s, cfg.pdt, device),
        "wk": _normal(gen, (*lead, d, cfg.n_kv_heads * hd), s, cfg.pdt, device),
        "wv": _normal(gen, (*lead, d, cfg.n_kv_heads * hd), s, cfg.pdt, device),
        "wo": _normal(gen, (*lead, cfg.n_heads * hd, d), s, cfg.pdt, device),
    }


@mesh_ops.headwise
def _chunked_causal_attention(q, k, v, window: Optional[int], chunk: int):
    """Flash-style chunked attention: a loop over KV chunks, online softmax.

    q: (B, S, H, D); k, v: (B, S, Hkv, D).  O(S·chunk) live memory.
    """
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = D ** -0.5
    qf = (q * scale).to(_F32).reshape(B, S, Hkv, G, D)
    kf, vf = k.to(_F32), v.to(_F32)
    q_pos = torch.arange(S, device=q.device)
    inf = torch.tensor(float("-inf"), device=q.device)

    m = torch.full((B, S, Hkv, G), float("-inf"), dtype=_F32, device=q.device)
    l = torch.zeros((B, S, Hkv, G), dtype=_F32, device=q.device)
    acc = torch.zeros((B, S, Hkv, G, D), dtype=_F32, device=q.device)
    for j in range(S // chunk):
        kj = kf[:, j * chunk:(j + 1) * chunk]
        vj = vf[:, j * chunk:(j + 1) * chunk]
        kv_pos = j * chunk + torch.arange(chunk, device=q.device)
        s_ = torch.einsum("bshgd,bchd->bshgc", qf, kj)
        mask = q_pos[:, None] >= kv_pos[None, :]  # causal
        if window is not None:
            mask &= (q_pos[:, None] - kv_pos[None, :]) < window
        mask = mask[None, :, None, None, :]
        s_ = torch.where(mask, s_, inf)
        m_new = torch.maximum(m, s_.amax(-1))
        # guard fully-masked rows (m_new = -inf): exp(-inf - -inf) -> nan
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(mask, torch.exp(s_ - m_safe[..., None]), 0.0)
        fin = torch.isfinite(m)
        corr = torch.where(fin, torch.exp(torch.where(fin, m - m_safe, inf)), 0.0)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bshgc,bchd->bshgd", p, vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, S, H, D).to(q.dtype)


def _qkv(params, x, cfg: ArchConfig):
    hd, cdt = cfg.head_dim, cfg.cdt
    q = mesh_ops.split_heads(x @ params["wq"].to(cdt), cfg.n_heads, hd)
    k = mesh_ops.split_heads(x @ params["wk"].to(cdt), cfg.n_kv_heads, hd)
    v = mesh_ops.split_heads(x @ params["wv"].to(cdt), cfg.n_kv_heads, hd)
    return q, k, v


def attention_fwd(params, h, cfg: ArchConfig, positions=None, chunk: int = 512):
    """Full (training/prefill) self-attention with RoPE + GQA (+ SWA).  On a
    mesh it reads ``h`` with its sequence whole and leaves its output in
    ``h``'s placements (``mesh_ops.seq_gathered`` / ``reduced_like``)."""
    S = h.shape[1]
    q, k, v = _qkv(params, mesh_ops.seq_gathered(h).to(cfg.cdt), cfg)
    if positions is None:
        positions = torch.arange(S, device=h.device)[None, :]
    inv = rope_freqs(cfg, h.device)
    q = apply_rope(q, positions, inv)
    k = apply_rope(k, positions, inv)
    ck = min(chunk, S)
    while S % ck:
        ck //= 2
    out = mesh_ops.merge_heads(_chunked_causal_attention(q, k, v, cfg.swa_window, ck))
    return mesh_ops.reduced_like((out @ params["wo"].to(cfg.cdt)).to(h.dtype), h)


def _ring_write(cache, new, pos):
    """Write ``new`` (B, 1, ...) into slot ``pos % Smax`` of ``cache``
    (B, Smax, ...) in place.  ``pos`` is a Python int or a 0-d tensor on the
    cache's device; neither reads the device from the host."""
    Smax = cache.shape[1]
    if mesh_ops.is_dtensor(cache):
        slot = (pos % Smax if isinstance(pos, torch.Tensor)
                else torch.tensor(pos % Smax, device=cache.device))
        mesh_ops.cache_write(cache, new.to(cache.dtype), slot.reshape(1).long())
    elif isinstance(pos, torch.Tensor):
        cache.index_copy_(1, (pos % Smax).reshape(1).long(), new.to(cache.dtype))
    else:
        cache[:, pos % Smax] = new[:, 0].to(cache.dtype)
    return cache


def attention_decode(params, h, cache_k, cache_v, pos, cfg: ArchConfig):
    """One-token decode: h (B, 1, d); cache (B, Smax, Hkv, D); pos a Python
    int or a 0-d int tensor.

    Returns (out, cache_k, cache_v), the caches written in place.  For SWA
    archs the cache is a ring buffer of size window; positions wrap modulo
    the window.
    """
    B = h.shape[0]
    hd = cfg.head_dim
    q, k, v = _qkv(params, h.to(cfg.cdt), cfg)
    inv = rope_freqs(cfg, h.device)
    if isinstance(pos, torch.Tensor):
        posb = pos.to(torch.int32).reshape(1, 1).expand(B, 1)
    else:
        posb = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
    q = apply_rope(q, posb, inv)
    k = apply_rope(k, posb, inv)
    _ring_write(cache_k, k, pos)  # a no-op ring when Smax >= S
    _ring_write(cache_v, v, pos)
    out = _decode_core(q, cache_k, cache_v, pos)
    out = out.reshape(B, 1, cfg.n_heads * hd).to(cfg.cdt)
    return (mesh_ops.reduced_like((out @ params["wo"].to(cfg.cdt)).to(h.dtype), h),
            cache_k, cache_v)


@mesh_ops.headwise
def _decode_core(q, cache_k, cache_v, pos):
    """One query token against the cache: q (B, 1, H, D), cache (B, Smax,
    Hkv, D) -> (B, 1, H, D) in f32."""
    B, _, H, hd = q.shape
    Smax, Hkv = cache_k.shape[1:3]
    qf = (q * hd ** -0.5).to(_F32).reshape(B, Hkv, H // Hkv, hd)
    s_ = torch.einsum("bhgd,bshd->bhgs", qf, cache_k.to(_F32))  # (B, Hkv, G, Smax)
    idx = torch.arange(Smax, device=q.device)
    # pre-wrap: only slots <= pos are live; post-wrap (ring): all slots live
    valid = (idx <= pos) | (pos >= Smax)
    s_ = s_.masked_fill(~valid, float("-inf"))
    p = torch.softmax(s_, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, cache_v.to(_F32))
    return out.reshape(B, 1, H, hd)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def init_mlp(gen, cfg: ArchConfig, d_ff: Optional[int] = None, lead=(), device=None):
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    s = d ** -0.5
    p = {"w1": _normal(gen, (*lead, d, ff), s, cfg.pdt, device),
         "w2": _normal(gen, (*lead, ff, d), ff ** -0.5, cfg.pdt, device)}
    if cfg.activation != "sq_relu":  # gated variants carry w3
        p["w3"] = _normal(gen, (*lead, d, ff), s, cfg.pdt, device)
    return p


def mlp_fwd(params, h, cfg: ArchConfig):
    """The MLP; on a mesh placed as ``attention_fwd``."""
    cdt = cfg.cdt
    x = mesh_ops.seq_gathered(h).to(cdt)
    a = x @ params["w1"].to(cdt)
    if cfg.activation == "sq_relu":  # nemotron: squared ReLU, ungated
        inner = torch.square(torch.relu(a))
    else:
        inner = act_fn(a, cfg) * (x @ params["w3"].to(cdt))
    return mesh_ops.reduced_like((inner @ params["w2"].to(cdt)).to(h.dtype), h)


# ---------------------------------------------------------------------------
# MoE (capacity-based scatter dispatch + batched expert GEMM)
# ---------------------------------------------------------------------------
def init_moe(gen, cfg: ArchConfig, lead=(), device=None):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = d ** -0.5
    return {
        "router": _normal(gen, (*lead, d, E), s, _F32, device),
        "w1": _normal(gen, (*lead, E, d, ff), s, cfg.pdt, device),
        "w2": _normal(gen, (*lead, E, ff, d), ff ** -0.5, cfg.pdt, device),
        "w3": _normal(gen, (*lead, E, d, ff), s, cfg.pdt, device),
    }


def moe_groups(T: int, cfg: ArchConfig) -> tuple:
    """(G, Tg, Cg): dispatch groups, tokens a group and capacity a group
    (an expert's slots), in Python numbers as the reference computes them."""
    G = max(1, min(cfg.moe_groups, T))
    while T % G:
        G //= 2
    Tg = T // G
    Cg = max(4, int(cfg.capacity_factor * cfg.top_k * Tg / cfg.n_experts + 0.5))
    return G, Tg, Cg


def moe_route(router, x, cfg: ArchConfig, Cg: int):
    """Routing of x (G, Tg, d): gates (G, Tg, k), expert ids and each
    (token, slot)'s rank within its expert (G, Tg·k), and whether it fits
    the capacity.  Ties in the top-k go to the lower expert index."""
    G, Tg, _ = x.shape
    k = cfg.top_k
    gate_all = torch.softmax(x.to(_F32) @ router, dim=-1)  # (G, Tg, E)
    vals, order = torch.sort(gate_all, dim=-1, descending=True, stable=True)
    gates, ids = vals[..., :k], order[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    flat_ids = ids.reshape(G, Tg * k)
    # rank of each (token, slot) within its expert: stable sort by expert,
    # then the distance to the first entry of that expert
    order = torch.argsort(flat_ids, dim=-1, stable=True)
    sorted_ids = torch.gather(flat_ids, 1, order)
    first = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    ranks = torch.arange(Tg * k, device=x.device)[None, :] - first
    pos = torch.zeros_like(flat_ids).scatter_(1, order, ranks)
    return gates, flat_ids, pos, pos < Cg


@mesh_ops.replicated
def moe_fwd(params, h, cfg: ArchConfig):
    """Top-k routed experts, GShard-style grouped capacity dispatch.

    Tokens split into ``moe_groups`` groups; capacity, sort, scatter and
    gather are per group.  A (token, slot) over capacity is dropped: parked
    at slot Cg-1 with a zero source, which adds exactly nothing.  Expert
    compute is one batched GEMM (G, E, Cg, d) @ (E, d, f).
    """
    B, S, d = h.shape
    E, k, cdt = cfg.n_experts, cfg.top_k, cfg.cdt
    G, Tg, Cg = moe_groups(B * S, cfg)
    x = h.reshape(G, Tg, d).to(cdt)
    gates, flat_ids, pos, keep = moe_route(params["router"], x, cfg, Cg)

    tok_idx = torch.arange(Tg * k, device=h.device) // k
    src = torch.where(keep[..., None], x[:, tok_idx, :], 0.0)  # (G, Tg*k, d)
    slot = torch.where(keep, pos, Cg - 1)
    g_idx = torch.arange(G, device=h.device)[:, None].expand(G, Tg * k)
    disp = torch.zeros((G, E, Cg, d), dtype=cdt, device=h.device)
    disp.index_put_((g_idx, flat_ids, slot), src, accumulate=True)

    a = torch.einsum("gecd,edf->gecf", disp, params["w1"].to(cdt))
    if cfg.activation == "sq_relu":
        inner = torch.square(torch.relu(a))
    else:
        inner = act_fn(a, cfg) * torch.einsum("gecd,edf->gecf", disp, params["w3"].to(cdt))
    eo = torch.einsum("gecf,efd->gecd", inner, params["w2"].to(cdt))

    # combine: per-group gather of each (token, slot)'s expert output
    gathered = eo[g_idx, flat_ids, pos.clamp(0, Cg - 1)]  # (G, Tg*k, d)
    gathered = torch.where(keep[..., None], gathered, 0.0)
    weighted = gathered * gates.reshape(G, Tg * k, 1).to(cdt)
    out = weighted.reshape(G, Tg, k, d).sum(2)
    return out.reshape(B, S, d).to(h.dtype)
