"""SSM-family blocks: chunked gated linear attention (the SSD/mLSTM common
core), Mamba2 blocks, and xLSTM (mLSTM + sLSTM) blocks.

The JAX package's ``models/ssm.py`` function by function.  ``chunked_gla``
implements  S_t = a_t S_{t-1} + k_t v_tᵀ ;  o_t = S_tᵀ q_t  in the
chunk-parallel form (intra-chunk decay-masked attention + inter-chunk state
carry); its ``lax.scan`` over chunks, and sLSTM's over time steps, are
Python loops here.  Decode steps write no state in place: each returns its
new state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import mesh_ops
from .blocks import _normal
from .config import ArchConfig

_F32 = torch.float32


def chunked_gla(q, k, v, log_a, chunk: int | None = None):
    """Gated linear attention, chunk-parallel.

    q, k: (B, S, H, Dk); v: (B, S, H, Dv); log_a: (B, S, H) per-step decay
    (log of a_t in (0, 1]).  Returns o: (B, S, H, Dv) and final state
    (B, H, Dk, Dv).  Chunk size scales with S (>= 128, <= 512), halved
    until it divides S.
    """
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    if chunk is None:
        chunk = max(128, min(512, S // 64))
    C = min(chunk, S)
    while S % C:
        C //= 2

    qf, kf, vf, la = (t.to(_F32) for t in (q, k, v, log_a))
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=q.device))
    S_prev = torch.zeros((B, H, Dk, Dv), dtype=_F32, device=q.device)
    outs = []
    for c0 in range(0, S, C):
        qc, kc, vc = qf[:, c0:c0 + C], kf[:, c0:c0 + C], vf[:, c0:c0 + C]
        A = torch.cumsum(la[:, c0:c0 + C], dim=1)  # (B, C, H) inclusive
        Atot = A[:, -1:, :]  # (B, 1, H)
        # intra-chunk: scores_ij = exp(A_i - A_j) q_i·k_j  for j <= i
        scores = torch.einsum("bihd,bjhd->bhij", qc, kc)
        decay = A[:, :, None, :] - A[:, None, :, :]  # (B, i, j, H)
        w = torch.where(tri[None, :, :, None], torch.exp(decay), 0.0)
        intra = torch.einsum("bhij,bjhv->bihv", scores * w.permute(0, 3, 1, 2), vc)
        # inter-chunk: o_i += exp(A_i) q_i · S_prev
        inter = torch.einsum("bihd,bhdv->bihv", qc * torch.exp(A)[..., None], S_prev)
        # state: S_new = exp(Atot) S_prev + sum_j exp(Atot - A_j) k_j v_j^T
        kdec = kc * torch.exp(Atot - A)[..., None]
        S_prev = (torch.exp(Atot)[..., None].permute(0, 2, 1, 3) * S_prev
                  + torch.einsum("bjhd,bjhv->bhdv", kdec, vc))
        outs.append(intra + inter)
    o = torch.cat(outs, dim=1)
    return o.to(v.dtype), S_prev


def gla_decode_step(S_prev, q, k, v, log_a):
    """One-token recurrent update: q,k (B,H,Dk), v (B,H,Dv), log_a (B,H)."""
    a = torch.exp(log_a.to(_F32))[..., None, None]
    S_new = a * S_prev + torch.einsum("bhd,bhv->bhdv", k.to(_F32), v.to(_F32))
    o = torch.einsum("bhd,bhdv->bhv", q.to(_F32), S_new)
    return S_new, o.to(v.dtype)


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------
def _mamba_split(cfg: ArchConfig):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = max(1, di // 64)  # 64-dim heads (mamba2 default)
    return di, H, cfg.ssm_state


def _promoted(w, o):
    """``w`` in ``o``'s dtype where that is wider: the f32 value path (it
    carries dt) meets the compute-dtype weight as in JAX's type promotion."""
    return w.to(torch.promote_types(w.dtype, o.dtype))


def init_mamba2(gen, cfg: ArchConfig, lead=(), device=None):
    d = cfg.d_model
    di, H, N = _mamba_split(cfg)
    s = d ** -0.5
    return {
        "in_proj": _normal(gen, (*lead, d, 2 * di + 2 * N * H + H), s, cfg.pdt, device),
        "conv_w": _normal(gen, (*lead, cfg.ssm_conv, di), 0.1, cfg.pdt, device),
        "A_log": torch.zeros((*lead, H), dtype=cfg.pdt, device=device),
        "D": torch.ones((*lead, H), dtype=cfg.pdt, device=device),
        "dt_bias": torch.zeros((*lead, H), dtype=cfg.pdt, device=device),
        "out_proj": _normal(gen, (*lead, di, d), di ** -0.5, cfg.pdt, device),
    }


@mesh_ops.replicated
def mamba2_fwd(params, h, cfg: ArchConfig, conv_state=None, ssm_state=None, decode=False):
    """Mamba2 SSD block.  Prefill runs chunked_gla; decode is O(1) with conv
    state (B, K-1, di) and recurrent state (B, H, N, hd)."""
    B = h.shape[0]
    di, H, N = _mamba_split(cfg)
    hd = di // H
    cdt = cfg.cdt
    x = h.to(cdt)
    z, xin, Bv, Cv, dt = torch.split(x @ params["in_proj"].to(cdt),
                                     [di, di, N * H, N * H, H], dim=-1)
    dt = F.softplus(dt.to(_F32) + params["dt_bias"].to(_F32))
    A = -torch.exp(params["A_log"].to(_F32))  # (H,) negative
    w = params["conv_w"].to(cdt)
    D_wide = params["D"].to(cdt).repeat_interleave(hd, dim=-1)  # (di,), element-wise

    if not decode:
        S = h.shape[1]
        K = cfg.ssm_conv
        xpad = F.pad(xin, (0, 0, K - 1, 0))  # causal depthwise conv over time
        xc = F.silu(sum(xpad[:, i:i + S, :] * w[i] for i in range(K)))
        q = Cv.reshape(B, S, H, N)
        k = Bv.reshape(B, S, H, N)
        v = (xc * dt.repeat_interleave(hd, dim=-1)).reshape(B, S, H, hd)
        o, _ = chunked_gla(q, k, v, dt * A)
        o = o.reshape(B, S, di) + xc * D_wide
        o = o * F.silu(z)
        return (o @ _promoted(params["out_proj"].to(cdt), o)).to(h.dtype), None, None

    conv_buf = torch.cat([conv_state, xin[:, :1]], dim=1)  # (B, K, di)
    xc = F.silu((conv_buf * w[None]).sum(1))
    q = Cv[:, 0].reshape(B, H, N)
    k = Bv[:, 0].reshape(B, H, N)
    v = (xc * dt[:, 0].repeat_interleave(hd, dim=-1)).reshape(B, H, hd)
    new_state, o = gla_decode_step(ssm_state, q, k, v, dt[:, 0] * A)
    o = o.reshape(B, 1, di) + (xc * D_wide)[:, None]
    o = o * F.silu(z)
    out = (o @ _promoted(params["out_proj"].to(cdt), o)).to(h.dtype)
    return out, conv_buf[:, 1:], new_state


# ---------------------------------------------------------------------------
# xLSTM blocks
# ---------------------------------------------------------------------------
def init_mlstm(gen, cfg: ArchConfig, lead=(), device=None):
    d, H = cfg.d_model, cfg.n_heads
    s = d ** -0.5
    return {
        "wqkv": _normal(gen, (*lead, d, 3 * d), s, cfg.pdt, device),
        "wgate": _normal(gen, (*lead, d, 2 * H), s, cfg.pdt, device),
        "wo": _normal(gen, (*lead, d, d), s, cfg.pdt, device),
        "wup": _normal(gen, (*lead, d, 2 * d), s, cfg.pdt, device),
        "wdown": _normal(gen, (*lead, d, d), d ** -0.5, cfg.pdt, device),
    }


def _mlstm_out(params, o, cfg: ArchConfig):
    """Output projection, then the block's own gated up/down projection."""
    cdt = cfg.cdt
    out = o @ params["wo"].to(cdt)
    a, b = (out @ params["wup"].to(cdt)).chunk(2, dim=-1)
    return (F.silu(a) * b) @ params["wdown"].to(cdt)


@mesh_ops.replicated
def mlstm_fwd(params, h, cfg: ArchConfig, state=None, decode=False):
    """mLSTM: matrix-memory LSTM == GLA with sigmoid forget / exp input gate.

    The input gate is folded into k, the normalizer is tracked as an extra
    value column (v augmented with ones), per the xLSTM stabilization.
    """
    B = h.shape[0]
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    cdt = cfg.cdt
    x = h.to(cdt)
    q, k, v = (x @ params["wqkv"].to(cdt)).chunk(3, dim=-1)
    gates = x.to(_F32) @ params["wgate"].to(_F32)
    f_raw, i_raw = gates.chunk(2, dim=-1)  # (B, S, H)
    log_f = F.logsigmoid(f_raw)
    i_gate = torch.exp(torch.clamp(i_raw, max=8.0))  # capped exp input gate

    if not decode:
        S = h.shape[1]
        qh = q.reshape(B, S, H, hd) * hd ** -0.5
        kh = k.reshape(B, S, H, hd) * i_gate[..., None].to(cdt)
        vh = v.reshape(B, S, H, hd)
        v_aug = torch.cat([vh, torch.ones((B, S, H, 1), dtype=vh.dtype, device=h.device)], -1)
        o, _ = chunked_gla(qh, kh, v_aug, log_f)
        o = o[..., :hd] / torch.clamp(o[..., hd:].abs(), min=1.0)
        o = o.reshape(B, S, d).to(cdt)
        return _mlstm_out(params, o, cfg).to(h.dtype), None

    qh = (q[:, 0] * hd ** -0.5).reshape(B, H, hd)
    kh = k[:, 0].reshape(B, H, hd) * i_gate[:, 0][..., None].to(cdt)
    vh = v[:, 0].reshape(B, H, hd)
    v_aug = torch.cat([vh, torch.ones((B, H, 1), dtype=vh.dtype, device=h.device)], -1)
    new_state, o = gla_decode_step(state, qh, kh, v_aug, log_f[:, 0])
    o = (o[..., :hd] / torch.clamp(o[..., hd:].abs(), min=1.0)).reshape(B, 1, d).to(cdt)
    return _mlstm_out(params, o, cfg).to(h.dtype), new_state


def init_slstm(gen, cfg: ArchConfig, lead=(), device=None):
    d = cfg.d_model
    s = d ** -0.5
    return {
        "wx": _normal(gen, (*lead, d, 4 * d), s, cfg.pdt, device),
        "wh": _normal(gen, (*lead, d, 4 * d), s, cfg.pdt, device),
        "wo": _normal(gen, (*lead, d, d), s, cfg.pdt, device),
    }


@mesh_ops.replicated
def slstm_fwd(params, h, cfg: ArchConfig, state=None, decode=False):
    """sLSTM: scalar-memory LSTM with recurrence — a true sequential loop.
    Decode state: (2, B, d), the stacked (h, c)."""
    B = h.shape[0]
    d = cfg.d_model
    x = h.to(_F32)
    wx = params["wx"].to(_F32)
    wh = params["wh"].to(_F32)

    def cell(hprev, cprev, xt):
        i, f, z, o = (xt @ wx + hprev @ wh).chunk(4, dim=-1)
        c = torch.sigmoid(f) * cprev + torch.sigmoid(i) * torch.tanh(z)
        return torch.sigmoid(o) * torch.tanh(c), c

    wo = params["wo"].to(cfg.cdt)
    if not decode:
        hn = torch.zeros((B, d), dtype=_F32, device=h.device)
        cn = torch.zeros((B, d), dtype=_F32, device=h.device)
        outs = []
        for t in range(h.shape[1]):
            hn, cn = cell(hn, cn, x[:, t])
            outs.append(hn)
        out = torch.stack(outs, dim=1).to(cfg.cdt)
        return (out @ wo).to(h.dtype), None

    hn, cn = cell(state[0], state[1], x[:, 0])
    out = (hn[:, None, :].to(cfg.cdt) @ wo).to(h.dtype)
    return out, torch.stack([hn, cn])
