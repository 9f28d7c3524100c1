"""The port's LM stack (``repro_torch.models``) against the JAX package's.

The same numpy inputs go through each reference function and its port; the
reference's own parameters cross over through ``repro_torch.convert`` /
``LM.from_tree``.  Tolerances are max|diff| / rms(reference): 1e-5 for a
block at float32 compute, 1e-4 for logits and losses.  At the default
bfloat16 compute the bound is 2e-2 (the reference's own decode-against-
prefill bound, ``tests/test_arch_smoke.py``) or 1.5x the reference's own
bfloat16 rounding, whichever is larger: the distance of the reference's
bfloat16 run from its float32 run on the same inputs, read in the same test.
Two bfloat16 runs that round in different places disagree by about that
much (XLA keeps some of a fusion's intermediates in float32; PyTorch rounds
every op), and at these configs it exceeds 2e-2.  Smoke-size configs only.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import blocks as jb
from repro.models import encdec as je
from repro.models import serve as jserve
from repro.models import ssm as jssm
from repro.models import transformer as jt
from repro.models.config import ArchConfig as JaxArchConfig
from repro_torch.configs import get_config
from repro_torch.convert import from_numpy
from repro_torch.models import LM, EncDec
from repro_torch.models import blocks as tb
from repro_torch.models import encdec as te
from repro_torch.models import serve as tserve
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt
from repro_torch.models.config import ArchConfig
from repro_torch.testing.lm_check import decode_vs_prefill, no_drop_f32, rel_err

F32_BLOCK, F32_LOGITS, BF16 = 1e-5, 1e-4, 2e-2
FAMILY_ARCH = {"dense": "olmo-1b", "moe": "mixtral-8x22b", "vlm": "phi-3-vision-4.2b",
               "hybrid": "zamba2-1.2b", "ssm": "xlstm-125m"}


def _np(x):
    """A JAX or numpy array as float64/int numpy (bf16 widened exactly)."""
    a = np.asarray(x)
    return a.astype(np.float64) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


def rel(got, want) -> float:
    g = got.detach().double() if isinstance(got, torch.Tensor) else torch.as_tensor(_np(got))
    return rel_err(g, torch.as_tensor(_np(want)))


def bf16_bound(ref16, ref32) -> float:
    """The bound on the port's distance from the reference's bfloat16 run:
    2e-2, or 1.5x that run's own distance from its float32 run."""
    return max(BF16, 1.5 * rel(ref16, ref32))


def tree_rel(got: dict, want: dict) -> float:
    assert set(got) == set(want), (sorted(got), sorted(want))
    return max((rel(got[k], want[k]) if not isinstance(got[k], dict)
                else tree_rel(got[k], want[k]) for k in got), default=0.0)


def pair(jcfg: JaxArchConfig, **kw):
    """The reference's config (with ``kw``) and the port's with equal fields."""
    jcfg = dataclasses.replace(jcfg, **kw)
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg))


def arch_pair(arch: str, compute="float32", **kw):
    return pair(jax_get_config(arch, smoke=True), compute_dtype=compute, **kw)


def t(x, dtype=None):
    """A numpy/JAX array as a CPU tensor (bf16 bit for bit)."""
    out = from_numpy(np.asarray(x), device="cpu")
    return out if dtype is None else out.to(dtype)


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def tiny(**kw) -> tuple:
    base = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=48, vocab=64, param_dtype="float32", compute_dtype="float32")
    base.update(kw)
    return JaxArchConfig(**base), ArchConfig(**base)


@functools.lru_cache(maxsize=None)
def jax_params(jcfg: JaxArchConfig, seed: int = 0):
    key = jax.random.PRNGKey(seed)
    p = je.init_encdec(jcfg, key) if jcfg.family == "encdec" else jt.init_lm(jcfg, key)
    return jax.tree.map(np.asarray, p)


def port_model(tcfg: ArchConfig, np_params):
    cls = EncDec if tcfg.family == "encdec" else LM
    return cls.from_tree(tcfg, np_params, device="cpu")


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize("norm", ["rms", "layer", "nonparam"])
def test_norm(norm):
    rng = np.random.default_rng(0)
    jcfg, tcfg = tiny(norm=norm)
    x = rand(rng, 2, 5, 32, scale=3.0)
    params = {} if norm == "nonparam" else {"scale": rand(rng, 32)}
    want = jb.apply_norm(params, jnp.asarray(x), jcfg)
    got = tb.apply_norm(from_numpy(params, device="cpu"), t(x), tcfg)
    assert rel(got, want) <= F32_BLOCK


def test_rope():
    rng = np.random.default_rng(1)
    jcfg, tcfg = tiny(d_model=64, n_heads=4)
    x = rand(rng, 2, 7, 4, 16)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    want = jb.apply_rope(jnp.asarray(x), jnp.asarray(pos), jb.rope_freqs(jcfg))
    got = tb.apply_rope(t(x), t(pos), tb.rope_freqs(tcfg))
    assert rel(got, want) <= F32_BLOCK


@pytest.mark.parametrize("window,chunk", [(None, 4), (5, 4), (3, 8), (None, 16)])
def test_chunked_causal_attention(window, chunk):
    """A window shorter than a chunk leaves whole (row, chunk) pairs masked:
    the online softmax's guards keep them finite."""
    rng = np.random.default_rng(2)
    q, k, v = rand(rng, 2, 16, 4, 8), rand(rng, 2, 16, 2, 8), rand(rng, 2, 16, 2, 8)
    want = jb._chunked_causal_attention(*map(jnp.asarray, (q, k, v)), window, chunk)
    got = tb._chunked_causal_attention(t(q), t(k), t(v), window, chunk)
    assert torch.isfinite(got).all()
    assert rel(got, want) <= F32_BLOCK


@pytest.mark.parametrize("window", [None, 6])
def test_attention_fwd(window):
    rng = np.random.default_rng(3)
    jcfg, tcfg = tiny(swa_window=window)
    params = jax.tree.map(np.asarray, jb.init_attention(jax.random.PRNGKey(0), jcfg))
    h = rand(rng, 2, 12, 32)
    want = jb.attention_fwd(params, jnp.asarray(h), jcfg, chunk=4)
    got = tb.attention_fwd(from_numpy(params, device="cpu"), t(h), tcfg, chunk=4)
    assert rel(got, want) <= F32_BLOCK


@pytest.mark.parametrize("pos", [3, 7, 11, 20])
@pytest.mark.parametrize("pos_as_tensor", [False, True])
def test_attention_decode_ring(pos, pos_as_tensor):
    """Smax = 8: positions 3 and 7 are pre-wrap (slots <= pos live), 11 and
    20 post-wrap (every slot live, the write at pos % 8)."""
    rng = np.random.default_rng(4 + pos)
    jcfg, tcfg = tiny()
    params = jax.tree.map(np.asarray, jb.init_attention(jax.random.PRNGKey(1), jcfg))
    h = rand(rng, 2, 1, 32)
    ck, cv = rand(rng, 2, 8, 2, 8), rand(rng, 2, 8, 2, 8)
    want = jb.attention_decode(params, jnp.asarray(h), jnp.asarray(ck), jnp.asarray(cv),
                               jnp.int32(pos), jcfg)
    tp = torch.tensor(pos, dtype=torch.int32) if pos_as_tensor else pos
    got = tb.attention_decode(from_numpy(params, device="cpu"), t(h), t(ck), t(cv), tp, tcfg)
    for g, w in zip(got, want):
        assert rel(g, w) <= F32_BLOCK


@pytest.mark.parametrize("activation", ["silu", "gelu", "sq_relu"])
def test_mlp(activation):
    rng = np.random.default_rng(5)
    jcfg, tcfg = tiny(activation=activation)
    params = jax.tree.map(np.asarray, jb.init_mlp(jax.random.PRNGKey(2), jcfg))
    h = rand(rng, 2, 6, 32, scale=2.0)
    want = jb.mlp_fwd(params, jnp.asarray(h), jcfg)
    got = tb.mlp_fwd(from_numpy(params, device="cpu"), t(h), tcfg)
    assert rel(got, want) <= F32_BLOCK


def test_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation; erf differs in
    the 4th digit at 1.0."""
    a = np.linspace(-4, 4, 101).astype(np.float32)
    _, tcfg = tiny(activation="gelu")
    got = tb.act_fn(t(a), tcfg)
    assert rel(got, jax.nn.gelu(jnp.asarray(a))) <= 1e-6
    assert float(tb.act_fn(torch.ones(1), tcfg)) == pytest.approx(0.84119, abs=2e-5)


# ------------------------------------------------------------------ MoE
def moe_pair(G=1, E=4, k=2, cf=8.0, activation="silu"):
    return tiny(family="moe", n_experts=E, top_k=k, capacity_factor=cf, moe_groups=G,
                activation=activation)


def jax_route(params, h, cfg):
    """The reference's routing (``blocks.moe_fwd``'s lines up to ``keep``):
    moe_fwd returns only the combined output."""
    B, S, d = h.shape
    T, E, k = B * S, cfg.n_experts, cfg.top_k
    G = max(1, min(cfg.moe_groups, T))
    while T % G:
        G //= 2
    Tg = T // G
    Cg = max(4, int(cfg.capacity_factor * k * Tg / E + 0.5))
    x = h.reshape(G, Tg, d).astype(cfg.cdt)
    gate_all = jax.nn.softmax(x.astype(jnp.float32) @ params["router"], axis=-1)
    gates, ids = jax.lax.top_k(gate_all, k)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    flat_ids = ids.reshape(G, Tg * k).astype(jnp.int32)
    order = jnp.argsort(flat_ids, axis=-1, stable=True).astype(jnp.int32)
    sorted_ids = jnp.take_along_axis(flat_ids, order, axis=-1)
    first = jax.vmap(lambda s: jnp.searchsorted(s, s, side="left"))(sorted_ids)
    ranks = (jnp.arange(Tg * k)[None, :] - first).astype(jnp.int32)
    pos = jax.vmap(lambda p, o, r: p.at[o].set(r))(jnp.zeros((G, Tg * k), jnp.int32),
                                                    order, ranks)
    return gates, flat_ids, pos, pos < Cg, Cg


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_matches_reference(G, cf):
    """cf = 0.5 drops slots; ids, ranks and keep are the same bits."""
    rng = np.random.default_rng(6 + G)
    jcfg, tcfg = moe_pair(G=G, cf=cf)
    params = jax.tree.map(np.asarray, jb.init_moe(jax.random.PRNGKey(3), jcfg))
    h = rand(rng, 2, 16, 32)
    gates, ids, pos, keep, Cg = jax_route(params, jnp.asarray(h), jcfg)
    G_, Tg, Cg_ = tb.moe_groups(32, tcfg)
    assert Cg_ == Cg
    tg, tids, tpos, tkeep = tb.moe_route(t(params["router"]), t(h).reshape(G_, Tg, 32),
                                         tcfg, Cg_)
    assert np.array_equal(tids.numpy(), np.asarray(ids))
    assert np.array_equal(tpos.numpy(), np.asarray(pos))
    assert np.array_equal(tkeep.numpy(), np.asarray(keep))
    if cf < 1:
        assert not bool(tkeep.all())
    assert rel(tg, gates) <= F32_BLOCK
    want = jb.moe_fwd(params, jnp.asarray(h), jcfg)
    got = tb.moe_fwd(from_numpy(params, device="cpu"), t(h), tcfg)
    assert rel(got, want) <= F32_BLOCK


def test_moe_top_k_ties_go_to_the_lower_index():
    _, tcfg = moe_pair(E=4, k=2)
    router = torch.zeros((32, 4))  # every gate equal
    _, ids, pos, keep = tb.moe_route(router, torch.ones((1, 3, 32)), tcfg, 8)
    assert ids.tolist() == [[0, 1, 0, 1, 0, 1]]
    assert pos.tolist() == [[0, 0, 1, 1, 2, 2]] and bool(keep.all())


def _brute_force(params, h, cfg):
    """Sum_k gate_k * expert_mlp_k(token) with no capacity limit (the port's
    copy of ``tests/test_moe.py``'s oracle)."""
    B, S, d = h.shape
    x = h.reshape(-1, d)
    gates, ids = torch.topk(torch.softmax(x @ params["router"], dim=-1), cfg.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    out = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        eo = (torch.nn.functional.silu(x @ params["w1"][e]) * (x @ params["w3"][e])) \
            @ params["w2"][e]
        for slot in range(cfg.top_k):
            out = out + torch.where(ids[:, slot] == e, gates[:, slot], 0.0)[:, None] * eo
    return out.reshape(B, S, d)


def _moe_init(cfg, seed):
    return tb.init_moe(torch.Generator().manual_seed(seed), cfg)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_grouped_dispatch_matches_oracle(G):
    """With ample capacity (no drops), grouped dispatch == dense oracle."""
    _, cfg = moe_pair(G=G)
    params = _moe_init(cfg, 0)
    h = torch.randn((2, 16, 32), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(tb.moe_fwd(params, h, cfg), _brute_force(params, h, cfg),
                               atol=1e-5, rtol=0)


def test_group_counts_do_not_change_math():
    """Same tokens, different G: identical outputs when capacity is ample."""
    (_, cfg1), (_, cfg4) = moe_pair(G=1), moe_pair(G=4)
    params = _moe_init(cfg1, 2)
    h = torch.randn((2, 16, 32), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(tb.moe_fwd(params, h, cfg1), tb.moe_fwd(params, h, cfg4),
                               atol=1e-5, rtol=0)


def test_capacity_drops_are_bounded():
    """With tight capacity, outputs stay finite and dropped tokens get 0."""
    _, cfg = moe_pair(G=2, cf=0.25)  # deliberately starved
    params = _moe_init(cfg, 4)
    h = torch.randn((2, 32, 32), generator=torch.Generator().manual_seed(5))
    out = tb.moe_fwd(params, h, cfg)
    assert torch.isfinite(out).all()
    full = tb.moe_fwd(params, h, moe_pair(G=2, cf=8.0)[1])
    assert float(out.abs().sum()) <= float(full.abs().sum()) + 1e-3


# ------------------------------------------------------------------ SSM
@pytest.mark.parametrize("S,chunk", [(24, 16), (24, None), (40, 8)])
def test_chunked_gla(S, chunk):
    """S = 24 with chunk 16 halves the chunk to 8."""
    rng = np.random.default_rng(7)
    q, k = rand(rng, 2, S, 3, 5), rand(rng, 2, S, 3, 5)
    v = rand(rng, 2, S, 3, 6)
    la = -np.abs(rand(rng, 2, S, 3, scale=0.3))
    want = jssm.chunked_gla(*map(jnp.asarray, (q, k, v, la)), chunk=chunk)
    got = tssm.chunked_gla(t(q), t(k), t(v), t(la), chunk=chunk)
    assert rel(got[0], want[0]) <= F32_BLOCK
    assert rel(got[1], want[1]) <= F32_BLOCK


def test_gla_decode_step():
    rng = np.random.default_rng(8)
    S0, q, k, v = rand(rng, 2, 3, 5, 6), rand(rng, 2, 3, 5), rand(rng, 2, 3, 5), rand(rng, 2, 3, 6)
    la = -np.abs(rand(rng, 2, 3))
    want = jssm.gla_decode_step(*map(jnp.asarray, (S0, q, k, v, la)))
    got = tssm.gla_decode_step(t(S0), t(q), t(k), t(v), t(la))
    for g, w in zip(got, want):
        assert rel(g, w) <= F32_BLOCK


def _ssm_case(kind, seed):
    """(jcfg, tcfg, params as numpy, init fn name) for one SSM block."""
    if kind == "mamba2":
        jcfg, tcfg = arch_pair("zamba2-1.2b")
        p = jssm.init_mamba2(jax.random.PRNGKey(seed), jcfg)
        # nonzero A_log / dt_bias and non-unit D, so every term shows
        rng = np.random.default_rng(seed)
        p = {**p, **{k: jnp.asarray(rand(rng, *p[k].shape, scale=0.5))
                     for k in ("A_log", "dt_bias", "D")}}
    elif kind == "mlstm":
        jcfg, tcfg = arch_pair("xlstm-125m")
        p = jssm.init_mlstm(jax.random.PRNGKey(seed), jcfg)
    else:
        jcfg, tcfg = arch_pair("xlstm-125m")
        p = jssm.init_slstm(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
def test_ssm_block_prefill(kind):
    jcfg, tcfg, p = _ssm_case(kind, 9)
    h = rand(np.random.default_rng(9), 2, 20, jcfg.d_model)
    jfn = {"mamba2": jssm.mamba2_fwd, "mlstm": jssm.mlstm_fwd, "slstm": jssm.slstm_fwd}[kind]
    tfn = {"mamba2": tssm.mamba2_fwd, "mlstm": tssm.mlstm_fwd, "slstm": tssm.slstm_fwd}[kind]
    want = jfn(p, jnp.asarray(h), jcfg)[0]
    got = tfn(from_numpy(p, device="cpu"), t(h), tcfg)[0]
    # mLSTM divides the GLA output by max(|den|, 1), den varying widely
    # across rows: that amplifies the GLA core's f32 roundoff past 1e-5
    assert rel(got, want) <= (F32_LOGITS if kind == "mlstm" else F32_BLOCK)


@pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
def test_ssm_block_decode(kind):
    jcfg, tcfg, p = _ssm_case(kind, 10)
    rng = np.random.default_rng(10)
    h = rand(rng, 2, 1, jcfg.d_model)
    tp = from_numpy(p, device="cpu")
    if kind == "mamba2":
        di, H, N = jssm._mamba_split(jcfg)
        conv, st = rand(rng, 2, jcfg.ssm_conv - 1, di), rand(rng, 2, H, N, di // H)
        want = jssm.mamba2_fwd(p, jnp.asarray(h), jcfg, conv_state=jnp.asarray(conv),
                               ssm_state=jnp.asarray(st), decode=True)
        got = tssm.mamba2_fwd(tp, t(h), tcfg, conv_state=t(conv), ssm_state=t(st), decode=True)
    else:
        d, H = jcfg.d_model, jcfg.n_heads
        shape = (2, H, d // H, d // H + 1) if kind == "mlstm" else (2, 2, d)
        st = rand(rng, *shape, scale=0.5)
        jfn, tfn = ((jssm.mlstm_fwd, tssm.mlstm_fwd) if kind == "mlstm"
                    else (jssm.slstm_fwd, tssm.slstm_fwd))
        want = jfn(p, jnp.asarray(h), jcfg, state=jnp.asarray(st), decode=True)
        got = tfn(tp, t(h), tcfg, state=t(st), decode=True)
    for g, w in zip(got, want):
        assert rel(g, w) <= F32_BLOCK


# ------------------------------------------------------------------ whole LM
def _batch(jcfg, seed, B=2, S=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if jcfg.family == "vlm":
        batch["patch_embs"] = rand(rng, B, jcfg.n_patches, jcfg.vision_dim)
    if jcfg.family == "encdec":
        batch["frames"] = rand(rng, B, S // jcfg.enc_downsample, jcfg.d_model)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_forward(jcfg):
    def fwd(params, batch):
        if jcfg.family == "vlm":
            emb = jt.forward_vlm_embeds(params, batch["tokens"], batch["patch_embs"], jcfg)
        else:
            emb = jt.embed_tokens(params, batch["tokens"], jcfg)
        return jt.lm_head(params, jt.forward_hidden(params, emb, jcfg), jcfg), \
            jt.lm_loss(params, batch, jcfg)
    return jax.jit(fwd)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_lm_forward_and_loss(family, compute):
    j32, _ = arch_pair(FAMILY_ARCH[family])
    jcfg, tcfg = arch_pair(FAMILY_ARCH[family], compute)
    params = jax_params(j32)
    batch = _batch(jcfg, 11)
    want_logits, want_loss = _jax_forward(jcfg)(params, batch)
    model = port_model(tcfg, params)
    tbatch = from_numpy(batch, device="cpu")
    got_logits = model(tbatch["tokens"], tbatch.get("patch_embs"))
    got_loss = tt.lm_loss(model.tree(), tbatch, tcfg)
    tol = F32_LOGITS
    if compute == "bfloat16":
        tol = bf16_bound(want_logits, _jax_forward(j32)(params, batch)[0])
    assert got_logits.dtype == tcfg.cdt
    assert rel(got_logits, want_logits) <= tol
    assert abs(float(got_loss) - float(want_loss)) <= tol * abs(float(want_loss))


@functools.lru_cache(maxsize=None)
def _jax_encdec(jcfg):
    def fwd(params, batch):
        enc = je.encode(params, batch["frames"], jcfg)
        h = je.decode_train(params, batch["tokens"], enc, jcfg)
        return enc, h, je.precompute_cross_kv(params, enc, jcfg), je.encdec_loss(params, batch, jcfg)
    return jax.jit(fwd)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_encdec_forward_and_loss(compute):
    j32, _ = arch_pair("seamless-m4t-large-v2")
    jcfg, tcfg = arch_pair("seamless-m4t-large-v2", compute)
    params = jax_params(j32)
    batch = _batch(jcfg, 12)
    enc, h, (xk, xv), loss = want = _jax_encdec(jcfg)(params, batch)
    model = port_model(tcfg, params)
    p = model.tree()
    tbatch = from_numpy(batch, device="cpu")
    tenc = te.encode(p, tbatch["frames"], tcfg)
    th = te.decode_train(p, tbatch["tokens"], tenc, tcfg)
    txk, txv = te.precompute_cross_kv(p, tenc, tcfg)
    tloss = te.encdec_loss(p, tbatch, tcfg)
    tols = [F32_LOGITS] * 4
    if compute == "bfloat16":
        enc32, h32, (xk32, xv32), _ = _jax_encdec(j32)(params, batch)
        tols = [bf16_bound(a, b) for a, b in zip(want[:2] + want[2], (enc32, h32, xk32, xv32))]
    for g, w, tol in zip((tenc, th, txk, txv), (enc, h, xk, xv), tols):
        assert g.shape == w.shape and rel(g, w) <= tol
    assert abs(float(tloss) - float(loss)) <= max(tols) * abs(float(loss))
    logits = model(tbatch["frames"], tbatch["tokens"])  # EncDec.forward
    assert rel(logits, jt.lm_head(params, h, jcfg)) <= max(tols)


# ------------------------------------------------------------------ decode
@functools.lru_cache(maxsize=None)
def _jax_step(jcfg):
    return jax.jit(lambda p, c, tok, pos: jserve.decode_step(p, c, tok, pos, jcfg))


@functools.lru_cache(maxsize=None)
def _jax_cross(jcfg):
    return jax.jit(lambda p, frames: je.precompute_cross_kv(p, je.encode(p, frames, jcfg), jcfg))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCH) + ["encdec"])
def test_decode_step_eight_steps(family, compute):
    """8 steps, each fed the reference's greedy token; the whole cache tree
    is held after the last (SWA archs: the 16-slot ring of a 24-long
    cache).  At bfloat16 the reference also runs at float32 on the same
    tokens, for the bound."""
    arch = FAMILY_ARCH.get(family, "seamless-m4t-large-v2")
    j32, _ = arch_pair(arch)
    jcfgs = {compute: arch_pair(arch, compute)[0]}
    if compute == "bfloat16":
        jcfgs["float32"] = j32
    tcfg = arch_pair(arch, compute)[1]
    params = jax_params(j32)
    B, cache_len = 2, 24
    jcache = {c: jserve.init_cache(j, B, cache_len) for c, j in jcfgs.items()}
    tcache = tserve.init_cache(tcfg, B, cache_len, device="cpu")
    spec = tserve.cache_spec(tcfg, B, cache_len)
    model = port_model(tcfg, params)
    if family == "encdec":
        frames = rand(np.random.default_rng(13), B, cache_len // j32.enc_downsample,
                      j32.d_model)
        for c, j in jcfgs.items():
            xk, xv = _jax_cross(j)(params, jnp.asarray(frames))
            jcache[c] = {**jcache[c], "xk": xk.astype(jcache[c]["xk"].dtype),
                         "xv": xv.astype(jcache[c]["xv"].dtype)}
        tcache["xk"] = t(jcache[compute]["xk"], tcfg.cdt)
        tcache["xv"] = t(jcache[compute]["xv"], tcfg.cdt)
    tok = np.random.default_rng(14).integers(0, j32.vocab, (B,)).astype(np.int32)
    for i in range(8):
        jl = {}
        for c, j in jcfgs.items():
            jl[c], jcache[c] = _jax_step(j)(params, jcache[c], jnp.asarray(tok), jnp.int32(i))
        tl, tcache = model.decode_step(tcache, t(tok), i)
        tol = F32_LOGITS if compute == "float32" else bf16_bound(jl[compute], jl["float32"])
        assert tl.shape == (B, tcfg.vocab) and rel(tl, jl[compute]) <= tol, i
        tok = np.asarray(jnp.argmax(jl[compute], axis=-1)).astype(np.int32)
    for k, s in spec.items():
        assert tuple(tcache[k].shape) == s.shape and tcache[k].dtype == s.dtype, k
    tol = F32_LOGITS
    if compute == "bfloat16":
        tol = max(bf16_bound(jcache["bfloat16"][k], jcache["float32"][k]) for k in spec)
    assert tree_rel(tcache, jcache[compute]) <= tol


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH) + ["encdec"])
def test_decode_matches_prefill(family):
    """The port alone, at float32 compute: S = 24 decode steps against one
    prefill (the 16-slot SWA ring wraps); MoE at capacity_factor =
    n_experts / top_k, so neither path drops a token."""
    cfg = no_drop_f32(get_config(FAMILY_ARCH.get(family, "seamless-m4t-large-v2"), smoke=True))
    gen = torch.Generator().manual_seed(15)
    params = (te.init_encdec(cfg, gen) if family == "encdec" else tt.init_lm(cfg, gen))
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=gen)
    frames = torch.randn((2, 6, cfg.d_model), generator=gen) if family == "encdec" else None
    assert decode_vs_prefill(cfg, params, toks, frames) <= F32_LOGITS


def test_module_registers_the_tree_without_copying():
    jcfg, tcfg = arch_pair("zamba2-1.2b")
    params = jax_params(jcfg)
    model = port_model(tcfg, params)
    tree = model.tree()
    names = dict(model.named_parameters())
    assert names["params.groups.mamba.in_proj"] is tree["groups"]["mamba"]["in_proj"]
    assert tree["groups"]["mamba"]["in_proj"].shape == params["groups"]["mamba"]["in_proj"].shape
    assert tree_rel(tree, params) == 0.0
    assert tree.keys() == params.keys()


# ------------------------------------------------------------------ bfloat16 carry
def _bf16_specials():
    vals = np.array([0.0, -0.0, 1.0, -1.5, 3.1415926, 1e-40, -1e-39, 3.3e38, -3.3e38,
                     np.inf, -np.inf, np.nan, 65504.0, 1 / 3], np.float32)
    rng = np.random.default_rng(16)
    return jnp.asarray(np.concatenate([vals, rand(rng, 50, scale=1e3)]), jnp.bfloat16)


def test_from_numpy_carries_bfloat16_bit_for_bit():
    a = _bf16_specials()  # a JAX array; np.asarray gives ml_dtypes' bfloat16
    tree = {"w": a, "nested": [np.asarray(a).reshape(8, 8)]}
    got = from_numpy(tree, device="cpu")
    assert got["w"].dtype == torch.bfloat16 and got["nested"][0].shape == (8, 8)
    want_bits = np.asarray(a).view(np.uint16)
    assert np.array_equal(got["w"].view(torch.int16).numpy().view(np.uint16), want_bits)
    assert np.array_equal(got["nested"][0].view(torch.int16).numpy().view(np.uint16).ravel(),
                          want_bits)


def test_to_numpy_widens_bfloat16_exactly():
    from repro_torch.convert import to_numpy

    t16 = from_numpy(_bf16_specials(), device="cpu")
    out = to_numpy({"x": t16})["x"]
    assert out.dtype == np.float32
    back = jnp.asarray(out).astype(jnp.bfloat16)  # exact: every value is a bf16
    assert np.array_equal(np.asarray(back).view(np.uint16),
                          t16.view(torch.int16).numpy().view(np.uint16))


def test_bfloat16_parameter_tree_through_from_tree():
    jcfg, tcfg = arch_pair("olmo-1b", param_dtype="bfloat16")
    params = jax_params(jcfg)
    model = LM.from_tree(tcfg, params, device="cpu")
    got = model.tree()["layers"]["attn"]["wq"]
    assert got.dtype == torch.bfloat16 == tcfg.pdt
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                          params["layers"]["attn"]["wq"].view(np.uint16))
