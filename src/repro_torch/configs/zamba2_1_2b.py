"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block (tied
weights) [arXiv:2411.15242].  38 mamba layers in 2 groups of 19, shared attn
applied once per group; the shared attention uses a sliding window so the
500k-decode cell stays sub-quadratic (noted in DESIGN.md)."""
from repro_torch.models.config import ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32_000,
        ssm_state=64, attn_every=19, swa_window=4096,
        activation="gelu", norm="rms",
        supports_long_context=True,
    )


def make_smoke_config() -> ArchConfig:
    return make_config().scaled(
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
        ssm_state=16, attn_every=2, swa_window=16
    )
