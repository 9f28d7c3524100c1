"""mixtral-8x22b [moe]: 8 experts top-2, sliding-window attention
[arXiv:2401.04088].  SWA bounds the KV cache => runs long_500k."""
from repro_torch.models.config import ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=32_768,
        n_experts=8, top_k=2, swa_window=4096,
        activation="silu", norm="rms",
        supports_long_context=True,
    )


def make_smoke_config() -> ArchConfig:
    return make_config().scaled(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab=512,
        n_experts=4, swa_window=16
    )
