"""arctic-480b [moe]: 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.models.config import ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="arctic-480b", family="moe",
        n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=4864, vocab=32_000,
        n_experts=128, top_k=2, moe_dense_residual=True, dense_ff=4864,
        activation="silu", norm="rms",
    )


def make_smoke_config() -> ArchConfig:
    return make_config().scaled(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=128, vocab=512,
        n_experts=8, dense_ff=128
    )
