"""olmo-1b [dense]: non-parametric LayerNorm, tied embeddings [arXiv:2402.00838]."""
from repro_torch.models.config import ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="olmo-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=50_304,
        activation="silu", norm="nonparam", tie_embeddings=True,
    )


def make_smoke_config() -> ArchConfig:
    return make_config().scaled(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512
    )
