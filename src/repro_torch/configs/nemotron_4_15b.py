"""nemotron-4-15b [dense]: GQA (kv=8), squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.models.config import ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="nemotron-4-15b", family="dense",
        n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=24576, vocab=256_000,
        activation="sq_relu", norm="layer",
    )


def make_smoke_config() -> ArchConfig:
    return make_config().scaled(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab=512
    )
