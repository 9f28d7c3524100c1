"""stablelm-3b [dense] [hf:stabilityai/stablelm-2-1_6b family]."""
from repro_torch.models.config import ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="stablelm-3b", family="dense",
        n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=6912, vocab=50_304,
        activation="silu", norm="layer",
    )


def make_smoke_config() -> ArchConfig:
    return make_config().scaled(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512
    )
