"""granite-34b [dense]: llama-arch code model, MQA (kv=1) [arXiv:2405.04324]."""
from repro_torch.models.config import ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="granite-34b", family="dense",
        n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab=49_152,
        activation="gelu", norm="layer",
    )


def make_smoke_config() -> ArchConfig:
    return make_config().scaled(
        n_layers=3, d_model=128, n_heads=8, n_kv_heads=1, d_ff=256, vocab=512
    )
