"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP stub (precomputed patch
embeddings) [hf:microsoft/Phi-3-vision-128k-instruct]."""
from repro_torch.models.config import ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="phi-3-vision-4.2b", family="vlm",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32_064,
        n_patches=576, vision_dim=1024,
        activation="silu", norm="rms",
    )


def make_smoke_config() -> ArchConfig:
    return make_config().scaled(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
        n_patches=16, vision_dim=64
    )
