"""seamless-m4t-large-v2 [audio enc-dec]: transformer backbone only; the audio
frontend is a stub (precomputed frame embeddings) [arXiv:2308.11596]."""
from repro_torch.models.config import ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-large-v2", family="encdec",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=256_206,
        enc_layers=24, dec_layers=24, enc_downsample=4,
        activation="gelu", norm="layer",
    )


def make_smoke_config() -> ArchConfig:
    return make_config().scaled(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
        enc_layers=2, dec_layers=2
    )
