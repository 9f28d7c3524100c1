"""xlstm-125m [ssm]: sLSTM + mLSTM blocks, d_ff=0 (blocks carry their own
up/down projections) [arXiv:2405.04517].  O(1) state => runs long_500k."""
from repro_torch.models.config import ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50_304,
        slstm_every=4,  # 12 layers = 3 groups of (3 mLSTM + 1 sLSTM)
        supports_long_context=True,
    )


def make_smoke_config() -> ArchConfig:
    return make_config().scaled(n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
                                vocab=512, slstm_every=2)
