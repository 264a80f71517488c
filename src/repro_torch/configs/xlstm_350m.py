"""xlstm-350m [ssm] — alternating sLSTM + mLSTM blocks, d_ff=0.
[arXiv:2405.04517]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    head_dim=256,
    sharding_profile="tp",
    source="arXiv:2405.04517 (unverified)",
)
