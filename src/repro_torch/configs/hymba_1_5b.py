"""hymba-1.5b [hybrid] — parallel attention+mamba heads, SWA attention.
[arXiv:2411.13676; hf]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001,
    head_dim=64,
    ssm_state=16, window=1024,    # Hymba uses SWA for most layers
    sharding_profile="tp",
    source="arXiv:2411.13676",
)
