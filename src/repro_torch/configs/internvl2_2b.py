"""internvl2-2b [vlm] — InternViT frontend stubbed as 256 precomputed patch
embeddings scattered over the leading token positions; InternLM2 backbone.
[arXiv:2404.16821; hf]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553,
    head_dim=128,
    n_patches=256,
    rope_theta=1e6,
    sharding_profile="tp",
    source="arXiv:2404.16821",
)
