"""qwen3-4b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab=151936,
    head_dim=128,          # Qwen3 uses an explicit 128 head_dim
    qk_norm=True, rope_theta=1e6,
    sharding_profile="tp",
    source="hf:Qwen/Qwen3-8B (family); assigned dims",
)
