"""stablelm-1.6b [dense] — MHA (kv=32). [hf:stabilityai/stablelm-2-1_6b]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab=100352,
    head_dim=64,
    rope_theta=1e4,
    sharding_profile="tp",
    source="hf:stabilityai/stablelm-2-1_6b (unverified)",
)
