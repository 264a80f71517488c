"""grok-1-314b [moe] — 8 experts top-2. [hf:xai-org/grok-1]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072,
    head_dim=128,
    n_experts=8, top_k=2, capacity_factor=1.25,
    sharding_profile="fsdp_tp",
    source="hf:xai-org/grok-1 (unverified)",
)
