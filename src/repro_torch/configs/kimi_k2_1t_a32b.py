"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8 with
d_ff=2048 per expert. [arXiv:2501.kimi2 (paper-table; unverified)]

Fits 512x16GB only with 8-bit optimizer state + full FSDPxTP parameter
sharding (see train/optimizer.py and EXPERIMENTS.md §Dry-run).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840,
    head_dim=112,
    n_experts=384, top_k=8, capacity_factor=1.25,
    sharding_profile="fsdp_tp",
    source="arXiv:2501.kimi2 (paper-table; unverified)",
)
