"""whisper-tiny [audio] — enc-dec, conv frontend stubbed as 1500 precomputed
frame embeddings. [arXiv:2212.04356]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865,
    head_dim=64,
    enc_layers=4, enc_frames=1500,
    sharding_profile="tp",
    source="arXiv:2212.04356 (unverified)",
)
