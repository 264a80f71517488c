"""Narrow twins of the four configs that chip phases L-O serve at full
width (Qwen3-14B, Yi-34B, StableLM-2-1.6B, InternVL2-2B), shared by
``tests/test_torch_config_cells.py`` (parity with ``repro``) and
``tests/test_torch_chip_smoke_cells.py`` (the chip phases rehearsed).

Each keeps its config's family, query heads per kv head and options
(qk_norm, rope_theta, patches) at 2 layers, d_model 128, d_ff 256 and a
vocabulary of 512, in f32: Qwen3-14B 10:2 (G = 5) and Yi-34B 14:2 (G = 7)
at head dim 16, StableLM 4:4 (G = 1) at d_model / heads = 32 as its 2048 /
32 = 64, InternVL2 4:2 (G = 2) at 32 likewise, with 8 patches."""

NARROW = {
    "qwen3_14b": dict(n_heads=10, n_kv_heads=2, head_dim=16),
    "yi_34b": dict(n_heads=14, n_kv_heads=2, head_dim=16),
    "stablelm_1_6b": dict(n_heads=4, n_kv_heads=4, head_dim=32),
    "internvl2_2b": dict(n_heads=4, n_kv_heads=2, head_dim=32, n_patches=8),
}


def narrow(cfg):
    """``cfg`` (either package's ``ArchConfig`` of a ``NARROW`` config) cut
    to its narrow twin."""
    arch = cfg.name.replace("-", "_").replace(".", "_")
    return cfg.scaled(n_layers=2, d_model=128, d_ff=256, vocab=512,
                      dtype="float32", remat=False, **NARROW[arch])


# The four configs whose cells chip phases 13, D, E and F run (Kimi-K2,
# Hymba-1.5B, xLSTM-350M, Whisper-tiny), shared by
# ``tests/test_torch_family_cells.py`` and
# ``tests/test_torch_chip_smoke_family_cells.py``.  Each keeps its family's
# layout at 2 layers, a vocabulary of 512, in f32: Kimi-K2 16:2 (G = 8) at
# head dim 112, 32 experts top-8 (four MoE chunks in a 2048-token row);
# Hymba 10:2 (G = 5) at head dim 16 with a 32-token window and a Mamba
# state of 16; xLSTM one mLSTM/sLSTM pair of 4 heads; Whisper 6:6 at head
# dim 16 with 2 + 2 layers over its 1500 frames.
FAMILY_NARROW = {
    "kimi_k2_1t_a32b": dict(d_model=128, n_heads=16, n_kv_heads=2,
                            head_dim=112, d_ff=64, n_experts=32, top_k=8),
    "hymba_1_5b": dict(d_model=160, n_heads=10, n_kv_heads=2, head_dim=16,
                       d_ff=256, window=32, ssm_state=16),
    "xlstm_350m": dict(d_model=128, n_heads=4, n_kv_heads=4, head_dim=32),
    "whisper_tiny": dict(d_model=96, n_heads=6, n_kv_heads=6, head_dim=16,
                         d_ff=192, enc_layers=2),
}


def narrow_family(cfg):
    """``cfg`` (either package's ``ArchConfig`` of a ``FAMILY_NARROW``
    config) cut to its narrow twin."""
    arch = cfg.name.replace("-", "_").replace(".", "_")
    return cfg.scaled(n_layers=2, vocab=512, dtype="float32", remat=False,
                      **FAMILY_NARROW[arch])
