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
