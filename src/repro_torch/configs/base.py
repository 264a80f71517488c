"""Architecture & shape configuration schema + registry."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 => d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    window: int = 0                # sliding-window size for SWA attention
    # --- enc-dec / modality stubs ---
    enc_layers: int = 0
    enc_frames: int = 0            # audio frontend stub: frames fed to encoder
    n_patches: int = 0             # vlm frontend stub: patch embeddings
    # --- runtime ---
    dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: bool = True
    # sharding profile: "tp" (params sharded over model axis only) or
    # "fsdp_tp" (additionally sharded over the data axis — big models)
    sharding_profile: str = "tp"
    source: str = ""               # provenance note

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def scaled(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def smoke_config(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            head_dim=16, d_ff=128, vocab=512,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            window=min(self.window, 16) if self.window else 0,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            enc_frames=min(self.enc_frames, 24) if self.enc_frames else 0,
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
            dtype="float32", scan_layers=True, remat=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int

    def smoke(self) -> "ShapeConfig":
        return dataclasses.replace(self, seq_len=min(self.seq_len, 64),
                                   global_batch=min(self.global_batch, 2))


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

ARCH_IDS: List[str] = [
    "qwen3_4b", "yi_34b", "qwen3_14b", "stablelm_1_6b", "whisper_tiny",
    "grok_1_314b", "kimi_k2_1t_a32b", "hymba_1_5b", "xlstm_350m",
    "internvl2_2b",
]

# long_500k needs sub-quadratic attention: runs only for ssm/hybrid families.
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def get_arch(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def applicable_shapes(cfg: ArchConfig) -> List[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in LONG_CONTEXT_FAMILIES:
        out.append("long_500k")
    return out


def all_cells() -> List[Tuple[str, str]]:
    cells = []
    for aid in ARCH_IDS:
        cfg = get_arch(aid)
        for shape in applicable_shapes(cfg):
            cells.append((aid, shape))
    return cells


__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "ARCH_IDS", "get_arch",
           "applicable_shapes", "all_cells", "LONG_CONTEXT_FAMILIES"]
