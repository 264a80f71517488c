"""Model registry: ArchConfig -> model instance, on ``device``."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig

from .hybrid import HymbaModel
from .transformer import DecoderLM
from .whisper import WhisperModel
from .xlstm import XLSTMModel

_FAMILY_TO_MODEL = {
    "dense": DecoderLM,
    "moe": DecoderLM,
    "vlm": DecoderLM,
    "audio": WhisperModel,
    "hybrid": HymbaModel,
    "ssm": XLSTMModel,
}


def build_model(cfg: ArchConfig, device="cuda"):
    try:
        cls = _FAMILY_TO_MODEL[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r} for {cfg.name}") \
            from None
    return cls(cfg, device=device)


__all__ = ["build_model"]
