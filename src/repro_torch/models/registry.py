"""Model registry: ArchConfig -> model instance.  Only the dense family is
ported; the others raise and name the ROADMAP item that brings them."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig

from .transformer import DecoderLM

_QUEUED = {"moe": "ROADMAP D3", "vlm": "ROADMAP D3", "audio": "ROADMAP A7",
           "hybrid": "ROADMAP A7", "ssm": "ROADMAP A7"}


def build_model(cfg: ArchConfig, device="cuda"):
    if cfg.family == "dense":
        return DecoderLM(cfg, device=device)
    if cfg.family in _QUEUED:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is "
                                  f"not ported yet ({_QUEUED[cfg.family]})")
    raise ValueError(f"unknown family {cfg.family!r} for {cfg.name}")


__all__ = ["build_model"]
