"""Model registry: ArchConfig -> model instance.  The dense, MoE and VLM
families are ported (``DecoderLM``); the others raise and name the ROADMAP
item that brings them."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig

from .transformer import FAMILIES, DecoderLM

_QUEUED = {"audio": "ROADMAP A7", "hybrid": "ROADMAP A7",
           "ssm": "ROADMAP A7"}


def build_model(cfg: ArchConfig, device="cuda"):
    if cfg.family in FAMILIES:
        return DecoderLM(cfg, device=device)
    if cfg.family in _QUEUED:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is "
                                  f"not ported yet ({_QUEUED[cfg.family]})")
    raise ValueError(f"unknown family {cfg.family!r} for {cfg.name}")


__all__ = ["build_model"]
