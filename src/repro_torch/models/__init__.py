from .registry import build_model

__all__ = ["build_model"]
