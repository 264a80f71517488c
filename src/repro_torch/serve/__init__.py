from .engine import Request, ServeConfig, ServingEngine

__all__ = ["Request", "ServeConfig", "ServingEngine"]
