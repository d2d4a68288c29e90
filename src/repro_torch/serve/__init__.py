"""Serving on the port: the continuous-batching LM decode engine."""

from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
