"""Framework utilities (counterpart of paddle_tpu/framework)."""

from .io import load, save

__all__ = ["save", "load"]
