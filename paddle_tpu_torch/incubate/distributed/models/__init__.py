"""Counterpart of paddle_tpu/incubate/distributed/models/__init__.py."""

from . import moe  # noqa: F401

__all__ = ["moe"]
