"""Counterpart of paddle_tpu/incubate/distributed/__init__.py."""

from . import models  # noqa: F401

__all__ = ["models"]
