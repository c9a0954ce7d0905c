"""Optimizers of the port (counterpart of paddle_tpu/optimizer)."""

from .adam import Adam, AdamW, FusedAdamW
from .optimizer import Optimizer

__all__ = ["Optimizer", "Adam", "AdamW", "FusedAdamW"]
