"""Optimizers of the port (counterpart of paddle_tpu/optimizer)."""

from .adam import Adam, AdamW, FusedAdamW
from .optimizer import Optimizer
from .sgd import SGD

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "FusedAdamW"]
