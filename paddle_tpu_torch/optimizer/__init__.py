"""Optimizers of the port (counterpart of paddle_tpu/optimizer)."""

from . import lr
from .adam import Adam, AdamW, FusedAdamW
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .optimizer import Optimizer
from .sgd import SGD

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "FusedAdamW", "lr",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]
