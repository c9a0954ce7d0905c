from . import functional
from .layers import Dropout, LayerList, LayerNorm

__all__ = ["functional", "Dropout", "LayerList", "LayerNorm"]
