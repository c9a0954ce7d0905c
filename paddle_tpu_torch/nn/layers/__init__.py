from .common import Dropout
from .container import LayerList
from .norm import LayerNorm

__all__ = ["Dropout", "LayerList", "LayerNorm"]
