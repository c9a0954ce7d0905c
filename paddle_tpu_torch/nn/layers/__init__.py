from .common import Dropout, Embedding, Linear
from .container import LayerList
from .norm import LayerNorm, RMSNorm

__all__ = ["Dropout", "Embedding", "LayerList", "LayerNorm", "Linear",
           "RMSNorm"]
