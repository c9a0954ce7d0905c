from .activation import gelu
from .norm import layer_norm

__all__ = ["gelu", "layer_norm"]
