from .activation import gelu
from .attention import scaled_dot_product_attention, sdpa_reference
from .norm import layer_norm

__all__ = ["gelu", "layer_norm", "scaled_dot_product_attention",
           "sdpa_reference"]
