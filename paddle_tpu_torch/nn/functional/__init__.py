from .activation import gelu, silu
from .attention import (flash_attention, flash_attn_unpadded,
                        scaled_dot_product_attention, sdpa_reference)
from .input import embedding
from .norm import layer_norm, rms_norm

__all__ = ["embedding", "flash_attention", "flash_attn_unpadded", "gelu",
           "layer_norm", "rms_norm", "scaled_dot_product_attention",
           "sdpa_reference", "silu"]
