from .activation import gelu, log_softmax, relu, silu, softmax
from .attention import (flash_attention, flash_attn_unpadded,
                        scaled_dot_product_attention, sdpa_reference)
from .common import dropout, label_smooth, linear
from .input import embedding
from .loss import cross_entropy, softmax_with_cross_entropy
from .norm import layer_norm, rms_norm

__all__ = ["cross_entropy", "dropout", "embedding", "flash_attention",
           "flash_attn_unpadded", "gelu", "label_smooth", "layer_norm",
           "linear", "log_softmax", "relu", "rms_norm",
           "scaled_dot_product_attention", "sdpa_reference", "silu",
           "softmax", "softmax_with_cross_entropy"]
