from .common import Dropout, Embedding, Linear
from .container import LayerList
from .loss import CrossEntropyLoss
from .norm import LayerNorm, RMSNorm
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["CrossEntropyLoss", "Dropout", "Embedding", "LayerList",
           "LayerNorm", "Linear", "MultiHeadAttention", "RMSNorm",
           "Transformer", "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer"]
