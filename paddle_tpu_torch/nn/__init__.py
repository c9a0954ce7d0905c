from . import functional
from .layers import (CrossEntropyLoss, Dropout, Embedding, LayerList,
                     LayerNorm, Linear, MultiHeadAttention, RMSNorm,
                     Transformer, TransformerDecoder, TransformerDecoderLayer,
                     TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "CrossEntropyLoss", "Dropout", "Embedding",
           "LayerList", "LayerNorm", "Linear", "MultiHeadAttention",
           "RMSNorm", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer"]
