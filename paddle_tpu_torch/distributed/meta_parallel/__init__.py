from .mp_layers import (ColumnParallelLinear, RowParallelLinear,
                        VocabParallelEmbedding, parallel_cross_entropy)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "parallel_cross_entropy"]
