from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding,
                        parallel_cross_entropy, sharded_row_take, split)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "parallel_cross_entropy", "sharded_row_take", "split"]
