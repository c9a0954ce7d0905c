from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding,
                        parallel_cross_entropy, sharded_row_take, split)
from .sequence_parallel import (AllGatherOp, ColumnSequenceParallelLinear,
                                GatherOp, ReduceScatterOp,
                                RowSequenceParallelLinear, ScatterOp,
                                mark_as_sequence_parallel_parameter)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "parallel_cross_entropy", "sharded_row_take", "split",
           "ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
           "mark_as_sequence_parallel_parameter"]
