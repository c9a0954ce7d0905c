"""Semi-auto parallel API (counterpart of
paddle_tpu/distributed/auto_parallel).

Reference: python/paddle/distributed/auto_parallel/ — api.py
(shard_tensor, reshard, shard_layer, to_static), process_mesh.py
(ProcessMesh), placement_type.py (Shard / Replicate / Partial),
static/engine.py (Engine).  The reference lowers placements to GSPMD
shardings and lets XLA partition the step; the port is single-controller:
a dist tensor is its global value held once with its placements
(``api.py``), and the Engine runs each sharded layer per rank on the
mesh's grid (``engine.py``).  The SPMD rules (``spmd_rules.py``) are the
reference's pure shape logic.
"""

from .api import (dtensor_from_fn, get_mesh, get_placements, is_dist_tensor,
                  local_pieces, reshard, set_mesh, shard_dataloader, shard_layer,
                  shard_optimizer, shard_tensor, unshard_dtensor)
from .engine import DistModel, Engine, to_static
from .placement import (Partial, Placement, ProcessMesh, Replicate, Shard,
                        compute_placements_spec, placements_to_spec)
from .spmd_rules import (DistTensorSpec, elementwise_spmd, embedding_spmd,
                         matmul_spmd, reduction_spmd, softmax_spmd,
                         split_spmd, transpose_spmd)
from .strategy import Strategy

__all__ = [
    "ProcessMesh", "Placement", "Shard", "Replicate", "Partial",
    "shard_tensor", "dtensor_from_fn", "reshard", "shard_layer",
    "shard_optimizer", "unshard_dtensor", "get_placements", "shard_dataloader",
    "set_mesh", "get_mesh", "local_pieces", "is_dist_tensor",
    "DistTensorSpec", "matmul_spmd", "elementwise_spmd", "reduction_spmd",
    "embedding_spmd", "softmax_spmd", "transpose_spmd", "split_spmd",
    "Engine", "to_static", "DistModel", "Strategy",
    "compute_placements_spec", "placements_to_spec",
]
