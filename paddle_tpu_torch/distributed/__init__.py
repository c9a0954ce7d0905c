from . import (auto_parallel, checkpoint, fleet_utils, meta_parallel,
               pipelining, recompute, sharding_utils, topology)
# the semi-auto parallel symbols at top level (reference:
# paddle_tpu/distributed/__init__.py:39-46)
from .auto_parallel import (DistModel, Engine, Partial, Placement,
                            ProcessMesh, Replicate, Shard, dtensor_from_fn,
                            get_mesh, get_placements, reshard, set_mesh,
                            shard_dataloader, shard_layer, shard_optimizer,
                            shard_tensor, to_static, unshard_dtensor)
from .fleet import fleet
from .mesh import Grid, Mesh, all_gather, ppermute, psum, psum_scatter
from .strategy import DistributedStrategy
from .topology import (CommunicateTopology, HybridCommunicateGroup,
                       ParallelAxis, get_hybrid_communicate_group)

__all__ = ["auto_parallel", "checkpoint", "fleet_utils", "meta_parallel",
           "pipelining", "recompute", "sharding_utils", "topology",
           "fleet", "DistributedStrategy", "CommunicateTopology",
           "HybridCommunicateGroup", "ParallelAxis",
           "get_hybrid_communicate_group", "Mesh", "Grid", "psum",
           "all_gather", "ppermute", "psum_scatter",
           "ProcessMesh", "Shard", "Replicate", "Partial", "Placement",
           "shard_tensor", "dtensor_from_fn", "reshard", "shard_layer",
           "shard_optimizer", "unshard_dtensor", "get_placements",
           "shard_dataloader", "to_static", "DistModel", "Engine",
           "set_mesh", "get_mesh"]


def __getattr__(name):
    # the MoE stack loads on first use (distributed/__init__.py:72)
    if name == "moe":
        import importlib
        mod = importlib.import_module(".moe", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(name)
