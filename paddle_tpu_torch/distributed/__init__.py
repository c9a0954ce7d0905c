from . import (checkpoint, fleet_utils, meta_parallel, pipelining, recompute,
               sharding_utils, topology)
from .fleet import fleet
from .mesh import Grid, Mesh, all_gather, ppermute, psum, psum_scatter
from .strategy import DistributedStrategy
from .topology import (CommunicateTopology, HybridCommunicateGroup,
                       ParallelAxis, get_hybrid_communicate_group)

__all__ = ["checkpoint", "fleet_utils", "meta_parallel", "pipelining",
           "recompute", "sharding_utils", "topology",
           "fleet", "DistributedStrategy", "CommunicateTopology",
           "HybridCommunicateGroup", "ParallelAxis",
           "get_hybrid_communicate_group", "Mesh", "Grid", "psum",
           "all_gather", "ppermute", "psum_scatter"]
