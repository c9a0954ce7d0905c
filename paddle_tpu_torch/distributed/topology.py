"""The hybrid-parallel topology over the port's rank grid (counterpart of
paddle_tpu/distributed/topology.py).

The reference lays its ranks over one named ``jax.sharding.Mesh`` in the
axis order ``[dp, pp, sharding, sep, ep, mp]`` and addresses a "comm
group" by axis name.  The port keeps that single-controller model: the
group is a :class:`~.mesh.Grid` of rank devices in the same order, one
process drives every rank, and the ranks of one axis's group form a 1-D
:class:`~.mesh.Mesh` for the collectives of ``mesh.py``.  A device may
repeat, so several ranks can share one card; on a host with several cards
the same code places rank ``r`` on ``cuda:r``.

Ranks exist on the host here (the reference's are traced inside
``shard_map``): ``get_*_rank(rank)`` reads a global rank's coordinate, and
with no argument that of this process's rank, 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from .mesh import Grid, Mesh

__all__ = ["CommunicateTopology", "HybridCommunicateGroup", "ParallelAxis",
           "get_hybrid_communicate_group", "set_hybrid_communicate_group",
           "AXIS_ORDER"]

# fleet's order with the expert axis between sep and mp (topology.py:41)
AXIS_ORDER = ("dp", "pp", "sharding", "sep", "ep", "mp")


class CommunicateTopology:
    """Rank-coordinate math over the named hypercube (the reference's
    ``CommunicateTopology``: get_coord / get_rank / get_comm_list)."""

    def __init__(self, hybrid_group_names: Sequence[str] = AXIS_ORDER,
                 dims: Sequence[int] = (1,) * len(AXIS_ORDER)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self._world_size = int(np.prod(self._dims))
        coords = np.indices(self._dims).reshape(len(self._dims), -1).T
        self._coords = [tuple(int(x) for x in c) for c in coords]
        self._coord_map = {c: rank for rank, c in enumerate(self._coords)}

    def get_hybrid_group_names(self) -> List[str]:
        return self._parallel_names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return self._world_size

    def get_rank(self, **coords) -> int:
        return self._coord_map[tuple(coords[n]
                                     for n in self._parallel_names)]

    def get_coord(self, rank: int):
        return self._coords[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        axis = self._parallel_names.index(axis_name)
        return [r for r, c in enumerate(self._coords) if c[axis] == index]

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """Every rank group along ``axis_name`` (one per slice of the other
        axes)."""
        axis = self._parallel_names.index(axis_name)
        groups = []
        for c in self._coords:
            if c[axis] == 0:
                groups.append([self._coord_map[c[:axis] + (k,) + c[axis + 1:]]
                               for k in range(self._dims[axis])])
        return groups


@dataclasses.dataclass
class ParallelAxis:
    """A comm group: one named axis of the grid, with the reference
    ``Group``'s degree and id."""

    name: str
    degree: int
    grid: Grid
    id: int = 0

    @property
    def nranks(self) -> int:
        return self.degree

    @property
    def world_size(self) -> int:
        return self.degree

    @property
    def rank(self) -> int:
        """This process's coordinate on the axis (the controller is rank
        0)."""
        return 0

    def ranks(self, rank: int = 0) -> List[int]:
        """The global ranks of ``rank``'s group along this axis."""
        return self.grid.axis_ranks(self.name, rank)

    def mesh(self, rank: int = 0) -> Mesh:
        """``rank``'s group along this axis as a 1-D mesh."""
        return self.grid.axis_mesh(self.name, rank)

    def __repr__(self) -> str:
        return f"ParallelAxis({self.name}, degree={self.degree})"


class HybridCommunicateGroup:
    """fleet's ``HybridCommunicateGroup`` over one :class:`Grid`.

    ``devices=None`` takes the first ``world`` CUDA devices (world = the
    product of the degrees) and raises, naming ``devices=``, when fewer
    exist; nothing places ranks on its own initiative.  A device may
    repeat: ``devices=["cuda:0"] * 8`` puts eight ranks on one card, and
    CPU callers pass ``devices=["cpu"] * world``.  With more devices than
    ranks the first ``world`` are used, as in the reference."""

    def __init__(self, dp_degree: int = 1, mp_degree: int = 1,
                 pp_degree: int = 1, sharding_degree: int = 1,
                 sep_degree: int = 1, ep_degree: int = 1,
                 devices: Optional[Sequence] = None,
                 topology: Optional[CommunicateTopology] = None):
        degrees = dict(dp=dp_degree, pp=pp_degree, sharding=sharding_degree,
                       sep=sep_degree, ep=ep_degree, mp=mp_degree)
        for name, n in degrees.items():
            if not isinstance(n, int) or n < 1:
                raise ValueError(f"{name}_degree must be a positive int, "
                                 f"got {n!r}")
        want = math.prod(degrees.values())
        if devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            devices = [f"cuda:{i}" for i in range(n)]
            where = "CUDA devices are"
        else:
            devices = list(devices)
            where = "devices were given"
        if len(devices) < want:
            raise ValueError(
                f"the hybrid degrees {degrees} need {want} rank devices but "
                f"only {len(devices)} {where} visible; pass devices= to "
                f"place the ranks (several may share one card: "
                f"devices=['cuda:0'] * {want}; on the CPU devices=['cpu'] "
                f"* {want})")
        self._degrees = degrees
        self._topo = topology or CommunicateTopology(
            AXIS_ORDER, [degrees[a] for a in AXIS_ORDER])
        self._grid = Grid(devices[:want], AXIS_ORDER,
                          [degrees[a] for a in AXIS_ORDER])
        self._axes = {a: ParallelAxis(a, degrees[a], self._grid, i)
                      for i, a in enumerate(AXIS_ORDER)}
        self.nranks = want
        self.global_rank = 0

    # --- the grid --------------------------------------------------------
    @property
    def grid(self) -> Grid:
        return self._grid

    @property
    def mesh(self) -> Grid:
        """The rank grid (the reference's ``Mesh``, topology.py:201-205):
        ``dict(hcg.get_mesh().shape)`` maps each axis name to its degree in
        the reference's order."""
        return self._grid

    def get_mesh(self) -> Grid:
        return self._grid

    def topology(self) -> CommunicateTopology:
        return self._topo

    def get_parallel_mode(self) -> str:
        if self._degrees["pp"] > 1:
            return "pipeline"
        if self._degrees["sharding"] > 1:
            return "sharding_parallel"
        if self._degrees["mp"] > 1:
            return "model"
        return "data_parallel"

    def degrees(self) -> dict:
        return dict(self._degrees)

    # --- per-axis accessors (the reference's names) ----------------------
    def get_data_parallel_world_size(self) -> int:
        return self._degrees["dp"]

    def get_model_parallel_world_size(self) -> int:
        return self._degrees["mp"]

    def get_pipe_parallel_world_size(self) -> int:
        return self._degrees["pp"]

    def get_sharding_parallel_world_size(self) -> int:
        return self._degrees["sharding"]

    def get_sep_parallel_world_size(self) -> int:
        return self._degrees["sep"]

    def get_expert_parallel_world_size(self) -> int:
        return self._degrees["ep"]

    def get_data_parallel_group(self) -> ParallelAxis:
        return self._axes["dp"]

    def get_model_parallel_group(self) -> ParallelAxis:
        return self._axes["mp"]

    def get_pipe_parallel_group(self) -> ParallelAxis:
        return self._axes["pp"]

    def get_sharding_parallel_group(self) -> ParallelAxis:
        return self._axes["sharding"]

    def get_sep_parallel_group(self) -> ParallelAxis:
        return self._axes["sep"]

    def get_expert_parallel_group(self) -> ParallelAxis:
        return self._axes["ep"]

    def _coord(self, axis: str, rank: Optional[int]) -> int:
        return self._grid.coord(self.global_rank if rank is None
                                else rank)[axis]

    def get_data_parallel_rank(self, rank: Optional[int] = None) -> int:
        return self._coord("dp", rank)

    def get_model_parallel_rank(self, rank: Optional[int] = None) -> int:
        return self._coord("mp", rank)

    def get_stage_id(self, rank: Optional[int] = None) -> int:
        return self._coord("pp", rank)

    def get_sharding_parallel_rank(self, rank: Optional[int] = None) -> int:
        return self._coord("sharding", rank)

    def get_sep_parallel_rank(self, rank: Optional[int] = None) -> int:
        return self._coord("sep", rank)

    def get_expert_parallel_rank(self, rank: Optional[int] = None) -> int:
        return self._coord("ep", rank)

    def get_check_parallel_group(self, *a, **k) -> ParallelAxis:
        return self._axes["mp"]

    def get_rank_from_stage(self, stage_id: int, **kwargs) -> int:
        return self._topo.get_rank(dp=0, pp=stage_id, sharding=0, sep=0,
                                   ep=0, mp=0)

    def __repr__(self) -> str:
        d = self._degrees
        return (f"HybridCommunicateGroup(dp={d['dp']}, pp={d['pp']}, "
                f"sharding={d['sharding']}, sep={d['sep']}, ep={d['ep']}, "
                f"mp={d['mp']})")


_HCG: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: Optional[HybridCommunicateGroup]
                                 ) -> None:
    global _HCG
    _HCG = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _HCG
