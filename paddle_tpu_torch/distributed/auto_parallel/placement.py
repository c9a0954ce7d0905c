"""ProcessMesh and placement types (counterpart of
paddle_tpu/distributed/auto_parallel/placement.py).

Reference: python/paddle/distributed/auto_parallel/process_mesh.py —
ProcessMesh; placement_type.py — Shard, Replicate, Partial
(``dist.ProcessMesh([[0, 1], [2, 3]], dim_names=["dp", "mp"])``).

A ProcessMesh is a named n-D array of process ids; process ``p`` runs on
a device (``devices=``, in ``process_ids`` order; by default process
``p`` on ``cuda:p``), and ``get_mesh()`` lays the processes over the
port's :class:`~paddle_tpu_torch.distributed.mesh.Grid` (grid rank ``r``
is the ``r``-th process in row-major order), as ``hcg.get_mesh()``
does.  Several processes may share one device (``devices=["cuda:0"] *
8``; ``["cpu"] * 8`` on the host).  A placements list (one entry per
MESH dim, the reference's convention) maps to a spec with one entry per
TENSOR dim (:func:`placements_to_spec`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..mesh import Grid
from ..sharding_utils import P

__all__ = ["ProcessMesh", "Placement", "Shard", "Replicate", "Partial",
           "placements_to_spec", "compute_placements_spec"]


class Placement:
    """Base placement type (reference: placement_type.py — Placement)."""

    def is_shard(self, dim: Optional[int] = None) -> bool:
        return False

    def is_replicated(self) -> bool:
        return False

    def is_partial(self) -> bool:
        return False


class Shard(Placement):
    """Tensor dim ``dim`` is split across this mesh dimension."""

    def __init__(self, dim: int):
        self.dim = int(dim)

    def is_shard(self, dim: Optional[int] = None) -> bool:
        return dim is None or dim == self.dim

    def get_dim(self) -> int:
        return self.dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("Shard", self.dim))


class Replicate(Placement):
    def is_replicated(self) -> bool:
        return True

    def __repr__(self):
        return "Replicate()"

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("Replicate")


class Partial(Placement):
    """Each rank holds a partial value, reduced on reshard.

    reduce_type: 'sum' | 'avg' | 'max' | 'min' (reference ReduceType).
    """

    def __init__(self, reduce_type: str = "sum"):
        self.reduce_type = reduce_type.lower()

    def is_partial(self) -> bool:
        return True

    def __repr__(self):
        return f"Partial(reduce_type={self.reduce_type!r})"

    def __eq__(self, other):
        return isinstance(other, Partial) \
            and other.reduce_type == self.reduce_type

    def __hash__(self):
        return hash(("Partial", self.reduce_type))


class ProcessMesh:
    """An n-D array of process ids with named dimensions.

    Reference: process_mesh.py — ProcessMesh(mesh, dim_names).
    ``devices`` gives each process's device in ``process_ids`` order
    (default: process ``p`` on ``cuda:p``; it raises, naming ``devices=``,
    when there is no such CUDA device).
    """

    def __init__(self, mesh: Union[Sequence, np.ndarray],
                 dim_names: Optional[Sequence[str]] = None,
                 process_ids: Optional[Sequence[int]] = None,
                 devices: Optional[Sequence] = None):
        arr = np.asarray(mesh, dtype=np.int64)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        self._mesh = arr
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        if len(dim_names) != arr.ndim:
            raise ValueError(
                f"dim_names {dim_names} does not match mesh ndim {arr.ndim}")
        self._dim_names = list(dim_names)
        if devices is not None:
            devices = list(devices)
            if len(devices) != arr.size:
                raise ValueError(f"{len(devices)} devices for a mesh of "
                                 f"{arr.size} processes")
            self._device_of = {int(p): torch.device(d)
                               for p, d in zip(arr.flatten(), devices)}
        else:
            self._device_of = None
        self._grid: Optional[Grid] = None

    # -- reference-parity accessors ------------------------------------
    @property
    def mesh(self) -> np.ndarray:
        return self._mesh

    @property
    def shape(self) -> List[int]:
        return list(self._mesh.shape)

    @property
    def ndim(self) -> int:
        return self._mesh.ndim

    @property
    def dim_names(self) -> List[str]:
        return list(self._dim_names)

    @property
    def process_ids(self) -> List[int]:
        return [int(r) for r in self._mesh.flatten()]

    @property
    def size(self) -> int:
        return int(self._mesh.size)

    def get_dim_size(self, name: str) -> int:
        return self._mesh.shape[self._dim_names.index(name)]

    def get_rank_by_dim_and_process_id(self, dim_name: str,
                                       process_id: int) -> int:
        coords = np.argwhere(self._mesh == process_id)
        if len(coords) == 0:
            return -1
        return int(coords[0][self._dim_names.index(dim_name)])

    def get_submesh(self, dim_name: str, index: int) -> "ProcessMesh":
        axis = self._dim_names.index(dim_name)
        sub = np.take(self._mesh, index, axis=axis)
        names = [n for n in self._dim_names if n != dim_name]
        if sub.ndim == 0:  # 1-D mesh -> single-rank submesh
            sub = sub.reshape(1)
            names = ["r"]
        devices = None if self._device_of is None else \
            [self._device_of[int(p)] for p in sub.flatten()]
        return ProcessMesh(sub, names, devices=devices)

    # -- placement on devices -------------------------------------------
    def devices(self) -> List[torch.device]:
        """Each process's device, in ``process_ids`` order."""
        if self._device_of is not None:
            return [self._device_of[p] for p in self.process_ids]
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"no CUDA device is available for the mesh's processes; "
                f"pass devices=['cpu'] * {self.size} to lay them on the "
                f"host")
        n = torch.cuda.device_count()
        if max(self.process_ids) >= n:
            raise RuntimeError(
                f"the mesh's process ids {self.process_ids} need CUDA "
                f"devices up to cuda:{max(self.process_ids)} and {n} are "
                f"visible; pass devices=['cuda:0'] * {self.size} to put "
                f"several processes on one card")
        return [torch.device("cuda", p) for p in self.process_ids]

    def get_mesh(self) -> Grid:
        """The processes as a :class:`Grid` over ``dim_names`` (cached)."""
        if self._grid is None:
            self._grid = Grid(self.devices(), self._dim_names,
                              self._mesh.shape)
        return self._grid

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and np.array_equal(self._mesh, other._mesh)
                and self._dim_names == other._dim_names)

    def __hash__(self):
        return hash((self._mesh.tobytes(), tuple(self._dim_names)))

    def __repr__(self):
        return f"ProcessMesh(shape={self.shape}, dim_names={self._dim_names})"


def placements_to_spec(placements: Sequence[Placement], ndim: int,
                       dim_names: Sequence[str]) -> P:
    """A per-MESH-dim placements list as a per-TENSOR-dim spec: each entry
    ``None``, a mesh dim name, or a tuple of names (several mesh dims
    splitting one tensor dim, the first one major)."""
    entries: List[list] = [[] for _ in range(ndim)]
    for mesh_dim, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d = pl.dim if pl.dim >= 0 else pl.dim + ndim
            if not (0 <= d < ndim):
                raise ValueError(
                    f"Shard dim {pl.dim} out of range for ndim {ndim}")
            entries[d].append(dim_names[mesh_dim])
    spec = []
    for names in entries:
        if not names:
            spec.append(None)
        elif len(names) == 1:
            spec.append(names[0])
        else:
            spec.append(tuple(names))
    return P(*spec)


def compute_placements_spec(x_ndim: int, mesh: ProcessMesh,
                            placements: Sequence[Placement]
                            ) -> Tuple[P, List[Placement]]:
    """Check ``placements`` against ``mesh`` and return ``(spec, the
    placements padded with Replicate to one a mesh dim)``.  A Partial
    entry leaves its mesh dim out of the spec (the handle carries it)."""
    placements = list(placements)
    if len(placements) < mesh.ndim:
        placements += [Replicate()] * (mesh.ndim - len(placements))
    if len(placements) != mesh.ndim:
        raise ValueError(
            f"{len(placements)} placements for mesh with {mesh.ndim} dims")
    return placements_to_spec(placements, x_ndim, mesh.dim_names), placements
