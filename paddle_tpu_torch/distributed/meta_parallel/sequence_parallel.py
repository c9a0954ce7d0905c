"""Megatron sequence parallelism (counterpart of
paddle_tpu/distributed/meta_parallel/sequence_parallel.py).

Between the tensor-parallel regions each mp rank holds its share of the
sequence: ``[b, s/mp, h]``, the layout the reference's block code uses
(``paddle_tpu/models/gpt.py:146-150``).  The norms, the dropout, the
bias and the residual add run on a rank's own rows; the rows are
gathered before the column-parallel projection, and the row-parallel
partial products are reduced and scattered on the sequence instead of
summed whole (the all-reduce split into its two halves).

Values are the port's per-shard lists over a 1-D ``Mesh`` (one tensor a
mp rank, ``distributed/mesh.py``); ``dim`` is the sequence dim, 1 by
default.  Autograd gives each operation the backward the reference's
``*Op`` names: a scatter's is a gather, a gather's a reduce-scatter.  The
``*Op`` classes are kept as markers so ported model code keeps its
shape; the two Linear layers take a tensor (the whole sequence, as a
layer that holds its whole weight computes it under the single
controller) or the per-rank lists.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from ..mesh import Mesh, all_gather as _gather, psum_scatter
from .mp_layers import ColumnParallelLinear, RowParallelLinear

__all__ = ["scatter", "all_gather", "reduce_scatter", "ScatterOp",
           "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
           "mark_as_sequence_parallel_parameter"]

Shards = List[torch.Tensor]


def _check_split(n: int, mesh: Mesh, what: str) -> None:
    if n % mesh.size:
        raise ValueError(f"{what} {n} does not split over {mesh.size} "
                         f"sequence-parallel ranks")


def scatter(xs: Sequence[torch.Tensor], mesh: Mesh, dim: int = 1) -> Shards:
    """A replicated value (one tensor a rank) -> each rank's chunk of the
    sequence (the reference's ScatterOp)."""
    _check_split(xs[0].shape[dim], mesh, "sequence length")
    return [x.chunk(mesh.size, dim)[d].contiguous()
            for d, x in enumerate(xs)]


def all_gather(xs: Sequence[torch.Tensor], mesh: Mesh,
               dim: int = 1) -> Shards:
    """Each rank's rows -> the whole sequence on every rank (AllGatherOp;
    its backward reduces and scatters)."""
    return _gather(xs, mesh, dim=dim)


def reduce_scatter(xs: Sequence[torch.Tensor], mesh: Mesh,
                   dim: int = 1) -> Shards:
    """Per-rank partial sums of the whole sequence -> each rank's rows of
    the sum (ReduceScatterOp)."""
    _check_split(xs[0].shape[dim], mesh, "sequence length")
    return psum_scatter(xs, mesh, dim=dim)


class ScatterOp:
    apply = staticmethod(scatter)


class GatherOp:
    apply = staticmethod(all_gather)


class AllGatherOp:
    apply = staticmethod(all_gather)


class ReduceScatterOp:
    apply = staticmethod(reduce_scatter)


def mark_as_sequence_parallel_parameter(parameter):
    """Marks a parameter used on each rank's rows (a norm's): its gradient
    sums over the mp group.  Ranks that share a device share the tensor, so
    autograd sums it; the hybrid trainer sums replicas on other devices."""
    parameter.sequence_parallel = True
    return parameter


def _mesh_of(xs: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> Mesh:
    return Mesh([x.device for x in xs]) if mesh is None else mesh


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """Column-parallel Linear whose input arrives as each rank's rows: the
    rows are gathered, then each rank multiplies the whole sequence by its
    column block."""

    def forward(self, x: Union[torch.Tensor, Sequence[torch.Tensor]],
                mesh: Optional[Mesh] = None):
        if isinstance(x, torch.Tensor):
            return super().forward(x)
        mesh = _mesh_of(x, mesh)
        full = all_gather(x, mesh)
        ws = self.weight.chunk(mesh.size, -1)
        bs = self.bias.chunk(mesh.size) if self.bias is not None \
            else [None] * mesh.size
        return [torch.matmul(f, w.to(f.device)) +
                (0 if b is None else b.to(f.device))
                for f, w, b in zip(full, ws, bs)]


class RowSequenceParallelLinear(RowParallelLinear):
    """Row-parallel Linear whose output leaves as each rank's rows: each
    rank's features times its row block, reduced and scattered on the
    sequence, then the replicated bias added on the rows."""

    def forward(self, x: Union[torch.Tensor, Sequence[torch.Tensor]],
                mesh: Optional[Mesh] = None):
        if isinstance(x, torch.Tensor):
            return super().forward(x)
        mesh = _mesh_of(x, mesh)
        ws = self.weight.chunk(mesh.size, 0)
        ys = reduce_scatter([torch.matmul(xi, w.to(xi.device))
                             for xi, w in zip(x, ws)], mesh)
        if self.bias is None:
            return ys
        return [y + self.bias.to(y.device) for y in ys]
