"""A 1-D tensor-parallel mesh driven by one process (the port's
counterpart of the reference's ``jax.sharding.Mesh`` plus the
``shard_map`` collectives its tensor-parallel code uses: ``psum``,
``all_gather``, ``ppermute`` and ``axis_index``).

The reference is single-controller: one process drives every shard of
its ``shard_map`` program.  The port keeps that model.  A sharded value
is a plain Python list with one tensor per shard, each on its shard's
device; per-shard work is a loop over the shards (the loop index is the
reference's ``axis_index``), and each shard's launches go to its device's
current stream.  Collectives are plain functions over such lists:

  * :func:`psum` — the elementwise sum over shards, in shard order,
    replicated onto every shard's device;
  * :func:`all_gather` — the shards concatenated along ``dim`` (tiled),
    on every shard's device;
  * :func:`ppermute` — shard ``src``'s tensor copied onto shard ``dst``'s
    device for every ``(src, dst)`` pair (``copy_`` into a fresh buffer:
    a peer copy between cards, a device-local copy when two shards share
    a card).

Shards may share one device (two shards on one card): the kernels then
do their full per-shard work and a hop is a copy on that card.  On a host
with several cards the same code places shard ``d`` on ``cuda:d`` and a
hop is a peer copy.  Collectives return fresh tensors; replicated results
of shards on one device may share storage, and nothing updates them in
place.

:class:`Grid` is the named N-D grid the hybrid-parallel topology lays its
ranks over (the reference's N-D ``Mesh`` with named axes): rank ``r`` sits
at the row-major coordinate of its shape and runs on ``devices[r]``; the
ranks of one axis's group form a 1-D :class:`Mesh` for the collectives
above.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple, Union

import torch

__all__ = ["Mesh", "Grid", "psum", "all_gather", "ppermute", "psum_scatter"]

Device = Union[str, torch.device]


def _device(d: Device) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """The ordered shard devices of a 1-D tensor-parallel mesh.  The same
    device may appear more than once (several shards on one card)."""

    def __init__(self, devices: Iterable[Device]):
        self.devices: List[torch.device] = [_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices == other.devices

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    def replicate(self, x: torch.Tensor) -> List[torch.Tensor]:
        """``x`` on every shard's device (shared where it already lies
        there)."""
        return [x.to(d) for d in self.devices]


class Grid:
    """Ranks laid over named axes: rank ``r`` is the row-major index of its
    coordinate in ``shape`` (axes in ``axis_names`` order) and runs on
    ``devices[r]``.  A device may repeat (several ranks on one card)."""

    def __init__(self, devices: Iterable[Device], axis_names: Sequence[str],
                 shape: Sequence[int]):
        self.devices: List[torch.device] = [_device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.dims = tuple(int(n) for n in shape)
        if len(self.axis_names) != len(self.dims):
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{len(self.dims)}-D shape")
        if len(self.devices) != math.prod(self.dims):
            raise ValueError(f"{len(self.devices)} devices for a grid of "
                             f"{math.prod(self.dims)} ranks {self.shape}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Grid({self.shape}, {[str(d) for d in self.devices]})"

    def coord(self, rank: int) -> Dict[str, int]:
        out = {}
        for name, n in reversed(list(zip(self.axis_names, self.dims))):
            rank, out[name] = divmod(rank, n)
        return {name: out[name] for name in self.axis_names}

    def rank(self, **coord: int) -> int:
        """The rank at ``coord`` (an axis left out is at 0)."""
        r = 0
        for name, n in zip(self.axis_names, self.dims):
            c = coord.get(name, 0)
            if not 0 <= c < n:
                raise ValueError(f"{name}={c} outside the axis of {n}")
            r = r * n + c
        return r

    def device(self, rank: int) -> torch.device:
        return self.devices[rank]

    def axis_ranks(self, axis: str, rank: int) -> List[int]:
        """The ranks of ``rank``'s group along ``axis`` (every other
        coordinate fixed), in axis order."""
        c = self.coord(rank)
        return [self.rank(**{**c, axis: i}) for i in range(self.shape[axis])]

    def axis_mesh(self, axis: str, rank: int) -> Mesh:
        """``rank``'s group along ``axis`` as a 1-D mesh."""
        return Mesh([self.devices[r] for r in self.axis_ranks(axis, rank)])


def _check(xs: Sequence[torch.Tensor], mesh: Mesh) -> None:
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} shards for a mesh of {mesh.size}")


def psum(xs: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Sum of the shards (added in shard order, in the shards' dtype) on
    every shard's device."""
    _check(xs, mesh)
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(total.device)
    return mesh.replicate(total)


def all_gather(xs: Sequence[torch.Tensor], mesh: Mesh,
               dim: int = 0) -> List[torch.Tensor]:
    """The shards concatenated along ``dim`` in shard order, on every
    shard's device."""
    _check(xs, mesh)
    by_device = {}
    out = []
    for d in mesh.devices:
        if d not in by_device:
            by_device[d] = torch.cat([x.to(d) for x in xs], dim=dim)
        out.append(by_device[d])
    return out


def psum_scatter(xs: Sequence[torch.Tensor], mesh: Mesh,
                 dim: int = 0) -> List[torch.Tensor]:
    """Shard ``d`` gets chunk ``d`` (along ``dim``) of the sum of the
    shards (tiled reduce-scatter)."""
    total = psum(xs, mesh)
    return [torch.chunk(t, mesh.size, dim=dim)[d].contiguous()
            for d, t in enumerate(total)]


def ppermute(xs: Sequence[torch.Tensor], mesh: Mesh,
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """For each ``(src, dst)`` in ``perm``, shard ``src``'s tensor copied
    onto shard ``dst``'s device; a shard no pair sends to gets zeros (the
    reference's ``ppermute``)."""
    _check(xs, mesh)
    out: List[torch.Tensor] = [None] * mesh.size
    for src, dst in perm:
        buf = torch.empty_like(xs[src], device=mesh.devices[dst])
        buf.copy_(xs[src], non_blocking=True)
        out[dst] = buf
    for d in range(mesh.size):
        if out[d] is None:
            out[d] = torch.zeros_like(xs[d])
    return out
