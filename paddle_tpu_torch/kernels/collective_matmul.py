"""Collective matmuls for tensor-parallel decode (counterpart of
paddle_tpu/kernels/collective_matmul.py).

The two tensor-parallel boundaries of a transformer layer, each split
into ``tp`` ring hops so that a hop's copy and the next hop's product do
not depend on each other:

  * **entry** (:func:`allgather_matmul`) — the residual stream arrives
    slot-sharded ``[B/tp, K]``; the QKV / MLP-up projection needs every
    slot against this shard's column block ``[K, N/tp]``.  At each hop a
    shard multiplies the activation shard it holds while ``ppermute``
    forwards that shard to its neighbour;
  * **exit** (:func:`matmul_reduce_scatter`) — the out-projection /
    MLP-down product is a per-shard PARTIAL sum ``[B, N]`` that must be
    summed and re-scattered over slots.  At each hop a shard computes the
    partial of one destination chunk and forwards the travelling
    accumulator.

``overlap=False`` runs the serialized form (``all_gather`` /
``psum_scatter`` around one product).  Values are per-shard lists over a
:class:`~paddle_tpu_torch.distributed.mesh.Mesh`.  The ring drivers
:func:`entry_ring` and :func:`exit_ring` take the per-hop product as a
function, so the composed path here (``torch.matmul`` per hop, as the
reference leaves it to XLA) and the decode-block kernels'
(kernels/decode_block_tp.py) run one schedule and cannot drift.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..distributed.mesh import Mesh, all_gather, ppermute, psum_scatter

__all__ = ["RingSchedule", "ring_schedule", "entry_ring", "exit_ring",
           "allgather_matmul", "matmul_reduce_scatter"]


class RingSchedule:
    """The ring decomposition's bookkeeping, shared by every ring driver.

    Forward ring: shard ``d`` sends to ``d + 1 (mod tp)``.  After ``hop``
    forward hops a shard holds the activation shard that originated
    ``hop`` positions behind it (:meth:`entry_src`), and the travelling
    exit accumulator a shard computes a partial for at ``hop`` is the
    chunk that finishes at this shard after the remaining hops
    (:meth:`exit_chunk`: the final hop lands on the shard's own
    chunk)."""

    def __init__(self, tp: int):
        if tp < 1:
            raise ValueError(f"ring needs tp >= 1, got {tp}")
        self.tp = tp
        self.perm: List[Tuple[int, int]] = \
            [(d, (d + 1) % tp) for d in range(tp)]

    def entry_src(self, idx: int, hop: int) -> int:
        """Origin shard of the activation shard held at ``hop``."""
        return (idx - hop) % self.tp

    def exit_chunk(self, idx: int, hop: int) -> int:
        """Row chunk whose partial the exit ring computes at ``hop``."""
        return (idx - hop - 1) % self.tp


def ring_schedule(tp: int) -> RingSchedule:
    """The shared ring schedule for ``tp`` shards."""
    return RingSchedule(tp)


HopFn = Callable[[int, torch.Tensor], torch.Tensor]


def entry_ring(xs: Sequence[torch.Tensor], mesh: Mesh,
               hop: HopFn) -> List[torch.Tensor]:
    """The all-gather ring: ``hop(idx, buf)`` is shard ``idx``'s product
    of the activation shard ``buf [B_l, K]`` it holds, ``[B_l, N_l]``.
    Returns per shard ``[B_l * tp, N_l]``: row block ``s`` is the product
    of shard ``s``'s activations."""
    tp = mesh.size
    ring = ring_schedule(tp)
    b_l = xs[0].shape[0]
    outs: List[Optional[torch.Tensor]] = [None] * tp
    buf = list(xs)
    for h in range(tp):
        # the forward of the held shard and this hop's products both
        # read `buf`; neither reads the other's result
        nxt = ppermute(buf, mesh, ring.perm) if h < tp - 1 else None
        for idx in range(tp):
            chunk = hop(idx, buf[idx])
            if outs[idx] is None:
                outs[idx] = chunk.new_empty((b_l * tp, chunk.shape[1]))
            src = ring.entry_src(idx, h)
            outs[idx][src * b_l:(src + 1) * b_l] = chunk
        buf = nxt
    return outs


def exit_ring(ys: Sequence[torch.Tensor], mesh: Mesh,
              hop: HopFn) -> List[torch.Tensor]:
    """The reduce-scatter ring: ``hop(idx, chunk)`` is shard ``idx``'s
    partial product of the row chunk ``chunk [B_l, K_l]`` of its
    ``ys[idx] [B, K_l]``.  The arriving accumulator is added outside the
    hop, in the partial's dtype.  Returns per shard ``[B_l, N]``: the sum
    over shards of their partials of that shard's row chunk."""
    tp = mesh.size
    ring = ring_schedule(tp)
    b_l = ys[0].shape[0] // tp
    acc: List[Optional[torch.Tensor]] = [None] * tp
    for h in range(tp):
        for idx in range(tp):
            c = ring.exit_chunk(idx, h)
            part = hop(idx, ys[idx][c * b_l:(c + 1) * b_l])
            acc[idx] = part if acc[idx] is None else acc[idx] + part
        if h < tp - 1:
            acc = ppermute(acc, mesh, ring.perm)
    return acc


def allgather_matmul(xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                     mesh: Mesh, *, overlap: bool = True
                     ) -> List[torch.Tensor]:
    """Per shard ``concat_over_shards(x) @ w``: ``xs[d] [B_l, K]`` is
    shard ``d``'s slot shard of the activation, ``ws[d] [K, N_l]`` its
    column block of the weight.  Returns per shard ``[B_l * tp, N_l]``.
    ``overlap=True`` runs the ring, ``False`` ``all_gather`` then one
    product (each row contracts the full K either way)."""
    if mesh.size == 1:
        return [xs[0] @ ws[0]]
    if not overlap:
        return [xa @ w for xa, w in zip(all_gather(xs, mesh, 0), ws)]
    return entry_ring(xs, mesh, lambda idx, buf: buf @ ws[idx])


def matmul_reduce_scatter(xs: Sequence[torch.Tensor],
                          ws: Sequence[torch.Tensor], mesh: Mesh, *,
                          overlap: bool = True) -> List[torch.Tensor]:
    """Per shard ``d``: row chunk ``d`` of ``sum_over_shards(x @ w)``.
    ``xs[d] [B, K_l]`` holds every slot's rows against shard ``d``'s
    contraction block, ``ws[d] [K_l, N]`` its row block of the exit
    weight.  Returns per shard ``[B // tp, N]``.  ``overlap=True`` runs
    the ring (a chain of adds in hop order), ``False`` one product then
    ``psum_scatter``; the two sum in different orders."""
    if mesh.size == 1:
        return [xs[0] @ ws[0]]
    if not overlap:
        return psum_scatter([x @ w for x, w in zip(xs, ws)], mesh, 0)
    return exit_ring(xs, mesh, lambda idx, chunk: chunk @ ws[idx])
