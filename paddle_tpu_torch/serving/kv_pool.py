"""Slot-pooled KV cache for continuous batching (counterpart of
paddle_tpu/serving/kv_pool.py).

One fixed allocation ``[num_slots, max_seq, kv_heads, head_dim]`` per
layer per k/v holds EVERY in-flight request's context; a slot is one
request's row.  The pool never reallocates: admission writes a freshly
prefilled context into a free slot (``adopt``), eviction just returns the
slot index to the free list (the stale rows are overwritten by the next
occupant, and masked until then by the per-slot ``seq_pos`` that feeds
decode attention).

The reference donates its buffers to each compiled step so XLA updates
them in place; the port updates the same tensors in place directly
(``append_kv``, ``copy_``, ``index_copy_``), so pool memory stays one
allocation for the engine's lifetime.

With a tensor-parallel ``mesh`` (serving/tp.py) every slot slab, block
slab and the staging lane is a per-shard list instead of one tensor:
member ``d`` is a contiguous ``[rows, len, kv_heads/tp, head_dim]``
holding shard ``d``'s kv-head group on its device (the reference's
``KV_SLAB_SPEC``, the slabs split on the kv-head axis).  Copies between
the pools run shard by shard, never across shards.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..models.kv_cache import gather_block_rows, scatter_block_rows
from .tp import sharded_zeros

__all__ = ["KVPool", "BlockPool"]


def _kv_heads(cfg) -> int:
    return getattr(cfg, "kv_heads", None) or cfg.num_heads


def _shards(x) -> list:
    """A slab's per-shard members: the list itself under a mesh, else the
    one tensor."""
    return x if isinstance(x, list) else [x]


def _slabs(shape, dtype, device, mesh, n: int) -> list:
    """``n`` zero slabs of ``shape``: tensors on ``device``, or per-shard
    lists split on the kv-head axis over ``mesh``."""
    if mesh is None:
        return [torch.zeros(shape, dtype=dtype, device=device)
                for _ in range(n)]
    return [sharded_zeros(mesh, shape, dtype) for _ in range(n)]


class KVPool:
    """Fixed-shape KV slab + free-list slot accounting.

    Device state:
      * ``ks/vs``   — per-layer [num_slots, max_seq, kv_heads, head_dim]
        (per-shard lists under a mesh);
      * ``seq_pos`` — [num_slots] int32, each slot's current cache length
        (the per-row ``pos`` the models append at AND, after the in-step
        +1, the ``seq_lens`` decode attention masks by).

    Host state: the free list.  Alloc/free are host-side list ops plus at
    most one small device write — never a sync.
    """

    def __init__(self, num_slots: int, max_seq: int, num_layers: int,
                 kv_heads: int, head_dim: int, *, device: torch.device,
                 dtype: torch.dtype = torch.float32, mesh=None):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.num_layers = num_layers
        self.mesh = mesh
        # the position vector lives on the controller: the mesh's first
        # device
        self.device = device if mesh is None else mesh.devices[0]
        shape = (num_slots, max_seq, kv_heads, head_dim)
        self.ks: List = _slabs(shape, dtype, device, mesh, num_layers)
        self.vs: List = _slabs(shape, dtype, device, mesh, num_layers)
        self.seq_pos = torch.zeros((num_slots,), dtype=torch.int32,
                                   device=self.device)
        self._free: List[int] = list(range(num_slots - 1, -1, -1))
        # lifetime slot-churn counters (reported by metrics_dict)
        self.alloc_count = 0
        self.free_count = 0
        # chaos hook (serving/faults.py): None in production
        self.faults = None

    @classmethod
    def create(cls, model, num_slots: int, max_seq=None,
               mesh=None) -> "KVPool":
        """Size the pool from a causal LM's config, on the model's device
        and in its dtype; with ``mesh`` the slabs split on the kv-head axis
        over the tensor-parallel mesh."""
        cfg = model.cfg
        return cls(num_slots, max_seq or cfg.max_seq_len, cfg.num_layers,
                   _kv_heads(cfg), cfg.head_dim, device=model.device,
                   dtype=model.dtype, mesh=mesh)

    # ------------------------------------------------------------ slots
    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def used_slots(self) -> int:
        return self.num_slots - len(self._free)

    def alloc(self) -> int:
        """Claim a free slot (lowest index first).  Raises if the pool is
        full — the scheduler gates admission on ``free_slots``."""
        if self.faults is not None:
            self.faults.fire("kv_alloc")
        if not self._free:
            raise RuntimeError("KVPool exhausted: no free slot")
        self.alloc_count += 1
        return self._free.pop()

    def free(self, slot: int) -> None:
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} out of range")
        if slot in self._free:
            raise ValueError(f"slot {slot} already free (double free)")
        self.free_count += 1
        self._free.append(slot)
        self._free.sort(reverse=True)
        # park the freed row at position 0 so its ride-along decode writes
        # start at the row head until the next adopt overwrites it
        self.seq_pos[slot] = 0

    def reset(self) -> None:
        """Return every slot to the free list; the slabs stay allocated
        (stale rows are masked by ``seq_pos`` 0 until overwritten)."""
        self._free = list(range(self.num_slots - 1, -1, -1))
        self.seq_pos.zero_()

    def adopt(self, slot: int, layer_caches, length: int,
              set_pos: bool = True) -> None:
        """Copy a freshly prefilled single-request cache (per-layer
        ``(k [1, max_seq, h, d], v, ...)`` tuples) into ``slot`` and
        record its ``length`` valid positions (``set_pos=False`` skips
        the position write, for a slot no decode reads)."""
        for i, layer in enumerate(layer_caches):
            for dst, src in zip(_shards(self.ks[i]), _shards(layer[0])):
                dst[slot].copy_(src[0])
            for dst, src in zip(_shards(self.vs[i]), _shards(layer[1])):
                dst[slot].copy_(src[0])
        if set_pos:
            self.seq_pos[slot] = length

    def slot_rows(self, slot: int):
        """``slot``'s per-layer ``[max_seq, h, d]`` k and v rows, views into
        the slabs (per-shard lists under a mesh)."""
        def rows(slabs):
            return [[s[slot] for s in x] if isinstance(x, list) else x[slot]
                    for x in slabs]
        return rows(self.ks), rows(self.vs)


class BlockPool:
    """The SECOND fixed-shape KV slab: per-layer
    ``[num_blocks, block_len, kv_heads, head_dim]`` block rows holding
    cached PREFIX context, shared across requests.  The radix tree
    (serving/prefix_cache.py) owns which block holds which token span —
    this class owns only the device memory and the two copies:

      * ``load_row_into(idx, ks, vs)`` — gather ``max_seq // block_len``
        block rows in place into the engine's ``[1, max_seq]`` staging
        lane (ids past the true match gather stale rows that ``seq_lens``
        masks downstream);
      * ``store_row(pool, slot, dest)`` — split pool slot ``slot``'s row
        into blocks and write block j to ``dest[j]``; entries equal to
        ``num_blocks`` are dropped, so one call writes any subset of a
        prompt's blocks.

    Block lifecycle (alloc / free / refcount / LRU) is host-side list
    accounting.
    """

    def __init__(self, num_blocks: int, block_len: int, max_seq: int,
                 num_layers: int, kv_heads: int, head_dim: int, *,
                 device: torch.device, dtype: torch.dtype = torch.float32,
                 mesh=None):
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        if block_len < 1:
            raise ValueError("block_len must be >= 1")
        if max_seq % block_len:
            raise ValueError(
                f"block_len {block_len} must divide max_seq {max_seq} "
                f"(block boundaries must tile the slot row)")
        self.num_blocks = num_blocks
        self.block_len = block_len
        self.max_seq = max_seq
        self.num_layers = num_layers
        self.mesh = mesh
        self.blocks_per_row = max_seq // block_len
        shape = (num_blocks, block_len, kv_heads, head_dim)
        # the block slabs split on the same kv-head axis as the slot
        # slabs, so the copies between them never cross shards
        self.bks: List = _slabs(shape, dtype, device, mesh, num_layers)
        self.bvs: List = _slabs(shape, dtype, device, mesh, num_layers)
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        # chaos hook (serving/faults.py): None in production
        self.faults = None

    @classmethod
    def create(cls, model, num_blocks: int, block_len: int,
               max_seq: int, mesh=None) -> "BlockPool":
        cfg = model.cfg
        return cls(num_blocks, block_len, max_seq, cfg.num_layers,
                   _kv_heads(cfg), cfg.head_dim, device=model.device,
                   dtype=model.dtype, mesh=mesh)

    # ------------------------------------------------------------ blocks
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self) -> int:
        if self.faults is not None:
            self.faults.fire("block_alloc")
        if not self._free:
            raise RuntimeError("BlockPool exhausted: no free block")
        return self._free.pop()

    def free(self, block: int) -> None:
        if not 0 <= block < self.num_blocks:
            raise ValueError(f"block {block} out of range")
        if block in self._free:
            raise ValueError(f"block {block} already free (double free)")
        self._free.append(block)

    # ------------------------------------------------------------ copies
    def load_row_into(self, idx, ks, vs) -> None:
        """Gather blocks ``idx`` ([blocks_per_row] ids, padded past the
        match with any value) in place into the per-layer ``[1, max_seq,
        h, d]`` staging rows ``ks`` / ``vs`` (per-shard lists under a
        mesh), overwriting every row of them."""
        if self.faults is not None:
            self.faults.fire("gather")
        idx = torch.as_tensor(np.asarray(idx, np.int64))
        for blocks, rows in ((self.bks, ks), (self.bvs, vs)):
            for b, row in zip(blocks, rows):
                for s, r in zip(_shards(b), _shards(row)):
                    gather_block_rows(s, idx.to(s.device), out=r[0])

    def gather_blocks_into(self, blocks, ks, vs) -> None:
        """Gather block rows ``blocks`` (ids in prefix order) in place into
        the first ``len(blocks) * block_len`` positions of the per-layer
        ``[rows, h, d]`` rows ``ks`` / ``vs`` (per-shard lists under a
        mesh, split as this pool's slabs are, on the same devices): the
        fleet's KV handoff, straight into another engine's slot rows.  A
        destination laid out otherwise raises (the handoff then aborts to
        a re-prefill)."""
        if self.faults is not None:
            self.faults.fire("gather")
        n = len(blocks) * self.block_len
        ids = np.asarray(blocks, np.int64)
        on: dict = {}
        for slabs, rows in ((self.bks, ks), (self.bvs, vs)):
            for b, row in zip(slabs, rows):
                src, dst = _shards(b), _shards(row)
                if [s.device for s in src] != [r.device for r in dst]:
                    raise ValueError(
                        f"the destination's K/V lies on "
                        f"{[str(r.device) for r in dst]}, this block pool's "
                        f"on {[str(s.device) for s in src]}: a handoff "
                        f"needs the same devices and kv-head split")
                for s, r in zip(src, dst):
                    idx = on.get(s.device)
                    if idx is None:
                        idx = on[s.device] = torch.as_tensor(ids).to(
                            s.device)
                    gather_block_rows(s, idx, out=r[:n])

    def store_row(self, pool: KVPool, slot: int, dest) -> None:
        """Write pool slot ``slot``'s row into block rows ``dest``
        ([blocks_per_row] host ints; entries == num_blocks are dropped),
        in place."""
        if self.faults is not None:
            self.faults.fire("scatter")
        dest = np.asarray(dest, np.int64)
        for blocks, slabs in ((self.bks, pool.ks), (self.bvs, pool.vs)):
            for b, k in zip(blocks, slabs):
                for bs, ks in zip(_shards(b), _shards(k)):
                    scatter_block_rows(bs, ks[slot], dest)
