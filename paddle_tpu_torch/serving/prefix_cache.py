"""Radix prefix cache: reuse KV context across requests that share a
prompt prefix.

Production traffic is prefix-heavy — system prompts, few-shot templates,
multi-turn history — yet a slot-pooled engine that prefills every prompt
from token 0 recomputes the shared prefix for every arrival.  This
module eliminates that recompute: a HOST-SIDE radix tree over prompt
token ids maps block-aligned prefixes to rows of a second fixed-shape KV
slab (``kv_pool.BlockPool``), so admission

  1. matches the longest cached prefix (block granularity),
  2. gathers the matched block rows into the engine's staging lane with
     one gather once the request heads the prefill queue
     (``BlockPool.load_row_into`` — no recompute, no allocation), and
  3. prefills ONLY the uncached suffix at its pow2 bucket.

Tree shape: each edge carries exactly ``block_len`` token ids (the block
key), each node owns exactly one block row — a radix tree quantised to
block granularity, which is what makes node<->device-row ownership
one-to-one and the device copies fixed-shape.  All tree state is plain
host data: matching/insertion touch the device only through the block
pool's two copies (gather into the staging lane, scatter out of a
slot).  This is the port's own copy of
paddle_tpu/serving/prefix_cache.py.

Lifecycle:
  * ``match()``   pins the matched path (refcount +1 per node) until the
    engine calls ``release()`` at request finish — a pinned block can
    never be evicted while a live request will gather it (at admission
    the engine pins; the gather runs when the request heads the
    prefill queue);
  * ``insert()``  walks the prompt's full blocks after its prefill
    completes, copies the freshly computed blocks out of the request's
    pool slot (``BlockPool.store_row``) and extends the tree; when the
    block pool is exhausted it evicts LRU refcount-0 LEAVES, and if
    nothing is evictable it degrades gracefully to a partial (prefix of
    the prompt) insert — correctness never depends on an insert landing;
  * the last prompt token is NEVER served from cache: admission must
    prefill at least one suffix token to produce the logits the first
    sampled token comes from, so ``match()`` caps at
    ``(prompt_len - 1) // block_len`` blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .kv_pool import BlockPool, KVPool

__all__ = ["PrefixCache", "MatchResult"]


@dataclasses.dataclass
class MatchResult:
    """A pinned prefix match: ``tokens`` matched token count (a multiple
    of ``block_len``; 0 = miss), ``blocks`` the matched block ids in
    prefix order.  Hold it for the request's lifetime and hand it back to
    :meth:`PrefixCache.release` exactly once."""
    tokens: int
    blocks: List[int]
    _nodes: list = dataclasses.field(default_factory=list, repr=False)
    _released: bool = dataclasses.field(default=False, repr=False)


class _Node:
    __slots__ = ("key", "block", "parent", "children", "refcount",
                 "last_use")

    def __init__(self, key: Optional[bytes], block: Optional[int],
                 parent: Optional["_Node"]):
        self.key = key            # block_len token ids, as bytes
        self.block = block        # BlockPool row this node owns
        self.parent = parent
        self.children: Dict[bytes, _Node] = {}
        self.refcount = 0         # live requests pinning this node
        self.last_use = 0         # LRU tick


class PrefixCache:
    """Host radix tree + block-pool accounting.  One per engine; the
    engine is the only caller (``serving.engine.EngineCore``)."""

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self.block_len = pool.block_len
        self.max_match_blocks = pool.blocks_per_row
        self.root = _Node(None, None, None)
        self._tick = 0
        # optional event sink ``fn(name, **attrs)`` — the engine points
        # this at its tracer so LRU evictions land in the event log
        self.on_event = None
        # chaos hook (serving/faults.py): None in production
        self.faults = None
        # observability (engine merges these into its metrics snapshot)
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0
        self.inserted_blocks = 0

    # ----------------------------------------------------------- helpers
    def _block_keys(self, tokens, n_blocks: int) -> List[bytes]:
        toks = np.asarray(tokens, np.int32).reshape(-1)
        bl = self.block_len
        return [toks[i * bl:(i + 1) * bl].tobytes()
                for i in range(n_blocks)]

    def _matchable_blocks(self, prompt_len: int) -> int:
        # at least ONE token must prefill (its logits seed sampling), and
        # a match never exceeds one slot row of blocks
        return min((prompt_len - 1) // self.block_len,
                   self.max_match_blocks)

    def _bump(self, node: _Node) -> None:
        self._tick += 1
        node.last_use = self._tick

    # ------------------------------------------------------------- match
    def match_length(self, tokens) -> int:
        """Peek: matched token count for ``tokens`` without pinning
        anything (admission-cost estimates, scheduler budget checks)."""
        n = 0
        node = self.root
        toks = np.asarray(tokens, np.int32).reshape(-1)
        for key in self._block_keys(toks, self._matchable_blocks(len(toks))):
            child = node.children.get(key)
            if child is None:
                break
            node = child
            n += self.block_len
        return n

    def match(self, tokens, count_stats: bool = True) -> MatchResult:
        """Longest cached block-aligned prefix of ``tokens``; pins every
        node on the path (refcount +1) until :meth:`release`.  The fleet's
        KV handoff pins its export this way (no request on this engine
        holds it) and passes ``count_stats=False`` so the transfer does
        not count as an admission hit or miss."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        path: List[_Node] = []
        node = self.root
        for key in self._block_keys(toks, self._matchable_blocks(len(toks))):
            child = node.children.get(key)
            if child is None:
                break
            node = child
            path.append(node)
        for n in path:
            n.refcount += 1
            self._bump(n)
        matched = len(path) * self.block_len
        if count_stats:
            if path:
                self.hits += 1
                self.hit_tokens += matched
            else:
                self.misses += 1
        return MatchResult(tokens=matched,
                           blocks=[n.block for n in path], _nodes=path)

    def release(self, mr: MatchResult) -> None:
        """Unpin a match (idempotent): the request holding it finished."""
        if mr._released:
            return
        mr._released = True
        for n in mr._nodes:
            if n.refcount <= 0:
                raise RuntimeError(
                    "prefix-cache refcount underflow (double release?)")
            n.refcount -= 1

    # ------------------------------------------------------------- load
    def load_staging(self, mr: MatchResult, ks, vs) -> None:
        """Gather the matched blocks in place into the per-layer
        ``[1, max_seq, h, d]`` staging rows ``ks`` / ``vs`` (the engine's
        one staging lane)."""
        idx = np.zeros((self.max_match_blocks,), np.int32)
        idx[:len(mr.blocks)] = mr.blocks
        self.pool.load_row_into(idx, ks, vs)

    # ------------------------------------------------------------ insert
    def insert(self, tokens, kv_pool: KVPool, slot: int) -> int:
        """Cache the full blocks of ``tokens`` whose KV now sits in
        ``kv_pool`` slot ``slot`` (prefill just completed).  Existing
        path nodes are reused (and touched for LRU); new nodes allocate
        block rows, evicting LRU unpinned leaves when the pool is full.
        Returns the number of NEW blocks written (0 = fully cached
        already, or nothing evictable).  If a block claim or the copy
        raises, the nodes this call created are unlinked and their blocks
        freed before the error propagates: no node ever points at a block
        row its KV never reached."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        n_full = min(len(toks) // self.block_len, self.pool.blocks_per_row)
        dest = np.full((self.pool.blocks_per_row,), self.pool.num_blocks,
                       np.int32)                      # OOB = dropped
        node = self.root
        created: List[_Node] = []
        # transient pin: eviction pressure from THIS insert must never
        # take a node on the path being inserted (an LRU pass could
        # otherwise reap the leaf created two iterations ago, aliasing
        # two dest entries onto one block row)
        pinned: List[_Node] = []
        try:
            for j, key in enumerate(self._block_keys(toks, n_full)):
                child = node.children.get(key)
                if child is None:
                    block = self._alloc_block()
                    if block is None:
                        break                         # graceful partial
                    child = _Node(key, block, node)
                    node.children[key] = child
                    created.append(child)
                    dest[j] = block
                child.refcount += 1
                pinned.append(child)
                self._bump(child)
                node = child
            if created:
                self.pool.store_row(kv_pool, slot, dest)
        except BaseException:
            # the created nodes are the path's tail: unlink leaf first
            for n in reversed(created):
                del n.parent.children[n.key]
                self.pool.free(n.block)
            raise
        finally:
            for n in pinned:
                n.refcount -= 1
        self.inserted_blocks += len(created)
        return len(created)

    # ---------------------------------------------------------- eviction
    def _alloc_block(self) -> Optional[int]:
        if self.faults is not None \
                and self.faults.check("block_exhausted") is not None:
            return None      # injected exhaustion: graceful partial path
        if self.pool.free_blocks:
            return self.pool.alloc()
        victim = self._lru_unpinned_leaf()
        if victim is None:
            return None
        self._evict(victim)
        return self.pool.alloc()

    def _lru_unpinned_leaf(self) -> Optional[_Node]:
        best = None
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif n.refcount == 0:
                if best is None or n.last_use < best.last_use:
                    best = n
        return best

    def _evict(self, node: _Node) -> None:
        """Drop a leaf: return its block row to the pool and unlink.  The
        stale device row needs no scrub — nothing references a block the
        tree no longer reaches, and the next occupant overwrites it."""
        assert not node.children and node.refcount == 0
        del node.parent.children[node.key]
        self.pool.free(node.block)
        self.evictions += 1
        if self.on_event is not None:
            self.on_event("prefix_evict", block=node.block,
                          last_use=node.last_use)

    # ------------------------------------------------------------- state
    @property
    def cached_blocks(self) -> int:
        return self.pool.used_blocks

    def stats(self) -> Dict[str, int]:
        return {
            "prefix_hits": self.hits,
            "prefix_misses": self.misses,
            "prefix_hit_tokens": self.hit_tokens,
            "prefix_cached_blocks": self.cached_blocks,
            "prefix_evictions": self.evictions,
            "prefix_inserted_blocks": self.inserted_blocks,
        }
