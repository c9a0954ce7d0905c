"""Fault-tolerant KV handoff between fleet replicas (the port's own copy
of paddle_tpu/serving/handoff.py).

The disaggregated fleet splits replicas into PREFILL and DECODE roles: a
prefill replica runs a long prompt's prefill, and the prompt's radix
blocks then MOVE to the chosen decode replica so its admission
re-prefills only the tail.  The hard part is surviving a fault at any
point of the transfer without leaking a block, a pool slot, or a radix
pin on either replica.  This module is that guarantee, written as an
explicit state machine:

    staged ──► in_flight ──► committed
       │            │
       └────────────┴──────► aborted

  * **staged** — the prompt's block path is matched and PINNED on the
    source replica (``EngineCore.export_prompt_kv``), up to the start of
    the last prefill chunk the source ran, which the destination runs
    again so that the first token it regenerates is the source's bit for
    bit; pinned blocks cannot be LRU-evicted, so the staged window may
    wait for a free slot on the destination;
  * **in_flight** — one transfer attempt: the destination claims a
    transient pool slot, the source's pinned blocks are gathered straight
    into that slot's rows (``EngineCore.export_gather``, run by
    ``EngineCore.adopt_prompt_kv``) and the destination's radix insert
    scatters them into its own block pool.  Both are eager copies: no
    graph is captured on either replica, and nothing the size of a
    ``[1, max_seq]`` staging row is allocated per transfer;
  * **committed** — the destination owns the blocks; the source pin is
    released (its copies stay cached and evictable);
  * **aborted** — any-stage failure: the source pin is released, the
    destination's transient slot was already returned by
    ``adopt_prompt_kv``'s own unwinding, and the router falls back to
    RE-PREFILLING on the decode side (or a terminal failure when nothing
    can serve): correctness never depends on a transfer landing.

Deterministic chaos (serving/faults.py, the ROUTER's injector): the
``handoff_gather`` / ``handoff_scatter`` / ``handoff_commit`` points fire
at the three stage boundaries — before any destination state exists,
after the destination's slot claim, and after the blocks landed.

The manager is host-side control plane owned by
``serving.router.Router``: it never steps an engine.
"""

from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["Handoff", "HandoffManager", "HANDOFF_STATES"]

STAGED = "staged"
IN_FLIGHT = "in_flight"
COMMITTED = "committed"
ABORTED = "aborted"
HANDOFF_STATES = (STAGED, IN_FLIGHT, COMMITTED, ABORTED)


class Handoff:
    """One prompt's transfer record: which replica pinned what, where it
    is going, and which terminal state it reached."""

    __slots__ = ("fleet_id", "src", "dst", "state", "tokens",
                 "blocks_moved", "transfer_attempts", "deferred_steps",
                 "reason", "_match", "_src_core")

    def __init__(self, fleet_id: int, src: int, match, src_core,
                 tokens: int):
        self.fleet_id = fleet_id
        self.src = src                  # source replica index
        self.dst = -1                   # chosen destination (set in flight)
        self.state = STAGED
        self.tokens = tokens            # pinned prefix length (tokens)
        self.blocks_moved = 0
        self.transfer_attempts = 0
        self.deferred_steps = 0         # staged scans spent waiting
        self.reason: Optional[str] = None    # why aborted (None else)
        self._match = match             # pinned MatchResult (or None)
        # the exact core whose tree holds the pin: if the source
        # quarantines mid-handoff its device plane (and radix tree) is
        # REBUILT — comparing against the live core detects that the
        # pinned path no longer exists and the transfer must abort
        self._src_core = src_core

    @property
    def terminal(self) -> bool:
        return self.state in (COMMITTED, ABORTED)

    def src_plane_alive(self) -> bool:
        """False once the source replica rebuilt its device plane (the
        pinned nodes belong to a discarded tree — gathering through
        their stale block ids would move garbage KV).  A rebuild that
        left NO cache at all (quarantine with the prefix cache
        ladder-bypassed sets ``prefix_cache = None``) is equally dead —
        it must not read as alive via a ``None is None`` comparison."""
        if self._match is None:
            return True
        cache = self._src_core.prefix_cache
        if cache is None:
            return False
        nodes = self._match._nodes
        if not nodes:
            return True                  # empty pin: nothing to gather
        # walk up to the root the pinned path hangs off; compare trees
        node = nodes[0]
        while node.parent is not None:
            node = node.parent
        return cache.root is node

    def __repr__(self) -> str:
        return (f"Handoff({self.fleet_id}, {self.src}->{self.dst}, "
                f"{self.state}, tokens={self.tokens}, "
                f"blocks={self.blocks_moved})")


class HandoffManager:
    """Owns every live :class:`Handoff` and the stage/transfer/commit/
    abort transitions.  The router decides WHEN to call each transition
    and with which replicas; this class guarantees the resource
    accounting — pin released exactly once, destination slot never
    leaked, every record terminal."""

    def __init__(self, faults=None, stage_patience: int = 16,
                 max_transfer_retries: int = 1):
        # chaos hook: the ROUTER's injector (serving/faults.py), None
        # in production
        self.faults = faults
        # staged scans to wait for a destination staging slot before
        # giving up on the transfer (the pin holds meanwhile)
        self.stage_patience = stage_patience
        self.max_transfer_retries = max_transfer_retries
        self.records: Dict[int, Handoff] = {}     # fleet_id -> live record
        # lifetime counters (the router mirrors them into obs)
        self.staged = 0
        self.committed = 0
        self.aborted = 0
        self.retries = 0
        self.blocks_moved = 0

    # ----------------------------------------------------------- staging
    def stage(self, fleet_id: int, src_handle, prompt,
              hit_tokens: int = 0) -> Handoff:
        """Open a handoff: pin ``prompt``'s cached path on the source
        replica, up to the last prefill chunk it ran from its radix hit
        ``hit_tokens`` (``EngineCore.export_prompt_kv``), and record the
        staged window.  Balance with :meth:`commit` or :meth:`abort` on
        every path."""
        core = src_handle.engine.core
        match = core.export_prompt_kv(prompt, hit_tokens)
        rec = Handoff(fleet_id, src_handle.index, match, core,
                      0 if match is None else match.tokens)
        self.records[fleet_id] = rec
        self.staged += 1
        return rec

    # ---------------------------------------------------------- transfer
    def transfer(self, rec: Handoff, src_handle, dst_handle,
                 prompt) -> bool:
        """One in-flight transfer attempt toward ``dst_handle``.
        Returns True on success (caller then :meth:`commit`\\ s); False
        when this attempt failed but a retry remains (the record drops
        back to ``staged``, pin still held).  Raises nothing: terminal
        failures abort internally and ALSO return False with
        ``rec.state == 'aborted'`` — the caller routes on the state."""
        if rec.terminal:
            raise RuntimeError(f"transfer on terminal handoff {rec!r}")
        rec.state = IN_FLIGHT
        rec.dst = dst_handle.index
        rec.transfer_attempts += 1
        try:
            if rec.tokens == 0:
                return True         # nothing cached: trivially complete
            if not rec.src_plane_alive():
                # the source quarantined mid-handoff: its rebuilt tree no
                # longer holds the pinned path — a retry can never
                # succeed, fall straight to the re-prefill recovery
                raise RuntimeError(
                    "source replica rebuilt its device plane mid-handoff "
                    "(pinned blocks discarded)")
            if self.faults is not None:
                self.faults.fire("handoff_gather")
            gather = src_handle.engine.core.export_gather(rec._match)
            # handoff_scatter fires INSIDE adopt_prompt_kv, after the
            # destination's transient slot is claimed and before the
            # gather into it runs — the injected fault proves the slot
            # unwinds
            moved = dst_handle.engine.core.adopt_prompt_kv(
                prompt, gather, rec.tokens, faults=self.faults)
            rec.blocks_moved = moved
            self.blocks_moved += moved
            return True
        except Exception as e:
            retryable = rec.src_plane_alive() \
                and rec.transfer_attempts <= self.max_transfer_retries
            if retryable:
                self.retries += 1
                rec.state = STAGED      # pin held; the next scan retries
                return False
            self.abort(rec, f"transfer failed: {e!r}")
            return False

    # ---------------------------------------------------------- terminal
    def commit(self, rec: Handoff) -> None:
        """Seal a successful transfer: the destination owns the blocks,
        the source pin is released (``handoff_commit`` chaos point fires
        BEFORE the release, so an injected commit fault exercises the
        abort path's pin unwinding with blocks already moved)."""
        if rec.terminal:
            return
        if self.faults is not None:
            self.faults.fire("handoff_commit")
        self._release(rec)
        rec.state = COMMITTED
        self.committed += 1
        del self.records[rec.fleet_id]

    def abort(self, rec: Handoff, reason: str) -> None:
        """Terminal failure of the transfer: release the source pin and
        record why.  Idempotent.  The destination's transient slot was
        already unwound by ``adopt_prompt_kv``'s own try/finally; any
        blocks that DID land on the destination are owned by its radix
        tree (evictable, fully accounted) — an aborted handoff leaks
        nothing on either replica."""
        if rec.terminal:
            return
        self._release(rec)
        rec.state = ABORTED
        rec.reason = reason
        self.aborted += 1
        self.records.pop(rec.fleet_id, None)

    def _release(self, rec: Handoff) -> None:
        if rec._match is not None:
            # release through the PINNING core's cache object: even if
            # the source rebuilt, the pinned nodes are host objects the
            # MatchResult still references — release is idempotent and
            # dead-tree releases are harmless
            rec._src_core.release_export(rec._match)

    # ------------------------------------------------------------- state
    @property
    def pending(self) -> int:
        """Live (non-terminal) handoffs — fleet ``has_work`` includes
        them so a staged transfer keeps the step loop running."""
        return len(self.records)

    def snapshot(self) -> List[Dict[str, object]]:
        return [{"fleet_id": r.fleet_id, "src": r.src, "dst": r.dst,
                 "state": r.state, "tokens": r.tokens,
                 "attempts": r.transfer_attempts,
                 "deferred_steps": r.deferred_steps}
                for r in self.records.values()]
