"""Deterministic fault injection for the serving engine's chaos tests (the
port's own copy of paddle_tpu/serving/faults.py, all 21 of its sites).

The engine's recovery paths (the watchdog's retry, the degradation
ladder, the quarantine rebuild and the circuit breaker of
serving/health.py) are only trustworthy if they are driven.  This module
names injection points threaded through the engine, the KV pools, the
prefix cache, the journal, the AOT store and the fleet tier (the router,
the KV handoff and the autoscaler), each firing on a configured
hit count, behind a hook that costs one attribute test when off (every
site guards with ``if faults is not None``; production engines hold no
injector).

Injection points (``POINTS``):

  =================  ====================================================
  ``kv_alloc``        ``KVPool.alloc`` raises (admission-time slot claim)
  ``block_alloc``     ``BlockPool.alloc`` raises (radix-cache block claim)
  ``block_exhausted`` ``PrefixCache._alloc_block`` reports an exhausted
                      pool (the graceful partial-insert path, no raise)
  ``gather``          ``BlockPool.load_row_into`` raises before any copy
                      into the staging lane
  ``scatter``         ``BlockPool.store_row`` raises before any copy out
                      of the slot
  ``step``            the engine raises inside the decode region of
                      ``step()``, before any dispatch (drives the
                      watchdog's retry and quarantine)
  ``nan_logits``      the engine writes NaN into one live slot's KV row
                      in place, so the non-finite check after the
                      device's logits fires
  ``slow_step``       the engine sleeps ``seconds`` at the top of the
                      step (a straggler; drives the deadline checks)
  ``handoff_gather``  the fleet's KV handoff raises before the source's
                      pinned blocks are read, before any destination
                      state exists (serving/handoff.py; arm on the
                      injector passed to ``Router``)
  ``handoff_scatter`` ``EngineCore.adopt_prompt_kv`` raises after the
                      destination's transient slot is claimed, before
                      any block lands (the slot is freed on every path)
  ``handoff_commit``  ``HandoffManager.commit`` raises after the blocks
                      landed, before the source pin is released: the
                      handoff aborts and the request re-prefills
  ``replica_spawn``   ``Autoscaler.spawn`` raises before the factory
                      runs: the router's topology is untouched (arm on
                      the injector passed to ``Autoscaler``)
  ``journal_write``   ``Journal._write`` raises before the record's
                      frame lands: the journal queues the record for
                      retry and no request fails (serving/journal.py;
                      arm on the injector passed to ``Journal.open``)
  ``journal_fsync``   ``Journal._sync`` raises at the fsync: the bytes
                      stay in the OS cache and the next sync covers them
  ``journal_replay``  the open scan raises while folding a record: one
                      fault retries the scan from scratch, a persistent
                      one raises ``JournalError``
  ``replica_crash``   ``Router.step`` kills the lowest-index live replica
                      (a simulated SIGKILL: no drain, no close)
  ``replica_slow``    ``Router.step`` sleeps ``seconds`` inside the
                      lowest-index live replica's timed step (a
                      straggler seen by the router, engine untouched)
  ``hedge_submit``    ``Router.issue_hedge`` drops the duplicate before it
                      lands anywhere: the hedge fails closed
  ``aot_load``        the engine's attach of ONE leg of the AOT store
                      raises before the leg is read (serving/aot.py; arm
                      on the engine's injector): that leg is captured at
                      first use instead
  ``aot_store_corrupt`` ``AOTStore`` reports a leg's read corrupt (the
                      path a CRC mismatch takes; arm on the injector
                      passed to ``AOTStore.open``)
  ``spec_verify``     the engine raises on a speculative step, after the
                      draft phase and before the verify dispatch (nothing
                      mutated yet): the ladder's ``spec_verify`` rung
  =================  ====================================================

Faults are armed per site with ``enable(site, at=..., times=...)``: the
site's hit counter increments on every pass through the hook, and the
fault fires on hits ``at, at+1, ..., at+times-1`` counted from the arming,
so the same workload replayed with the same arming hits the same faults.
Pair every ``enable`` with a ``disable`` in a ``finally``.

``FaultError`` carries ``.site`` and ``.hit`` so recovery code and tests
can tell which injected fault an unwind came from.
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["FaultError", "FaultInjector", "POINTS"]

POINTS = ("kv_alloc", "block_alloc", "block_exhausted", "gather",
          "scatter", "step", "nan_logits", "slow_step",
          # the fleet's KV handoff stages and the autoscaler's spawn:
          # router-level sites (arm on the injector passed to Router /
          # Autoscaler, not on a replica engine's)
          "handoff_gather", "handoff_scatter", "handoff_commit",
          "replica_spawn",
          # the durable request journal (arm on the injector passed to
          # Journal.open) and the router's simulated replica SIGKILL
          "journal_write", "journal_fsync", "journal_replay",
          "replica_crash",
          # the router's straggler and hedge-submission sites
          "replica_slow", "hedge_submit",
          # the AOT store (aot_load on the engine's injector,
          # aot_store_corrupt on the one passed to AOTStore.open)
          "aot_load", "aot_store_corrupt",
          "spec_verify")


class FaultError(RuntimeError):
    """Raised by an armed injection point (never by production code)."""

    def __init__(self, site: str, hit: int):
        super().__init__(f"injected fault at {site!r} (hit {hit})")
        self.site = site
        self.hit = hit


class _Armed:
    __slots__ = ("at", "times", "seconds", "fired")

    def __init__(self, at: int, times: int, seconds: float):
        self.at = at
        self.times = times
        self.seconds = seconds
        self.fired = 0


class FaultInjector:
    """Per-engine fault plan: arm sites, count hits, fire precisely.

    Pure host state; pass one instance as ``ServingEngine(...,
    faults=...)`` and it reaches the engine, both pools and the prefix
    cache.  The counters survive ``disable``, so a test can assert how
    often each site was passed and fired."""

    def __init__(self):
        self._armed: Dict[str, _Armed] = {}
        self.hits: Dict[str, int] = {p: 0 for p in POINTS}
        self.fired: Dict[str, int] = {p: 0 for p in POINTS}

    # ------------------------------------------------------------ arming
    def enable(self, site: str, at: int = 0, times: int = 1,
               seconds: float = 0.0) -> None:
        """Arm ``site`` to fire on its next ``times`` hits starting at hit
        ``at`` (counted from the site's current hit count: ``at=0`` is the
        very next pass).  ``seconds`` parameterises ``slow_step`` and
        ``replica_slow``."""
        if site not in POINTS:
            raise ValueError(
                f"unknown fault site {site!r}; known: {POINTS}")
        if times < 1:
            raise ValueError("times must be >= 1")
        if at < 0:
            raise ValueError("at must be >= 0")
        self._armed[site] = _Armed(self.hits[site] + at, times, seconds)

    def disable(self, site: str) -> None:
        """Disarm ``site`` (idempotent; counters are kept)."""
        self._armed.pop(site, None)

    def disable_all(self) -> None:
        self._armed.clear()

    @property
    def active(self) -> bool:
        return bool(self._armed)

    # ------------------------------------------------------------ firing
    def check(self, site: str) -> Optional[_Armed]:
        """One pass through ``site``: bump its hit counter and return the
        armed record when the fault fires (None otherwise).  The caller
        applies the effect (raise, sleep, poison)."""
        hit = self.hits[site]
        self.hits[site] = hit + 1
        armed = self._armed.get(site)
        if armed is None or not armed.at <= hit < armed.at + armed.times:
            return None
        armed.fired += 1
        self.fired[site] += 1
        return armed

    def fire(self, site: str) -> bool:
        """``check()``, raising :class:`FaultError` when armed: the shape
        of every raising site.  Returns False when the fault did not
        fire."""
        if self.check(site) is not None:
            raise FaultError(site, self.hits[site] - 1)
        return False
