"""Fleet-level total accounting: the chaos invariant as a library (the
port's own copy of paddle_tpu/serving/fleet.py).

The engine's chaos invariant is that after any injected fault sequence
every submitted request is terminal with a reason and the pools return
to baseline.  The fleet tier extends it across N replicas behind a
:class:`~paddle_tpu_torch.serving.router.Router`:

  (a) every FLEET request reaches a terminal status with a reason —
      failover may move a request between replicas, but it can never
      lose one;
  (b) every replica's ``KVPool`` free count, ``BlockPool`` block
      accounting and radix-tree refcounts sit at baseline once the
      fleet drains — a fault on one replica never leaks capacity on
      any;
  (c) no request is served twice: a failed-over request's total
      submissions never exceed two (original + one resubmission), and
      the router's delivered high-water mark keeps the client stream
      exactly-once;
  (d) disaggregated fleets additionally conserve the KV handoff: every
      opened handoff reached a terminal state (committed or aborted —
      staged == committed + aborted once drained), so no prefill-side
      radix pin or decode-side staging slot can be outstanding, and the
      per-replica baselines of (b) hold on prefill, decode AND retired
      replicas alike;
  (f) hedged requests (docs/serving.md "Tail latency") additionally
      conserve the RACE: every issued hedge reached a resolution (win
      or purge — no settled request still holds a live hedge record),
      a hedged request's total submissions still respect the
      attempts <= 2 bound of (c), and the loser's unwind left both
      replicas at the baselines of (b);
  (e) journaled fleets (``Router(journal=...)``) additionally conserve
      the LEDGER: every journaled submit record reaches EXACTLY ONE
      terminal record — across process incarnations — and the baselines
      of (b) hold on every SURVIVING replica (a killed replica is a
      dead process; its internals are unreadable by definition and it
      is excluded from the roll-up, which is precisely why the ledger
      check matters: the journal is the only accounting a crash cannot
      destroy).

These helpers compute the verdict as plain dicts so the tests,
``chip_smoke.py`` and operator tooling all read the same accounting.
Each replica's row carries its ``capture_counts`` (the CUDA graphs it
captured; the reference reports its decode trace count).  Pure host
code; call after a drain
(``router.run_until_complete()``) — a mid-flight fleet legitimately
holds slots and pins.
"""

from __future__ import annotations

from typing import Dict, List

__all__ = ["replica_accounting", "fleet_accounting", "TERMINAL_STATUSES"]

TERMINAL_STATUSES = ("finished", "cancelled", "deadline_exceeded",
                     "rejected", "failed")


def replica_accounting(engine) -> Dict[str, object]:
    """One replica's baseline check (a drained
    :class:`~paddle_tpu_torch.serving.api.ServingEngine`): free slots back to
    capacity, block pool conserved, zero radix pins, tree<->pool
    ownership intact, nothing queued or placed.  ``ok`` is the verdict;
    the rest is the diagnosis."""
    core = engine.core
    out: Dict[str, object] = {
        "free_slots": core.pool.free_slots,
        "num_slots": core.num_slots,
        "queue_depth": core.scheduler.queue_depth,
        "active": core.scheduler.active,
        "mid_prefill": len(core._prefills),
        "health": engine.health.state,
        "slow": engine.health.slow,
        "degraded_subsystems": list(engine.degraded_subsystems),
        "quarantines": core.health.quarantine_count,
        "capture_counts": dict(core.capture_counts),
    }
    slots_ok = (core.pool.free_slots == core.num_slots
                and core.scheduler.active == 0
                and core.scheduler.queue_depth == 0
                and not core._prefills)
    blocks_ok = pins_ok = tree_ok = True
    if core.block_pool is not None:
        bp = core.block_pool
        out["free_blocks"] = bp.free_blocks
        out["used_blocks"] = bp.used_blocks
        blocks_ok = bp.free_blocks + bp.used_blocks == bp.num_blocks
    if core.prefix_cache is not None:
        nodes = 0
        stack = list(core.prefix_cache.root.children.values())
        while stack:
            n = stack.pop()
            if n.refcount != 0:
                pins_ok = False
            nodes += 1
            stack.extend(n.children.values())
        out["radix_nodes"] = nodes
        tree_ok = nodes == core.block_pool.used_blocks
    out["ok"] = bool(slots_ok and blocks_ok and pins_ok and tree_ok)
    if not out["ok"]:
        out["violations"] = [name for name, ok in (
            ("slots", slots_ok), ("blocks", blocks_ok),
            ("radix_pins", pins_ok), ("tree_ownership", tree_ok)) if not ok]
    return out


def fleet_accounting(router) -> Dict[str, object]:
    """The fleet verdict over a drained router: per-request terminal
    statuses (invariant a), per-replica baselines (invariant b), the
    exactly-once bound (invariant c), and — for disaggregated fleets —
    handoff conservation (invariant d).  ``ok`` rolls them all up."""
    requests: List[Dict[str, object]] = []
    all_terminal = True
    once_ok = True
    for fid in sorted(router._requests):
        fr = router._requests[fid]
        out = router.result(fid)
        terminal = (out.finished and out.status in TERMINAL_STATUSES
                    and bool(out.status_reason))
        all_terminal &= terminal
        once_ok &= fr.attempts <= 2
        requests.append({
            "fleet_id": fid, "replica": fr.replica,
            "attempts": fr.attempts, "status": out.status,
            "reason": out.status_reason, "tokens": len(out.tokens),
            "delivered": fr.delivered,
            "failed_over": fr.attempts > 1 and not fr.hedged,
            "hedged": fr.hedged,
            "priority": fr.priority,
            "stage": fr.role_stage,
            "handoffs": fr.handoffs,
            # the failover audit trail: which replica surrendered the
            # request and why (empty for never-failed-over requests)
            "history": [{"replica": r, "reason": why}
                        for r, _, why in fr.history],
        })
    replicas = []
    for h in router.replicas:
        if h.killed:
            # a killed replica is a dead process: nothing inside it is
            # readable, so it carries no baseline verdict — invariant
            # (e)'s ledger check is what accounts for its casualties
            replicas.append({"ok": None, "role": h.role,
                             "retired": h.retired, "killed": True})
            continue
        ra = replica_accounting(h.engine)
        ra["role"] = h.role
        ra["retired"] = h.retired
        ra["killed"] = False
        replicas.append(ra)
    surviving_ok = all(r["ok"] for r in replicas if not r["killed"])
    # invariant d: the handoff ledger is conserved — nothing left
    # mid-flight, and every open matched a terminal transition
    mgr = router._handoffs
    handoffs_settled = (mgr.pending == 0
                        and mgr.staged == mgr.committed + mgr.aborted)
    # invariant f: every issued hedge reached a resolution — a settled
    # request still pointing at a live hedge record means the loser
    # was never unwound (its slot and pins are leaked on that replica)
    hedges_settled = all(fr.hedge_rid < 0
                         for fid, fr in router._requests.items()
                         if fid not in router._live)
    # invariant e: journal-ledger conservation — every journaled submit
    # reached exactly one terminal record (across incarnations; the
    # ledger folds every surviving segment).  flush() first so pending
    # retried writes (journal_write chaos) land before the audit.
    journal = getattr(router, "journal", None)
    journal_ok = True
    ledger_summary = None
    if journal is not None:
        journal.flush()
        led = journal.ledger()
        # rows with NO submit record are documented crash artifacts
        # (the submit write died with the process; docs/serving.md's
        # replay matrix: "unreplayable, skipped — nothing strands") —
        # reported as orphans, never as conservation violations
        bad = {rid: v for rid, v in led.items()
               if v["submits"] >= 1 and v["terminals"] != 1}
        orphans = sorted(rid for rid, v in led.items()
                         if v["submits"] == 0)
        journal_ok = not bad
        ledger_summary = {
            "requests": len(led),
            "violations": sorted(bad) if bad else [],
            "orphans": orphans,
            "pending_writes": journal.position()["pending_writes"],
        }
    ok = bool(all_terminal and once_ok and handoffs_settled
              and hedges_settled and journal_ok and surviving_ok)
    return {
        "ok": ok,
        "all_terminal": bool(all_terminal),
        "served_at_most_once_retry": bool(once_ok),
        "pools_at_baseline": surviving_ok,
        "handoffs_settled": bool(handoffs_settled),
        "hedges_settled": bool(hedges_settled),
        "hedges": router.metrics.c_hedges.value,
        "hedge_wins": router.metrics.c_hedge_wins.value,
        "handoffs_staged": mgr.staged,
        "handoffs_committed": mgr.committed,
        "handoffs_aborted": mgr.aborted,
        "handoff_blocks_moved": mgr.blocks_moved,
        "journal_conserved": bool(journal_ok),
        "journal_ledger": ledger_summary,
        "killed_replicas": sum(1 for r in replicas if r["killed"]),
        "requests": requests,
        "replicas": replicas,
        "failovers": router.metrics.c_failovers.value,
        "failovers_exhausted":
            router.metrics.c_failover_exhausted.value,
    }
