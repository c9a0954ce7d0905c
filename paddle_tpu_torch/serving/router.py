"""Fleet tier: a replica router over N serving engines (the port's own
copy of paddle_tpu/serving/router.py).

One :class:`Router` fronts N :class:`~paddle_tpu_torch.serving.api.
ServingEngine` replicas (each with its own device plane, ideally sharing
ONE obs registry and tracer so the fleet scrapes as a single surface) and
routes every ``submit()`` on real signals:

  * **prefix affinity** — ``EngineCore.prefix_probe(prompt)`` reports
    each replica's longest radix-cached prefix WITHOUT admitting or
    pinning (a pure host walk); the router picks the replica with the
    longest hit, tie-broken by load, so shared-prefix traffic (system
    prompts, multi-turn history) keeps landing where its KV already
    lives;
  * **health** — the watchdog's state machine (serving/health.py) is
    the routing input: replicas at ``quarantined``/``circuit_open`` are
    EXCLUDED, ``degraded`` and ``slow`` replicas are deprioritized behind
    healthy ones, and a replica being drained (:meth:`Router.drain`)
    takes no new work while its in-flight requests finish;
  * **SLO-aware admission** — the fleet-level bounded queue
    (``max_queue`` across all replicas) and each engine's own
    submit-time backpressure gate admission; when every eligible replica
    rejects, the router re-raises :class:`RequestRejected` carrying the
    BEST replica's ``retry_after_s`` and every replica's own refusal.

**Failover, exactly once.**  A request that dies with a
replica-attributed terminal ``failed`` status (a quarantine casualty, a
poisoned decode row, a prefill fault) is resubmitted ONCE to the best
healthy replica.  The fleet request id is the idempotency key:
``attempts`` caps total submissions at two, and the ``delivered``
high-water mark dedups the client-visible stream — the retry regenerates
tokens from position 0 with a fresh ``torch.Generator`` seeded from the
request's ``SamplingParams.seed`` (the engine seeds one per admission),
so the regenerated prefix is identical where the target runs the same
prefill chunks (in 16-bit types another chunk schedule can round another
way), and the router forwards only positions the client has not yet
seen.  Failures the CLIENT caused (a
raising stream callback) are never failed over.  ``cancel()``,
``result()``, ``stream()`` and ``purge()`` resolve through the router's
fleet-id -> (replica, engine-id) map, so they follow the request.

**Disaggregated prefill/decode roles.**  Each replica carries a role —
``prefill`` / ``decode`` / ``unified`` — and when the fleet holds
prefill replicas, long prompts take a TWO-PHASE path: the router submits
them to a prefill replica capped at ONE token, and when that prefill
finishes, the prompt's radix blocks before its last prefill chunk move
to the lightest-loaded decode replica through the fault-tolerant KV
handoff (serving/handoff.py: ``staged -> in_flight -> committed |
aborted``; eager copies that capture no graph), where the request is
resubmitted for its decode phase and runs that chunk again.  The first token was already delivered from the prefill side, and
the ``delivered`` mark dedups the decode side's regeneration exactly
like a failover retry.  A handoff fault at any stage retries once, falls
back to RE-PREFILLING on the decode side, or fails the request
terminally, never leaking a block, slot or radix pin on either replica.
Short prompts (below ``prefill_threshold``) skip the prefill plane.  An
attached :class:`~paddle_tpu_torch.serving.autoscaler.Autoscaler` sizes
the decode side against ``router.queue_depth``.

The router is host-side control plane: it steps the replicas one after
another (on one card their graphs never run at once) and adds no work to
any engine's step.  Replicas should be built with
``fault_tolerance=FaultToleranceConfig(...)``: the watchdog's
containment is what turns a replica fault into the terminal ``failed``
status the failover scan routes on; without it a step exception
propagates out of :meth:`Router.step`.  Fleet accounting lives in
``serving/fleet.py``.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .api import RequestOutput, ServingEngine
from .errors import EngineStalledError, RequestRejected
from .handoff import ABORTED, HandoffManager
from .health import CIRCUIT_OPEN, DEGRADED
from .scheduler import PRIORITIES, SamplingParams

__all__ = ["Router", "ReplicaHandle", "ROLES"]

# the routing roles a replica may carry: prefill replicas take only the
# router's prefill-stage submissions, decode replicas take decode-stage work,
# unified replicas take both (the single-role fleet default)
ROLES = ("prefill", "decode", "unified")

# terminal reasons a failover must never retry: the failure is
# attributed to the CLIENT's sink, not the replica — a resubmission
# would re-raise into the same callback and burn the retry for nothing
_CLIENT_FAULT_PREFIX = "stream callback"


class ReplicaHandle:
    """Router-side view of one replica: the engine plus the routing
    state the router owns about it (role, drain/retire flags, routed
    count, and the step-latency EWMA the straggler detector reads)."""

    __slots__ = ("index", "engine", "role", "draining", "retired",
                 "killed", "routed", "step_ewma_s", "slow_ticks",
                 "_slow_streak", "_fast_streak", "_observed")

    # EWMA smoothing for the router-measured per-replica step wall time
    # (the straggler detector's input): ~10-step memory — fast enough
    # to catch a real straggler, slow enough that hysteresis, not the
    # average, decides flapping
    STEP_EWMA_ALPHA = 0.2

    def __init__(self, index: int, engine: ServingEngine,
                 role: str = "unified"):
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        self.index = index
        self.engine = engine
        self.role = role
        self.draining = False
        # straggler-detection state:
        # the router times each replica's step() itself, so an
        # engine-internal stall (slow_step chaos, a real slow device)
        # and a router-level one (replica_slow chaos) both register;
        # slow_ticks counts consecutive fleet steps spent marked slow
        # (the autoscaler's replace-persistently-slow input)
        self.step_ewma_s = 0.0
        self.slow_ticks = 0
        self._slow_streak = 0
        self._fast_streak = 0
        self._observed = True      # had a BUSY step this fleet step
        # retired replicas keep their handle (indices stay stable in
        # the fleet-id map) but their engine is closed and they never
        # re-enter rotation — the autoscaler's drain-based retirement
        self.retired = False
        # killed replicas ALSO set retired (they left the fleet) but
        # their engine was never drained or closed — Router.kill's
        # simulated SIGKILL; fleet accounting skips their baselines
        # (a dead process returns nothing) and the autoscaler's
        # resurrection path spawns their replacement
        self.killed = False
        self.routed = 0          # fleet requests ever routed here

    def observe_step(self, seconds: float) -> None:
        """Fold one router-measured step wall time into the EWMA."""
        a = self.STEP_EWMA_ALPHA
        self.step_ewma_s = seconds if self.step_ewma_s == 0.0 \
            else (1 - a) * self.step_ewma_s + a * seconds

    @property
    def load(self) -> int:
        """Queued + placed requests — the affinity tie-breaker."""
        core = self.engine.core
        return core.scheduler.queue_depth + core.scheduler.active

    @property
    def health_rank(self) -> int:
        """The route-order deprioritization band: 0 healthy, 1 slow,
        2 degraded, 3 slow+degraded — healthy beats slow beats degraded among
        the ROUTABLE replicas (excluded states never reach the sort)."""
        h = self.engine.health
        return (2 if h.state == DEGRADED else 0) + (1 if h.slow else 0)

    def serves(self, stage: str) -> bool:
        """May this replica take new ``stage`` ("prefill"/"decode")
        work?  Role compatibility only — health/drain gates live in
        ``Router._eligible``."""
        if stage == "prefill":
            return self.role == "prefill"
        return self.role in ("decode", "unified")

    def __repr__(self) -> str:
        return (f"ReplicaHandle({self.index}, role={self.role!r}, "
                f"health={self.engine.health.state!r}, "
                f"draining={self.draining}, retired={self.retired}, "
                f"killed={self.killed}, load={self.load})")


class _FleetRequest:
    """One client-visible request's routing record.  ``fleet_id`` is
    the idempotency key: ``attempts`` caps submissions at two (original
    + one failover) and ``delivered`` is the exactly-once high-water
    mark for the client stream."""

    __slots__ = ("fleet_id", "prompt", "max_new_tokens", "sampling",
                 "eos_token_id", "client_stream", "deadline_s",
                 "ttft_deadline_s", "submit_time", "replica",
                 "engine_rid", "attempts", "delivered", "history",
                 "role_stage", "handoffs", "override", "priority",
                 "hedge_replica", "hedge_rid", "hedged",
                 "journal_hwm", "journaled_submit", "journaled_terminal",
                 "plan_start", "journaled_plan")

    def __init__(self, fleet_id: int, prompt: np.ndarray,
                 max_new_tokens: int, sampling, eos_token_id,
                 client_stream, deadline_s, ttft_deadline_s,
                 priority: str = "interactive"):
        self.fleet_id = fleet_id
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.sampling = sampling
        self.eos_token_id = eos_token_id
        self.client_stream = client_stream
        self.deadline_s = deadline_s
        self.ttft_deadline_s = ttft_deadline_s
        self.submit_time = 0.0        # perf_counter at FIRST submission
        self.replica = -1             # current owner (authoritative)
        self.engine_rid = -1
        self.attempts = 0
        self.delivered = 0            # client-visible token positions
        # (replica, engine_rid, status_reason) per surrendered attempt
        self.history: List[Tuple[int, int, str]] = []
        # disaggregated-fleet routing phase: "prefill" while the request
        # runs (one-token-capped) on a prefill replica, "decode" once it
        # owns a full submission on a decode/unified replica
        self.role_stage = "decode"
        self.handoffs = 0             # committed/aborted migrations
        self.priority = priority      # "interactive" | "batch"
        # hedged-request state: while
        # a hedge is live the request runs on TWO replicas — replica/
        # engine_rid is the primary attempt, hedge_replica/hedge_rid
        # the duplicate; first finished wins and the loser is purged.
        # ``hedged`` stays True after resolution: ONE hedge per fleet
        # id, ever (it consumed the attempts<=2 budget)
        self.hedge_replica = -1
        self.hedge_rid = -1
        self.hedged = False
        # router-level terminal stamp: set only when the handoff
        # machinery exhausts every placement (the engine-side record is
        # then a stale 1-token "finished" view); result() applies it
        self.override: Optional[Tuple[str, str]] = None
        # durable-journal bookkeeping: the last delivered mark journaled, and
        # the exactly-once guards for the submit/terminal records
        self.journal_hwm = 0
        self.journaled_submit = False
        self.journaled_terminal = False
        # the radix hit the attempt that delivered the first token planned
        # its chunks from (None until a token is delivered): every
        # regeneration runs the rows from it in the same chunks
        self.plan_start: Optional[int] = None
        self.journaled_plan = False


class _RouterMetrics:
    """The router's obs instruments, bound get-or-create into the
    (usually shared) registry."""

    def __init__(self, registry, tracer):
        self.registry = registry
        self.tracer = tracer
        self.lane = tracer.claim_lane_block()
        tracer.set_lane_name(self.lane, "serving.router", pin=True)
        g, c = registry.gauge, registry.counter
        self.g_replicas = g("router.replicas",
                            "replicas fronted by this router")
        self.g_healthy = g("router.healthy_replicas",
                           "replicas currently routable (healthy or "
                           "degraded, not draining)")
        self.g_draining = g("router.draining_replicas",
                            "replicas draining (no new admissions)")
        self.g_queue = g("router.queue_depth",
                         "fleet-wide waiting requests at the last step")
        self.c_routed = c("router.requests_routed",
                          "fleet submissions accepted and routed")
        self.c_hit_tokens = c("router.prefix_hit_tokens",
                              "prompt tokens the routed replica's radix "
                              "cache already held at routing time")
        self.c_failovers = c("router.failovers",
                             "requests resubmitted to a healthy replica "
                             "after a replica-attributed failure")
        self.c_failover_exhausted = c(
            "router.failovers_exhausted",
            "replica-attributed failures that could NOT fail over "
            "(retry spent, deadline blown, or no replica accepted)")
        self.c_rejected = c("router.requests_rejected",
                            "fleet submissions refused (no healthy "
                            "replica / fleet queue / every replica "
                            "rejected)")
        # disaggregated-fleet surface
        self.g_prefill = g("router.role_prefill_replicas",
                           "prefill-role replicas in rotation")
        self.g_decode = g("router.role_decode_replicas",
                          "decode-capable (decode/unified) replicas in "
                          "rotation")
        self.g_retired = g("router.retired_replicas",
                           "replicas retired out of the fleet (drained, "
                           "closed, indices kept stable)")
        self.c_handoff_staged = c("handoff.staged",
                                  "KV handoffs opened (prefill-side "
                                  "path pinned)")
        self.c_handoff_committed = c("handoff.committed",
                                     "KV handoffs whose blocks landed "
                                     "on the decode replica")
        self.c_handoff_aborted = c("handoff.aborted",
                                   "KV handoffs aborted (the request "
                                   "re-prefilled on the decode side or "
                                   "failed terminally)")
        self.c_handoff_retries = c("handoff.retries",
                                   "transfer attempts retried after an "
                                   "in-flight fault")
        self.c_handoff_blocks = c("handoff.blocks_moved",
                                  "radix blocks moved prefill -> decode")
        self.c_handoff_failed = c("handoff.failed_terminal",
                                  "requests failed terminally because "
                                  "no decode replica could place the "
                                  "post-handoff submission")
        # crash-consistency surface
        self.g_killed = g("router.killed_replicas",
                          "replicas SIGKILLed out of the fleet "
                          "(no drain, no close)")
        self.c_crash_reattributed = c(
            "router.crash_reattributed",
            "in-flight requests re-attributed through the failover "
            "path after their replica was killed")
        self.c_replay_resubmitted = c(
            "router.replay_resubmitted",
            "journaled non-terminal requests resubmitted by "
            "Router.recover")
        self.c_replay_expired = c(
            "router.replay_expired",
            "journaled requests whose deadline was spent across the "
            "downtime — settled deadline_exceeded without resubmit")
        # tail-latency surface
        self.g_slow = g("router.slow_replicas",
                        "replicas currently marked slow by the "
                        "straggler detector (deprioritized, not "
                        "excluded)")
        self.g_brownout = g("router.brownout_level",
                            "overload-shedding ladder level (0 normal, "
                            "1 shed batch + suspend hedging, 2 "
                            "tightened admission)")
        self.c_hedges = c("router.hedges",
                          "duplicate submissions issued for "
                          "deadline-at-risk requests (one per fleet "
                          "id, ever)")
        self.c_hedge_wins = c("router.hedge_wins",
                              "hedges that finished before their "
                              "primary attempt (the primary was purged)")
        self.c_hedge_failed = c("router.hedges_failed",
                                "hedge submissions that failed closed "
                                "(every target rejected, or the "
                                "hedge_submit chaos point fired)")
        self.c_shed_batch = c("router.shed_batch",
                              "batch-class submissions shed by the "
                              "brownout ladder (rejected with an "
                              "honest retry_after_s)")

    def on_slow(self, phase: str, replica: int, **attrs) -> None:
        """``straggler_*`` lifecycle event on the router lane (mark /
        clear)."""
        self.tracer.event(f"straggler_{phase}", lane=self.lane,
                          replica=replica, **attrs)

    def on_hedge(self, phase: str, fleet_id: int, **attrs) -> None:
        """``hedge_*`` lifecycle event on the router lane (issue / win /
        purge / failed); the matching counters are bumped at the
        transition sites."""
        self.tracer.event(f"hedge_{phase}", lane=self.lane,
                          fleet_id=fleet_id, **attrs)

    def on_brownout(self, phase: str, level: int, **attrs) -> None:
        """``brownout_*`` lifecycle event (enter / exit / shed) plus the
        ladder gauge."""
        self.g_brownout.set(level)
        self.tracer.event(f"brownout_{phase}", lane=self.lane,
                          level=level, **attrs)

    def on_crash(self, phase: str, replica: int, **attrs) -> None:
        """``crash_*`` lifecycle event on the router lane (kill,
        re-attribution, resurrection)."""
        self.tracer.event(f"crash_{phase}", lane=self.lane,
                          replica=replica, **attrs)

    def on_replay(self, phase: str, **attrs) -> None:
        """``replay_*`` lifecycle event on the router lane (begin,
        resubmit, expired, unplaced, done)."""
        self.tracer.event(f"replay_{phase}", lane=self.lane, **attrs)

    def on_handoff(self, phase: str, fleet_id: int, src: int, dst: int,
                   **attrs) -> None:
        """Discrete handoff lifecycle event on the router lane; the
        matching counters are bumped by the router at the transition
        sites."""
        self.tracer.event(f"handoff_{phase}", lane=self.lane,
                          fleet_id=fleet_id, src=src, dst=dst, **attrs)

    def on_route(self, fleet_id: int, replica: int, hit_tokens: int) -> None:
        self.c_routed.inc()
        if hit_tokens > 0:
            self.c_hit_tokens.inc(hit_tokens)

    def on_failover(self, fleet_id: int, src: int, dst: int,
                    reason: str) -> None:
        self.c_failovers.inc()
        self.tracer.event("failover", lane=self.lane, fleet_id=fleet_id,
                          from_replica=src, to_replica=dst,
                          reason=str(reason)[:200])

    def on_failover_exhausted(self, fleet_id: int, replica: int,
                              why: str) -> None:
        self.c_failover_exhausted.inc()
        self.tracer.event("failover_exhausted", lane=self.lane,
                          fleet_id=fleet_id, replica=replica,
                          reason=str(why)[:200])

    def on_reject(self, reason: str) -> None:
        self.c_rejected.inc()
        self.tracer.event("router_reject", lane=self.lane, reason=reason)

    def on_drain(self, replica: int, phase: str) -> None:
        self.tracer.event(phase, lane=self.lane, replica=replica)

    def publish(self, handles: Sequence[ReplicaHandle]) -> None:
        self.g_replicas.set(len(handles))
        live = [h for h in handles if not h.retired]
        healthy = sum(1 for h in live if not h.draining
                      and h.engine.health.routable)
        self.g_healthy.set(healthy)
        self.g_draining.set(sum(1 for h in live if h.draining))
        self.g_queue.set(sum(h.engine.core.scheduler.queue_depth
                             for h in live))
        self.g_prefill.set(sum(1 for h in live if not h.draining
                               and h.role == "prefill"))
        self.g_decode.set(sum(1 for h in live if not h.draining
                              and h.role in ("decode", "unified")))
        self.g_retired.set(sum(1 for h in handles if h.retired))
        self.g_killed.set(sum(1 for h in handles if h.killed))
        self.g_slow.set(sum(1 for h in live if h.engine.health.slow))


class _Brownout:
    """The overload-shedding ladder:
    a host-side hysteretic controller over the fleet queue depth — the
    same signal the SLO rejection reads — escalating one level per
    sustained breach and de-escalating one level per sustained
    recovery (the autoscaler's consecutive-tick idiom):

      * level 0 — normal service;
      * level 1 — shed: new BATCH-class submissions reject with an
        honest ``retry_after_s`` and hedging is suspended (duplicates
        are load an overloaded fleet must not amplify);
      * level 2 — tightened admission: while the queue still exceeds
        the ENTER depth, interactive submissions reject too — honest
        fast failure beats a deadline the fleet already knows it will
        blow.

    Armed only when ``depth`` (the level-1 enter bound; level 2 enters
    at twice it) is given; exit thresholds sit at half the entry
    thresholds so the ladder cannot chatter on a boundary queue."""

    __slots__ = ("depth", "hysteresis", "level", "_above", "_below")

    def __init__(self, depth: Optional[int], hysteresis: int):
        if depth is not None and depth < 1:
            raise ValueError("brownout_depth must be >= 1 (or None)")
        if hysteresis < 1:
            raise ValueError("brownout_hysteresis must be >= 1")
        self.depth = depth
        self.hysteresis = hysteresis
        self.level = 0
        self._above = 0
        self._below = 0

    def _enter_depth(self, level: int) -> int:
        return self.depth * (2 ** (level - 1))

    def update(self, queue_depth: int,
               exit_only: bool = False) -> Optional[str]:
        """One control tick; returns "enter"/"exit" on a level
        transition (None otherwise).  ``exit_only`` marks a
        SUBMIT-time observation: it may walk the ladder DOWN (the
        idle-fleet exit path — rejections enqueue nothing, so step()
        may never run again) but never up, or a burst of submissions
        would escalate faster than the per-step hysteresis the
        thresholds are calibrated for."""
        if self.depth is None:
            return None
        if self.level < 2 and queue_depth >= self._enter_depth(
                self.level + 1):
            if exit_only:
                self._below = 0      # deep queue: no exit progress
                return None
            self._above += 1
            self._below = 0
            if self._above >= self.hysteresis:
                self.level += 1
                self._above = 0
                return "enter"
            return None
        self._above = 0
        if self.level > 0 and queue_depth <= \
                self._enter_depth(self.level) // 2:
            self._below += 1
            if self._below >= self.hysteresis:
                self.level -= 1
                self._below = 0
                return "exit"
        else:
            self._below = 0
        return None


class Router:
    """Prefix-affinity, health-aware request router over N serving
    replicas — the fleet tier.

    ``replicas`` are pre-built :class:`ServingEngine` instances (build
    them onto ONE shared registry/tracer for a single scrape surface —
    :meth:`Router.build` does exactly that).  The router owns the
    fleet-id namespace: every id handed out by :meth:`submit` resolves
    through the authoritative request -> replica map, across failovers.

    ``max_queue`` bounds the FLEET queue (sum of replica queue depths);
    per-replica bounds/SLO checks still apply at each engine.
    ``failover=False`` disables resubmission (replica failures surface
    as terminal ``failed``); ``affinity=False`` degrades routing to
    round-robin over the eligible replicas — the measured baseline the
    prefix-affinity win is pinned against.

    ``roles`` assigns each replica its fleet role (default: the
    engine's own ``role`` attribute, ``unified`` when absent).  A fleet
    holding ``prefill`` replicas is DISAGGREGATED: prompts of at least
    ``prefill_threshold`` tokens (needing more than one output token)
    run their prefill on a prefill replica and migrate to a decode
    replica through the KV handoff (serving/handoff.py); shorter
    prompts route straight to decode/unified replicas.  The threshold
    is REQUIRED when prefill roles are present — every request pays
    the two-phase migration above it, so the split point is a sizing
    decision the operator must make (an explicit 0 routes everything
    through the prefill plane).  ``faults`` arms the router-level
    chaos points (``handoff_*``, ``replica_crash``) — None in
    production.

    **Tail-latency defense**:
    ``slow_threshold``/``slow_hysteresis`` parameterize the straggler
    detector — a replica whose router-measured step-latency EWMA
    exceeds the fleet median by the threshold factor for the
    hysteresis's consecutive fleet steps is marked ``slow``
    (``EngineHealth.slow``) and deprioritized by the route order
    between healthy and degraded; it recovers through the same
    hysteresis.  ``hedging`` (default on) arms hedged requests: a
    deadline-carrying request whose projected completion on its
    current replica breaches the deadline gets ONE duplicate
    submission on the best OTHER healthy replica after a p95-based
    delay — first to finish wins, the loser is purged, and the
    fleet-id idempotency key + delivered high-water mark keep the
    client stream exactly-once and token-identical.  ``brownout_depth``
    arms the overload-shedding ladder (None = off): sustained fleet
    queue depth at the bound sheds BATCH-priority work first (honest
    ``retry_after_s``), suspends hedging, and at twice the bound
    tightens admission for everyone; it exits with hysteresis.

    ``journal`` attaches a durable request :class:`~paddle_tpu_torch.
    serving.journal.Journal`: every accepted
    submit, the per-step delivered high-water marks, and every terminal
    disposition are journaled with FLEET ids, off every engine's hot
    path (``if journal is None`` — the faults pattern, zero overhead
    when unset).  After a process crash, build a fresh fleet on the
    reopened journal and call :meth:`recover` — non-terminal requests
    resubmit and the journaled high-water mark dedups their
    deterministic regeneration, so clients see each recorded token
    position at most once.  Replicas behind a journaled router should
    be built journal-LESS (the router's fleet-id records are the
    authoritative ledger).
    """

    def __init__(self, replicas: Sequence[ServingEngine], *,
                 max_queue: Optional[int] = None,
                 failover: bool = True,
                 affinity: bool = True,
                 roles: Optional[Sequence[str]] = None,
                 prefill_threshold: Optional[int] = None,
                 faults=None,
                 journal=None,
                 hedging: bool = True,
                 slow_threshold: float = 3.0,
                 slow_hysteresis: int = 3,
                 brownout_depth: Optional[int] = None,
                 brownout_hysteresis: int = 4,
                 registry=None, tracer=None):
        if not replicas:
            raise ValueError("Router needs at least one replica engine")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        if slow_threshold <= 1.0:
            raise ValueError(
                "slow_threshold must exceed 1.0 — a replica at the "
                "fleet median must never be an outlier")
        if slow_hysteresis < 1:
            raise ValueError("slow_hysteresis must be >= 1")
        if prefill_threshold is not None and prefill_threshold < 0:
            raise ValueError("prefill_threshold must be >= 0 (or None)")
        if roles is None:
            roles = [getattr(eng, "role", "unified") for eng in replicas]
        if len(roles) != len(replicas):
            raise ValueError(
                f"roles has {len(roles)} entries for {len(replicas)} "
                f"replicas")
        self._handles = [ReplicaHandle(i, eng, role=r)
                         for i, (eng, r) in enumerate(zip(replicas,
                                                          roles))]
        if any(h.role == "prefill" for h in self._handles):
            if not any(h.serves("decode") for h in self._handles):
                raise ValueError(
                    "a disaggregated fleet needs at least one decode "
                    "or unified replica — prefill replicas never "
                    "decode past the first token")
            if prefill_threshold is None:
                raise ValueError(
                    "a fleet with prefill-role replicas requires an "
                    "explicit prefill_threshold (prompt length in "
                    "tokens at which requests take the two-phase "
                    "prefill->handoff path; 0 routes every multi-token "
                    "request through the prefill plane)")
        self.max_queue = max_queue
        self.failover = failover
        self.affinity = affinity
        self.prefill_threshold = prefill_threshold
        self.faults = faults
        self.hedging = hedging
        self.slow_threshold = slow_threshold
        self.slow_hysteresis = slow_hysteresis
        self._brownout = _Brownout(brownout_depth, brownout_hysteresis)
        self.registry = registry if registry is not None \
            else replicas[0].registry
        self.tracer = tracer if tracer is not None \
            else replicas[0].tracer
        self.metrics = _RouterMetrics(self.registry, self.tracer)
        self._handoffs = HandoffManager(faults=faults)
        self._autoscaler = None       # attach via Autoscaler(router, ...)
        self._requests: Dict[int, _FleetRequest] = {}
        self._live: set = set()       # fleet ids the failover scan owns
        self.journal = journal
        if journal is not None:
            journal.bind_metrics(self.registry)
            # the fleet-id namespace must never reuse a journaled id —
            # a reused id would collide two requests in the ledger
            start = max(journal.state) + 1 if journal.state else 0
            self._ids = itertools.count(start)
        else:
            self._ids = itertools.count()
        self._rr = 0                  # round-robin cursor (affinity off)
        self._closed = False
        self.metrics.publish(self._handles)

    @classmethod
    def build(cls, model_factory: Callable, replicas: int = 2, *,
              registry=None, tracer=None, max_queue: Optional[int] = None,
              failover: bool = True, affinity: bool = True,
              roles: Optional[Sequence[str]] = None,
              prefill_threshold: Optional[int] = None,
              faults=None,
              hedging: bool = True,
              slow_threshold: float = 3.0,
              slow_hysteresis: int = 3,
              brownout_depth: Optional[int] = None,
              brownout_hysteresis: int = 4,
              prefill_engine_kw: Optional[dict] = None,
              decode_engine_kw: Optional[dict] = None,
              aot_store=None,
              **engine_kw) -> "Router":
        """Construct ``replicas`` engines onto ONE shared registry and
        tracer (fresh ones when not given) and front them with a router.
        ``model_factory()`` is called once per replica — return the same
        weights (e.g. re-seed inside the factory) when fleet-wide token
        parity matters; ``engine_kw`` is forwarded to every
        :class:`ServingEngine`.  With ``roles`` given, per-role kwargs
        override the shared ones — e.g. ``prefill_engine_kw=dict(
        num_slots=2, max_prefill_tokens_per_step=None)`` for the
        big-bucket prefill shape, ``decode_engine_kw=dict(num_slots=16)``
        for the all-slots decode shape.

        ``aot_store`` is the fleet's shared AOT store (serving/aot.py):
        every replica attaches it, installing the stored kernel libraries
        and capturing every leg's graph at construction.  Per-role kwarg
        overrides that change the engine's fingerprint (slot count,
        sequence length) leave that role to capture at first use —
        loudly, via ``aot_miss`` (``aot_status == "skew"``) — rather than
        refusing to build.

        At tensor-parallel degree 1 the factory may return one model
        for every replica: no engine path writes to the model's
        parameters.  Under ``tensor_parallel > 1`` the first replica
        moves the weights onto its mesh (``serving.tp.
        shard_model_params``); a later replica on the same mesh shares
        that bundle, and one on another mesh or at degree 1 raises,
        naming the cause."""
        from ..obs import MetricsRegistry, Tracer
        registry = registry if registry is not None else MetricsRegistry()
        tracer = tracer if tracer is not None else Tracer()
        role_list = list(roles) if roles is not None \
            else ["unified"] * replicas
        if len(role_list) != replicas:
            raise ValueError(
                f"roles has {len(role_list)} entries for {replicas} "
                f"replicas")
        engines = []
        for r in role_list:
            kw = dict(engine_kw)
            if aot_store is not None:
                kw.setdefault("aot_store", aot_store)
            if r == "prefill" and prefill_engine_kw:
                kw.update(prefill_engine_kw)
            elif r == "decode" and decode_engine_kw:
                kw.update(decode_engine_kw)
            engines.append(ServingEngine(model_factory(),
                                         registry=registry,
                                         tracer=tracer, role=r, **kw))
        return cls(engines, max_queue=max_queue, failover=failover,
                   affinity=affinity, roles=role_list,
                   prefill_threshold=prefill_threshold, faults=faults,
                   hedging=hedging, slow_threshold=slow_threshold,
                   slow_hysteresis=slow_hysteresis,
                   brownout_depth=brownout_depth,
                   brownout_hysteresis=brownout_hysteresis,
                   registry=registry, tracer=tracer)

    # ---------------------------------------------------------- topology
    @property
    def replicas(self) -> Tuple[ReplicaHandle, ...]:
        return tuple(self._handles)

    @property
    def disaggregated(self) -> bool:
        """True once the fleet holds a live prefill-role replica."""
        return any(h.role == "prefill" and not h.retired
                   for h in self._handles)

    @property
    def queue_depth(self) -> int:
        """Fleet-wide waiting requests (the ``max_queue`` bound)."""
        return sum(h.engine.core.scheduler.queue_depth
                   for h in self._handles if not h.retired)

    @property
    def in_flight(self) -> int:
        """Queued + placed requests across the fleet."""
        return sum(h.load for h in self._handles if not h.retired)

    @property
    def routable_count(self) -> int:
        """Replicas that could take new decode-capable work right now
        (role-compatible, in rotation, health routable) — the headline
        number of the fail-fast snapshot ``run_until_complete`` raises
        when the fleet is dead."""
        return len(self._eligible("decode"))

    @property
    def fleet_dead(self) -> bool:
        """True when NO replica can ever make progress again: every
        handle is retired/killed or its circuit is open (a terminal
        state — step() is a no-op there).  Draining and quarantined
        replicas do NOT count as dead: a draining replica still
        finishes its in-flight work and a quarantined one is
        mid-rebuild.  ``run_until_complete`` fails fast on this instead
        of spinning ``stall_steps`` idle iterations into the generic
        no-progress stall."""
        return all(h.retired or h.engine.health.circuit_open
                   for h in self._handles)

    def _handle(self, replica: int) -> ReplicaHandle:
        if not 0 <= replica < len(self._handles):
            raise KeyError(
                f"unknown replica index {replica} — this router fronts "
                f"{len(self._handles)} replicas")
        return self._handles[replica]

    def add_replica(self, engine: ServingEngine,
                    role: str = "decode") -> int:
        """Append one fully-built replica to the rotation (the
        autoscaler's spawn endpoint — the engine must be READY: a
        half-built replica must never reach this call).  Returns its
        replica index; indices are append-only and never reused, so
        the fleet-id map stays stable across topology changes."""
        h = ReplicaHandle(len(self._handles), engine, role=role)
        self._handles.append(h)
        self.metrics.publish(self._handles)
        return h.index

    def retire(self, replica: int) -> None:
        """Permanently remove a DRAINED replica from the fleet: close
        its engine and mark the handle retired (kept in place — indices
        stay stable; completed requests still resolve through it).
        The graceful path is ``drain(i)`` → wait ``drained(i)`` →
        ``retire(i)`` — the autoscaler's scale-down does exactly this.
        Raises when the replica still has work (retiring it would
        strand in-flight requests) or was already retired."""
        h = self._handle(replica)
        if h.retired:
            raise ValueError(f"replica {replica} is already retired")
        if h.engine.core.scheduler.has_work():
            raise ValueError(
                f"replica {replica} still has queued or in-flight work "
                f"— drain it and wait for drained() first")
        h.retired = True
        h.engine.close()
        self.metrics.on_drain(replica, "retire")
        self.metrics.publish(self._handles)

    # ------------------------------------------------------------ crash
    def kill(self, replica: int) -> int:
        """Simulated SIGKILL of one replica: it vanishes from the fleet
        WITHOUT drain or close — no in-flight request finishes, no
        queue drains, no telemetry detaches (a dead process runs no
        cleanup).  Every live fleet request it owned is re-attributed
        on the spot through the existing failover path (same attempts
        budget, same deadline shrinking, same delivered-high-water-mark
        dedup); requests that cannot fail over settle terminally at the
        router.  Pending KV handoffs touching the replica abort (their
        source pins are host objects the manager still holds).  The
        handle stays in place killed+retired — indices stay stable —
        and the autoscaler's resurrection path spawns a replacement
        through its normal warmup gate.  Returns the number of
        re-attributed (resubmitted) requests."""
        h = self._handle(replica)
        if h.retired:
            raise ValueError(
                f"replica {replica} already left the fleet "
                f"(retired/killed) — there is nothing to kill")
        h.killed = True
        h.retired = True            # out of rotation; engine NOT closed
        # a stale direct reference to the dead engine must fail fast,
        # not serve: the health machine pins it terminally dead
        h.engine.health.mark_dead("killed (simulated SIGKILL)")
        self.metrics.on_crash("kill", replica,
                              live_requests=sum(
                                  1 for fid in self._live
                                  if self._requests[fid].replica
                                  == replica))
        # abort handoffs whose source or destination just died — the
        # pin release is a host-side operation on objects the manager
        # holds, so it is safe against the dead engine
        for fid in list(self._handoffs.records):
            rec = self._handoffs.records.get(fid)
            if rec is not None and replica in (rec.src, rec.dst):
                self._handoffs.abort(rec, f"replica {replica} killed "
                                          f"mid-handoff")
                self._abort_metrics(rec)
        reattributed = 0
        for fid in sorted(self._live):
            fr = self._requests[fid]
            if fr.hedge_rid >= 0 and fr.hedge_replica == replica:
                # the hedge died with the replica (dead process —
                # nothing to purge there); the primary stands alone
                self.purge_hedge(fr, f"replica {replica} killed "
                                     f"mid-hedge")
            if fr.replica != replica:
                continue
            if fr.hedge_rid >= 0:
                # the PRIMARY died but its hedge is already running on
                # a live replica: promote the hedge instead of burning
                # a reattribution the attempts budget no longer has
                self.resolve_hedge(fr, f"replica {replica} killed "
                                       f"(simulated SIGKILL) — hedge "
                                       f"survives")
                continue
            if self._reattribute(fr, f"replica {replica} killed "
                                     f"(simulated SIGKILL)"):
                reattributed += 1
        self.metrics.publish(self._handles)
        return reattributed

    def _reattribute(self, fr: _FleetRequest, reason: str) -> bool:
        """Move one fleet request off a DEAD replica: the failover path
        without an engine record to read (the dead replica's state is
        gone by definition).  Returns True when a live replica accepted
        the resubmission; False settles the request terminally at the
        router (deadline spent, attempts exhausted, or no replica
        accepted)."""
        now = time.perf_counter()
        dead = fr.replica

        def settle(status: str, why: str) -> bool:
            self.metrics.on_failover_exhausted(fr.fleet_id, dead, why)
            fr.override = (status, why)
            self._journal_terminal(fr, status, why)
            self._live.discard(fr.fleet_id)
            return False

        if fr.deadline_s is not None \
                and now - fr.submit_time >= fr.deadline_s:
            return settle("deadline_exceeded",
                          f"deadline spent when {reason}")
        if fr.attempts >= 2:
            return settle("failed",
                          f"{reason}; failover budget already spent")
        for h, hit in self._route_order(self._eligible("decode"),
                                        fr.prompt):
            try:
                rid = self._submit_to(h, fr, now=now)
            except RequestRejected:
                continue
            fr.history.append((dead, fr.engine_rid, reason))
            fr.replica, fr.engine_rid = h.index, rid
            fr.role_stage = "decode"
            fr.attempts += 1
            h.routed += 1
            self.metrics.c_crash_reattributed.inc()
            self.metrics.on_failover(fr.fleet_id, dead, h.index, reason)
            return True
        return settle("failed", f"{reason}; no live replica accepted "
                                f"the re-attribution")

    def recover(self, journal=None, *,
                stream_factory: Optional[Callable] = None) -> Dict:
        """Replay a reopened journal into this (fresh) fleet — the
        restart half of crash consistency.  For every journaled submit
        with no terminal record:

          * the deadline budget is re-checked against WALL-CLOCK
            downtime (the submit record carries ``time.time()``); a
            request whose budget was spent while the process was dead
            settles ``deadline_exceeded`` in the journal WITHOUT a
            resubmission;
          * everything else resubmits in full with the remaining
            budget, and the journaled delivered high-water mark seeds
            the exactly-once dedup — the deterministic regeneration
            (same prompt, same seed, same greedy/sampling spec) re-runs
            from position 0 but the client stream only sees positions
            the dead incarnation had not recorded;
          * recovered requests route decode-direct (no prefill-stage
            shortcut — the failover rule: decode/unified replicas
            prefill fine), and a resubmission every replica refuses
            settles terminal ``failed``.

        ``stream_factory(fleet_id)``, when given, builds the client
        stream callback for each recovered request (the old process's
        callbacks died with it).  Returns a summary dict
        (``resubmitted`` / ``expired`` / ``unplaced`` counts).  Must
        run before any new traffic — a recovered fleet id joining a
        half-filled request map would alias."""
        if journal is not None:
            if self.journal is not None and self.journal is not journal:
                raise ValueError(
                    "router already has a different journal attached")
            self.journal = journal
            journal.bind_metrics(self.registry)
        if self.journal is None:
            raise ValueError(
                "recover() needs a journal — attach one at construction "
                "(Router(journal=...)) or pass it here")
        if self._requests:
            raise RuntimeError(
                "recover() must run on a fresh router, before any "
                "submit — recovered fleet ids would alias live ones")
        replayable = self.journal.replay()
        start = max(self.journal.state) + 1 if self.journal.state else 0
        self._ids = itertools.count(start)
        self.metrics.on_replay("begin", requests=len(replayable))
        now_wall = time.time()
        summary = {"resubmitted": 0, "expired": 0, "unplaced": 0}
        for fid in sorted(replayable):
            info = replayable[fid]
            rec, delivered = info["record"], info["delivered"]
            prompt = np.asarray(rec["prompt"], np.int32)
            sampling = None if rec.get("sampling") is None \
                else SamplingParams(**rec["sampling"])
            fr = _FleetRequest(fid, prompt, rec["max_new_tokens"],
                               sampling, rec.get("eos_token_id"),
                               None if stream_factory is None
                               else stream_factory(fid),
                               rec.get("deadline_s"),
                               rec.get("ttft_deadline_s"),
                               priority=rec.get("priority",
                                                "interactive"))
            fr.journaled_submit = True     # this IS the journaled submit
            fr.delivered = fr.journal_hwm = delivered
            fr.plan_start = info.get("plan_start")
            fr.journaled_plan = fr.plan_start is not None
            fr.submit_time = time.perf_counter()
            # charge the downtime against the budgets: elapsed wall
            # clock since the original submission, deadlines relative
            elapsed = max(now_wall - rec.get("wall_time", now_wall), 0.0)
            expired = None
            if fr.deadline_s is not None:
                fr.deadline_s -= elapsed
                if fr.deadline_s <= 0:
                    expired = (f"end-to-end deadline "
                               f"{rec['deadline_s']}s spent across "
                               f"{elapsed:.3f}s including downtime")
            if fr.ttft_deadline_s is not None:
                if delivered > 0:
                    fr.ttft_deadline_s = None    # TTFT already met
                else:
                    fr.ttft_deadline_s -= elapsed
                    if expired is None and fr.ttft_deadline_s <= 0:
                        expired = (f"TTFT deadline "
                                   f"{rec['ttft_deadline_s']}s spent "
                                   f"across {elapsed:.3f}s including "
                                   f"downtime")
            if expired is not None:
                fr.override = ("deadline_exceeded", expired)
                self._journal_terminal(fr, *fr.override)
                self._requests[fid] = fr
                self.metrics.c_replay_expired.inc()
                self.metrics.on_replay("expired", fleet_id=fid,
                                       downtime_s=round(elapsed, 3))
                summary["expired"] += 1
                continue
            placed = False
            for h, hit in self._route_order(self._eligible("decode"),
                                            prompt):
                try:
                    rid = self._submit_to(h, fr)
                except RequestRejected:
                    continue
                self._place(fr, h, rid, hit)
                placed = True
                break
            if placed:
                self.metrics.c_replay_resubmitted.inc()
                self.metrics.on_replay("resubmit", fleet_id=fid,
                                       replica=fr.replica,
                                       delivered=delivered)
                summary["resubmitted"] += 1
            else:
                fr.override = ("failed", "no replica accepted the "
                                         "recovered resubmission")
                self._journal_terminal(fr, *fr.override)
                self._requests[fid] = fr
                self.metrics.on_replay("unplaced", fleet_id=fid)
                summary["unplaced"] += 1
        self.metrics.on_replay("done", **summary)
        return summary

    def attach_autoscaler(self, autoscaler) -> None:
        """Register the autoscaler ``step()`` ticks (one per fleet
        step).  Called by ``Autoscaler.__init__``."""
        self._autoscaler = autoscaler

    @property
    def autoscaler(self):
        return self._autoscaler

    def _eligible(self, stage: str = "decode") -> List[ReplicaHandle]:
        """Replicas new ``stage`` work may be routed to: role-compatible,
        not draining/retired, not quarantined, circuit not open
        (degraded stays eligible — it is deprioritized by the route
        order, not excluded)."""
        return [h for h in self._handles
                if h.serves(stage)
                and not h.draining and not h.retired
                and h.engine.health.routable]

    def _route_order(self, eligible: List[ReplicaHandle],
                     prompt: np.ndarray
                     ) -> List[Tuple[ReplicaHandle, Optional[int]]]:
        """The replica try-order for one prompt, best first, with each
        candidate's probed prefix-hit length.  Affinity mode: longest
        cached prefix wins within each health band — healthy beats
        SLOW (the straggler detector's deprioritization) beats
        degraded beats slow+degraded — and load breaks ties.
        Round-robin mode: rotate the cursor without probing anyone
        (hit = None; the caller probes only the ACCEPTED replica so
        ``router.prefix_hit_tokens`` stays comparable between the two
        policies without N radix walks per submit)."""
        if not eligible:
            # hedge/failover scans legitimately produce an empty
            # candidate list (the only other replica is draining or
            # quarantined) — that must mean "no order", never a
            # modulo-by-zero out of the round-robin cursor
            return []
        if not self.affinity:
            k = self._rr % len(eligible)
            self._rr += 1
            rotated = eligible[k:] + eligible[:k]
            return [(h, None) for h in rotated]
        probes = [(h, h.engine.core.prefix_probe(prompt))
                  for h in eligible]
        return sorted(
            probes,
            key=lambda p: (p[0].health_rank, -p[1], p[0].load,
                           p[0].index))

    # -------------------------------------------------------- submission
    def submit(self, prompt, max_new_tokens: int = 16,
               sampling: Optional[SamplingParams] = None,
               eos_token_id: Optional[int] = None,
               stream: Optional[Callable] = None,
               deadline_s: Optional[float] = None,
               ttft_deadline_s: Optional[float] = None,
               priority: str = "interactive") -> int:
        """Route one request; returns its FLEET id (valid with
        :meth:`result`/:meth:`cancel`/:meth:`stream`/:meth:`purge` on
        this router — engine-local ids never leak to clients).

        Raises :class:`RequestRejected` when no replica can take the
        request: ``no_healthy_replica`` (every decode-capable replica
        excluded by health or drain — a disaggregated fleet always
        needs decode capacity), ``fleet_queue_full`` (the fleet-wide
        ``max_queue`` bound), or the best replica's own rejection
        (``queue_full`` / ``slo_unattainable`` / ``circuit_open``) when
        every eligible replica refused — always carrying the best
        available ``retry_after_s`` hint.  Validation ``ValueError``\\ s
        (empty prompt, prompt+new > max_seq, bad sampling) propagate
        from the first replica tried, before any state is recorded.

        In a disaggregated fleet a long prompt is submitted to a
        PREFILL replica capped at one token; the KV handoff + decode
        resubmission happen transparently inside later :meth:`step`\\ s.
        When every prefill replica refuses, the request falls back to
        the decode-direct path rather than rejecting.

        ``priority`` ("interactive" — the default — or "batch") is the
        request's class: batch work is deferrable inside each engine's
        admission window and is the FIRST thing the brownout ladder
        sheds (``brownout_shed_batch``, with an honest retry hint)
        under sustained overload; at ladder level 2 interactive
        submissions shed too while the queue stays over the bound
        (``brownout_overload``)."""
        if priority not in PRIORITIES:
            raise ValueError(
                f"priority must be one of {PRIORITIES}, got {priority!r}")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        fleet_id = next(self._ids)
        eligible = self._eligible("decode")
        if not eligible:
            # hint only from replicas that can plausibly recover — a
            # circuit-open replica never will (engine.check_admission
            # hints None for the same reason), so an all-circuit-open
            # fleet correctly reports "no hint" instead of telling
            # clients to retry against the dead replicas' stale history
            self._reject(fleet_id, prompt, "no_healthy_replica",
                         self._best_hint(
                             [h for h in self._handles
                              if h.serves("decode") and not h.retired
                              and h.engine.health.state != CIRCUIT_OPEN]))
        # the brownout ladder: shed
        # batch first, then — at level 2, while the queue still sits
        # over the ENTER bound — everyone, always with the honest
        # live-metrics retry hint.  While browned out, every submit is
        # ALSO a control observation — EXIT-only: an idle fleet whose
        # work drained before the exit hysteresis completed would
        # otherwise shed batch forever (rejections enqueue nothing, so
        # step() — the normal tick site — never runs again), while
        # escalation stays a per-step judgement
        if self._brownout.level > 0:
            self._brownout_tick(exit_only=True)
        if self._brownout.level >= 1 and priority == "batch":
            self.metrics.c_shed_batch.inc()
            self.metrics.on_brownout("shed", self._brownout.level,
                                     fleet_id=fleet_id)
            self._reject(fleet_id, prompt, "brownout_shed_batch",
                         self._best_hint(eligible))
        if self._brownout.level >= 2 \
                and self.queue_depth >= self._brownout.depth:
            self._reject(fleet_id, prompt, "brownout_overload",
                         self._best_hint(eligible))
        if self.max_queue is not None \
                and self.queue_depth >= self.max_queue:
            self._reject(fleet_id, prompt, "fleet_queue_full",
                         self._best_hint(eligible))
        fr = _FleetRequest(fleet_id, prompt, max_new_tokens, sampling,
                           eos_token_id, stream, deadline_s,
                           ttft_deadline_s, priority=priority)
        fr.submit_time = time.perf_counter()
        rejections: List[Tuple[int, RequestRejected]] = []
        # disaggregated two-phase path: long prompts needing >1 output
        # token try the prefill plane first (prefix affinity among the
        # prefill replicas); the decode-direct order is the fallback
        prefill_order: List[Tuple[ReplicaHandle, Optional[int]]] = []
        if self.prefill_threshold is not None and max_new_tokens > 1 \
                and prompt.size >= self.prefill_threshold:
            pre = self._eligible("prefill")
            if pre:
                # the decode phase must eventually fit somewhere: a
                # request that can never be placed on ANY decode-capable
                # replica is a caller bug, surfaced loudly here instead
                # of as a mid-handoff failure.  Capacity is a FLEET
                # property — measured over every decode-capable replica
                # (health is transient; a quarantined big replica comes
                # back with the same max_seq), not just the currently
                # eligible ones
                fleet_max_seq = max(
                    h.engine.core.pool.max_seq for h in self._handles
                    if h.serves("decode") and not h.retired)
                if prompt.size + max_new_tokens > fleet_max_seq:
                    raise ValueError(
                        f"prompt_len {prompt.size} + max_new_tokens "
                        f"{max_new_tokens} exceeds every decode "
                        f"replica's max_seq — the post-handoff "
                        f"submission could never be placed")
                prefill_order = self._route_order(pre, prompt)
        for h, hit in prefill_order:
            try:
                rid = self._submit_to(h, fr, max_new=1)
            except RequestRejected as e:
                rejections.append((h.index, e))
                continue
            fr.role_stage = "prefill"
            return self._place(fr, h, rid, hit)
        for h, hit in self._route_order(eligible, prompt):
            try:
                rid = self._submit_to(h, fr)
            except RequestRejected as e:
                rejections.append((h.index, e))
                continue
            return self._place(fr, h, rid, hit)
        # every eligible replica rejected: surface the BEST replica's
        # reason with the best (smallest, still-finite) retry hint,
        # carrying EVERY replica's own rejection for debuggability
        hints = [e.retry_after_s for _, e in rejections
                 if e.retry_after_s is not None]
        per_replica = [{"replica": i, "reason": e.reason,
                        "retry_after_s": e.retry_after_s}
                       for i, e in rejections]
        self._reject(fleet_id, prompt, rejections[0][1].reason,
                     min(hints) if hints else None,
                     per_replica=per_replica)

    def _place(self, fr: _FleetRequest, h: ReplicaHandle,
               rid: int, hit: Optional[int]) -> int:
        """Record a freshly accepted fleet submission's ownership."""
        fr.replica, fr.engine_rid = h.index, rid
        fr.attempts = 1
        h.routed += 1
        self._requests[fr.fleet_id] = fr
        self._live.add(fr.fleet_id)
        if self.journal is not None and not fr.journaled_submit:
            # once per fleet id, EVER: a recovered request was already
            # journaled by its first incarnation (recover() pre-sets
            # the flag), and failovers re-place without re-journaling
            fr.journaled_submit = True
            self.journal.append_submit(
                fr.fleet_id, fr.prompt, fr.max_new_tokens,
                sampling=None if fr.sampling is None
                else dataclasses.asdict(fr.sampling),
                eos_token_id=fr.eos_token_id,
                deadline_s=fr.deadline_s,
                ttft_deadline_s=fr.ttft_deadline_s,
                priority=fr.priority)
        if hit is None:             # round-robin: probe the winner only
            hit = h.engine.core.prefix_probe(fr.prompt)
        self.metrics.on_route(fr.fleet_id, h.index, hit)
        return fr.fleet_id

    def _journal_terminal(self, fr: _FleetRequest, status: str,
                          reason) -> None:
        """Write one fleet request's terminal record — exactly once per
        fleet id across every settle site (scan, cancel, purge, kill,
        handoff exhaustion, recovery expiry)."""
        if self.journal is None or fr.journaled_terminal \
                or not fr.journaled_submit:
            return
        fr.journaled_terminal = True
        self.journal.append_terminal(fr.fleet_id, status,
                                     reason or status,
                                     delivered=fr.delivered)

    def _journal_progress(self) -> None:
        """Batch this step's delivered high-water marks into ONE journal
        record (host ints the dedup wrapper already tracks)."""
        updates, starts = {}, {}
        for fid in self._live:
            fr = self._requests[fid]
            if fr.delivered > fr.journal_hwm:
                updates[fid] = fr.journal_hwm = fr.delivered
                if fr.plan_start is not None and not fr.journaled_plan:
                    starts[fid] = fr.plan_start
                    fr.journaled_plan = True
        self.journal.append_progress(updates, plan_starts=starts)

    def _reject(self, fleet_id: int, prompt: np.ndarray, reason: str,
                retry_after_s: Optional[float],
                per_replica: Optional[List[Dict[str, object]]] = None):
        self.metrics.on_reject(reason)
        status_reason = reason
        if per_replica:
            # the output's terminal record names every replica's own
            # refusal, not just the winning reason — the multi-replica
            # rejection path's debuggability contract
            detail = "; ".join(
                f"replica {d['replica']}: {d['reason']}"
                for d in per_replica)
            status_reason = f"{reason} [{detail}]"
        out = RequestOutput(
            request_id=fleet_id, prompt=prompt, tokens=[], finished=True,
            finish_reason=None, ttft_s=None, status="rejected",
            status_reason=status_reason)
        raise RequestRejected(reason, retry_after_s, output=out,
                              per_replica=per_replica)

    def _best_hint(self, handles: Sequence[ReplicaHandle]
                   ) -> Optional[float]:
        hints = [h.engine.metrics.retry_after_hint() for h in handles]
        hints = [x for x in hints if x is not None]
        return min(hints) if hints else None

    def _submit_to(self, h: ReplicaHandle, fr: _FleetRequest,
                   now: Optional[float] = None,
                   max_new: Optional[int] = None,
                   regenerate: bool = True) -> int:
        """Submit (or RE-submit, on failover/handoff) one fleet request
        to a replica, with the deadline budgets shrunk by the time
        already spent — a failover must not silently grant a fresh
        deadline.  A request whose first token was already delivered
        carries no TTFT deadline into the retry (the client's TTFT was
        met).  ``max_new`` overrides the client's budget — the
        prefill-stage submission caps at ONE token (the TTFT token; the
        decode phase regenerates it deduped and continues).

        A regeneration (failover, hedge, recovery) carries the first
        attempt's plan start: the target runs the rows from it in that
        attempt's chunks, whatever its own radix cache holds, so a 16-bit
        prefill regenerates the delivered tokens and the dedup mark never
        splices two continuations.  The handoff's decode submission passes
        ``regenerate=False``: its export rule already reruns the prefill's
        last chunk at the same offset and width."""
        if now is None:
            now = time.perf_counter()
        elapsed = max(now - fr.submit_time, 0.0)
        deadline = fr.deadline_s
        if deadline is not None:
            deadline = max(deadline - elapsed, 0.0)
        ttft = fr.ttft_deadline_s
        if ttft is not None:
            ttft = None if fr.delivered > 0 \
                else max(ttft - elapsed, 0.0)
        return h.engine.submit(
            fr.prompt,
            max_new_tokens=fr.max_new_tokens if max_new is None
            else max_new,
            sampling=fr.sampling, eos_token_id=fr.eos_token_id,
            stream=self._fleet_stream(fr),
            deadline_s=deadline, ttft_deadline_s=ttft,
            priority=fr.priority,
            plan_start=fr.plan_start if regenerate else None)

    def _fleet_stream(self, fr: _FleetRequest) -> Callable:
        """The exactly-once dedup wrapper: every replica attempt streams
        through it; positions below the delivered high-water mark (a
        failover retry regenerating the prefix it already served) are
        swallowed, so the client sees each token position once."""
        def cb(req, tok):
            pos = len(req.tokens) - 1   # _emit appends before calling
            if fr.plan_start is None:
                fr.plan_start = req.prefix_hit_tokens
            if pos < fr.delivered:
                return
            fr.delivered = pos + 1
            if fr.client_stream is not None:
                fr.client_stream(req, tok)
        return cb

    # --------------------------------------------------------- execution
    def step(self) -> int:
        """One fleet iteration: step every live replica (timed — the
        straggler detector's input), run the failover + hedge scans
        over live requests, pump pending KV handoffs, tick the
        brownout ladder, journal this step's delivered high-water
        marks, tick the autoscaler (when attached) and refresh the
        fleet gauges.  Returns the number of requests still in flight
        fleet-wide."""
        slow_victim, slow_armed = -1, None
        if self.faults is not None:
            # the replica_crash chaos point: SIGKILL the lowest-index
            # live replica (deterministic for a deterministic workload
            # — the chaos suite's replay-parity invariant needs the
            # same arming to kill the same replica every run)
            armed = self.faults.check("replica_crash")
            if armed is not None:
                for h in self._handles:
                    if not h.retired:
                        self.kill(h.index)
                        break
            # the replica_slow chaos point: straggle the lowest-index
            # live replica at the ROUTER (a sleep inside its timed
            # step window — engine internals untouched), deterministic
            # for the same reason as replica_crash
            slow_armed = self.faults.check("replica_slow")
            if slow_armed is not None:
                for h in self._handles:
                    if not h.retired:
                        slow_victim = h.index
                        break
        for h in self._handles:
            if h.retired:
                continue
            # latency is observed only on steps that SERVED something:
            # an idle replica's near-zero step time is not a health
            # baseline, and feeding it in would make any busy peer —
            # i.e. exactly the replica affinity concentrates load on —
            # look like an outlier
            busy = h.engine.core.scheduler.has_work()
            h._observed = busy
            t0 = time.perf_counter()
            if h.index == slow_victim and busy:
                # straggle only SERVING steps: an idle victim's sleep
                # is never observed into the EWMA (the busy gate
                # below), so it would burn wall clock for zero
                # detection value through every drain tail
                time.sleep(slow_armed.seconds)
            h.engine.step()
            if busy:
                h.observe_step(time.perf_counter() - t0)
        self._detect_stragglers()
        self._scan_failover()
        self._scan_hedges()
        self._pump_handoffs()
        self._brownout_tick()
        if self.journal is not None:
            self._journal_progress()
        if self._autoscaler is not None:
            self._autoscaler.tick()
        self.metrics.publish(self._handles)
        return self.in_flight

    @property
    def brownout_level(self) -> int:
        """The overload-shedding ladder's current level (0 = normal)."""
        return self._brownout.level

    def _brownout_tick(self, exit_only: bool = False) -> None:
        """One brownout control observation of the live queue depth,
        with the transition telemetry."""
        transition = self._brownout.update(self.queue_depth,
                                           exit_only=exit_only)
        if transition is not None:
            self.metrics.on_brownout(transition, self._brownout.level,
                                     queue_depth=self.queue_depth)

    # ------------------------------------------------------- stragglers
    def _detect_stragglers(self) -> None:
        """The fleet-relative outlier rule: a replica whose step-latency
        EWMA exceeds its PEERS' median by ``slow_threshold`` for
        ``slow_hysteresis`` consecutive fleet steps is marked slow; it clears
        through the same hysteresis.  The median excludes the replica under
        test — in a small fleet a straggler drags a self-inclusive median up
        toward its own latency and can mask itself (at n=2 a 2x threshold could
        NEVER fire).  Needs at least two live replicas — "slow" is a relative
        judgement, and a fleet of one has no peer to be slower than."""
        live = [h for h in self._handles
                if not h.retired and h.step_ewma_s > 0.0]
        if len(live) < 2:
            # no peer, no relative judgement — and a STANDING mark must
            # not freeze into stale evidence (a slow_ticks count the
            # autoscaler would act on) when the fleet shrinks around
            # it: clear it and let a future peer comparison re-earn it
            # through the normal hysteresis
            for h in self._handles:
                if not h.retired and h.engine.health.slow:
                    h.engine.health.clear_slow()
                    h.slow_ticks = 0
                    h._slow_streak = h._fast_streak = 0
                    self.metrics.on_slow("clear", h.index,
                                         reason="no live peer to "
                                                "compare against")
            return
        for h in live:
            health = h.engine.health
            if not h._observed:
                # no busy step this round: the frozen EWMA proves
                # nothing either way — streaks and slow_ticks hold (an
                # idle deprioritized replica must neither clear its
                # mark on stale data nor accrue replacement pressure
                # while it serves nothing)
                continue
            median = float(np.median([p.step_ewma_s for p in live
                                      if p is not h]))
            if median <= 0.0:
                continue
            bar = median * self.slow_threshold
            if h.step_ewma_s > bar:
                h._fast_streak = 0
                h._slow_streak += 1
                if not health.slow \
                        and h._slow_streak >= self.slow_hysteresis:
                    health.mark_slow(
                        f"step EWMA {h.step_ewma_s:.4f}s > "
                        f"{self.slow_threshold:g}x fleet median "
                        f"{median:.4f}s for {h._slow_streak} steps")
                    self.metrics.on_slow(
                        "mark", h.index,
                        ewma_s=round(h.step_ewma_s, 4),
                        fleet_median_s=round(median, 4))
            else:
                h._slow_streak = 0
                h._fast_streak += 1
                if health.slow \
                        and h._fast_streak >= self.slow_hysteresis:
                    health.clear_slow()
                    h.slow_ticks = 0
                    self.metrics.on_slow(
                        "clear", h.index,
                        ewma_s=round(h.step_ewma_s, 4),
                        fleet_median_s=round(median, 4))
            h.slow_ticks = h.slow_ticks + 1 if health.slow else 0

    def has_work(self) -> bool:
        return (any(h.engine.core.scheduler.has_work()
                    for h in self._handles if not h.retired)
                or self._handoffs.pending > 0)

    def _progress(self) -> int:
        return (sum(h.engine.core.progress_counter
                    for h in self._handles)
                + self.metrics.c_failovers.value
                + self.metrics.c_failover_exhausted.value
                # every handoff transition is fleet progress — a staged
                # transfer waiting for a slot must not trip the stall
                # detector while it is still advancing
                + self._handoffs.staged + self._handoffs.committed
                + self._handoffs.aborted + self._handoffs.retries
                # every hedge transition (issue, win, failed issue) is
                # fleet progress — a hedge race mid-flight must not
                # trip the stall detector while it is still advancing
                + self.metrics.c_hedges.value
                + self.metrics.c_hedge_wins.value
                + self.metrics.c_hedge_failed.value)

    def run_until_complete(self, max_steps: Optional[int] = None,
                           stall_steps: Optional[int] = 64) -> int:
        """Step until every replica drains; returns steps taken.  The
        stall detector watches FLEET progress (token emits, admissions,
        dispositions, failovers) so a wedged replica raises
        :class:`EngineStalledError` with a per-replica snapshot instead
        of spinning."""
        steps = stalled = 0
        last = self._progress()
        while self.has_work():
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"fleet did not drain within {max_steps} steps")
            if stall_steps is not None and self.fleet_dead:
                # every replica killed/retired/circuit-open with work
                # still outstanding: no number of idle steps can drain
                # it — fail fast with the descriptive snapshot
                # (routable count, journal position) instead of
                # spinning to the generic no-progress stall
                raise EngineStalledError(0, self.stall_snapshot())
            self.step()
            steps += 1
            p = self._progress()
            if p != last:
                last, stalled = p, 0
            else:
                stalled += 1
                if stall_steps is not None and stalled >= stall_steps \
                        and self.has_work():
                    raise EngineStalledError(stalled,
                                             self.stall_snapshot())
        return steps

    def stream(self, fleet_id: int) -> Iterator[int]:
        """Yield the request's tokens as they are generated, stepping
        the FLEET while waiting — so health scans and failovers keep
        running; the iterator transparently follows the request onto a
        failover target (the dedup wrapper guarantees each yielded
        position was generated for this client exactly once)."""
        fr = self._record(fleet_id)
        seen = 0
        while True:
            req = self._handles[fr.replica].engine._requests.get(
                fr.engine_rid)
            toks = req.tokens if req is not None else []
            while seen < len(toks):
                yield toks[seen]
                seen += 1
            if fleet_id not in self._live:
                return
            self.step()

    # ----------------------------------------------------------- hedging
    def _hedge_delay_s(self) -> float:
        """The p95-based hedge delay: a request is never duplicated
        before it has been given the fleet's p95 TTFT to show progress
        (the Tail-at-Scale rule — hedge the outliers, not the median).
        0.0 with no history: a cold fleet hedges on projection alone."""
        hist = self.registry.get("serving.ttft_s")
        if hist is None:
            return 0.0
        q = hist.quantile(0.95)
        return float(q) if q is not None else 0.0

    def _projected_completion_s(self, fr: _FleetRequest,
                                h: ReplicaHandle, req,
                                now: float) -> Optional[float]:
        """Projected submit→finish seconds for ``fr`` on its CURRENT
        replica: time already spent, plus the live per-replica step
        latency (the straggler detector's EWMA — one decode position
        per step) times the positions left, plus the queue ahead while
        the request has not been admitted.  None without latency
        history — a projection invented from zero data must not issue
        hedges."""
        ewma = h.step_ewma_s
        if ewma <= 0.0:
            return None
        elapsed = now - fr.submit_time
        done = 0 if req is None else len(req.tokens)
        remaining = max(fr.max_new_tokens - done, 0)
        queued_s = 0.0
        if req is not None and not req.finished \
                and req.admit_time is None:
            # still waiting for a slot: the position term is the
            # replica's own live TTFT projection (queue drain at its
            # measured completion rate — the same estimate SLO
            # rejection uses), falling back to one step per queued
            # request on a history-less replica
            depth = h.engine.core.scheduler.queue_depth
            est = h.engine.metrics.projected_ttft_s(depth)
            queued_s = est if est is not None else depth * ewma
        return elapsed + remaining * ewma + queued_s

    def _scan_hedges(self) -> None:
        """Issue hedges for deadline-at-risk requests.  Runs after the failover
        scan each fleet step; suspended entirely under brownout —
        duplicate work is load an overloaded fleet must not amplify."""
        if not self.hedging or self._brownout.level >= 1 \
                or not self._live:
            return
        now = time.perf_counter()
        delay = None                     # computed lazily, once per scan
        for fid in list(self._live):
            fr = self._requests[fid]
            if (fr.hedged or fr.attempts >= 2
                    or fr.deadline_s is None
                    or fr.role_stage != "decode"):
                continue
            h = self._handles[fr.replica]
            req = h.engine._requests.get(fr.engine_rid)
            if req is None or req.finished:
                continue
            if delay is None:
                delay = self._hedge_delay_s()
            # the delay is additionally bounded by a quarter of the
            # request's own deadline: waiting the fleet p95 before
            # hedging a SHORT-deadline request would spend the budget
            # the hedge exists to protect
            if now - fr.submit_time < min(delay, 0.25 * fr.deadline_s):
                continue
            proj = self._projected_completion_s(fr, h, req, now)
            if proj is None or proj <= fr.deadline_s:
                continue
            self.issue_hedge(fr, now=now, projected_s=proj)

    def issue_hedge(self, fr: _FleetRequest, now: Optional[float] = None,
                    projected_s: Optional[float] = None) -> bool:
        """Issue THE duplicate submission for a deadline-at-risk fleet
        request onto the best OTHER healthy replica — the failover shape
        applied preemptively: same fleet-id idempotency key, same
        delivered-high-water-mark dedup (both attempts stream through the one
        wrapper, so the client sees each token position exactly once), same
        attempts ≤ 2 budget and deadline shrinking as ``_reattribute``.  One
        hedge per fleet id, EVER — issuing (even a failed issue: the
        opportunity is spent) sets ``fr.hedged``; only a fleet state with NO
        candidate target at all (the sole peer draining/quarantined) is a no-op
        the scan may retry. Balance with :meth:`resolve_hedge` (the hedge won
        the race) or :meth:`purge_hedge` (the hedge lost and unwinds).  Returns
        True when a replica accepted the duplicate; a False (every target
        rejected, or the ``hedge_submit`` chaos point fired) fails CLOSED — the
        primary attempt is untouched."""
        if fr.hedged or fr.attempts >= 2:
            return False
        if now is None:
            now = time.perf_counter()
        targets = [h for h in self._eligible("decode")
                   if h.index != fr.replica]
        if not targets:
            # nowhere to hedge RIGHT NOW (the only peer is draining or
            # quarantined): a no-op, not a spent opportunity — the
            # scan retries once a peer recovers, deadline permitting
            return False
        fr.hedged = True
        if self.faults is not None:
            armed = self.faults.check("hedge_submit")
            if armed is not None:
                # injected submission fault: the duplicate dies before
                # landing anywhere — nothing to unwind, primary stands
                self.metrics.c_hedge_failed.inc()
                self.metrics.on_hedge(
                    "failed", fr.fleet_id,
                    reason="injected fault at hedge_submit")
                return False
        for h, hit in self._route_order(targets, fr.prompt):
            try:
                rid = self._submit_to(h, fr, now=now)
            except (RequestRejected, ValueError):
                # ValueError: a heterogeneous fleet — this target's
                # max_seq cannot hold the request the primary's could.
                # A hedge runs inside the step loop, so validation
                # refusals mean "next target", never a raise that
                # would strand the whole fleet mid-serve
                continue
            fr.hedge_replica, fr.hedge_rid = h.index, rid
            fr.attempts += 1
            h.routed += 1
            self.metrics.c_hedges.inc()
            self.metrics.on_hedge(
                "issue", fr.fleet_id, primary=fr.replica,
                target=h.index, deadline_s=fr.deadline_s,
                projected_s=None if projected_s is None
                else round(projected_s, 4))
            return True
        self.metrics.c_hedge_failed.inc()
        self.metrics.on_hedge("failed", fr.fleet_id,
                              reason="every eligible replica rejected "
                                     "the duplicate")
        return False

    def resolve_hedge(self, fr: _FleetRequest, reason: str) -> None:
        """The hedge won the race (it finished first, or the primary
        died under it): promote it to the authoritative attempt and
        purge the surrendered primary's engine record — the loser's
        slot, staging rows and radix pins release through the normal
        cancel-on-purge unwind (a KILLED primary's dead engine is left
        alone; its state is unreadable by definition).  A no-op when no
        hedge is live — resolving twice must never repoint the request
        at the -1 sentinel (which would negative-index into the LAST
        replica's handle)."""
        if fr.hedge_rid < 0:
            return
        src, src_rid = fr.replica, fr.engine_rid
        fr.history.append((src, src_rid, reason))
        src_h = self._handles[src]
        if not src_h.killed and src_rid in src_h.engine._requests:
            src_h.engine.purge(src_rid)
        fr.replica, fr.engine_rid = fr.hedge_replica, fr.hedge_rid
        fr.hedge_replica = fr.hedge_rid = -1
        self.metrics.c_hedge_wins.inc()
        self.metrics.on_hedge("win", fr.fleet_id, winner=fr.replica,
                              loser=src, reason=str(reason)[:200])

    def purge_hedge(self, fr: _FleetRequest, reason: str) -> None:
        """The hedge lost the race (the primary finished first, or the
        client settled the request, or the hedge's replica died): unwind
        the duplicate completely — its engine record is purged (cancel-
        on-purge returns the slot and every pin), so the loser leaves
        ZERO state behind on its replica.  Idempotent once the hedge is
        resolved."""
        if fr.hedge_rid < 0:
            return
        h = self._handles[fr.hedge_replica]
        if not h.killed and fr.hedge_rid in h.engine._requests:
            h.engine.purge(fr.hedge_rid)
        self.metrics.on_hedge("purge", fr.fleet_id,
                              replica=fr.hedge_replica,
                              reason=str(reason)[:200])
        fr.hedge_replica = fr.hedge_rid = -1

    def _settle_hedge_race(self, fr: _FleetRequest) -> None:
        """One scan pass over a LIVE hedge race: the first attempt to
        reach ``finished`` wins and the loser is purged; an attempt
        that dies (failed / deadline) while its peer still runs
        surrenders to the peer; both terminal keeps the primary's
        record standing and unwinds the hedge."""
        pri = self._handles[fr.replica].engine._requests.get(
            fr.engine_rid)
        hed = self._handles[fr.hedge_replica].engine._requests.get(
            fr.hedge_rid)
        if hed is None:
            # the hedge record vanished underneath us (its replica was
            # retired mid-race) — the primary stands alone
            fr.hedge_replica = fr.hedge_rid = -1
            return
        if pri is None:
            self.resolve_hedge(fr, "primary record lost")
            return
        if pri.finished and pri.status == "finished":
            self.purge_hedge(fr, "primary finished first")
        elif hed.finished and hed.status == "finished":
            self.resolve_hedge(fr, "hedge finished first")
        elif pri.finished and hed.finished:
            self.purge_hedge(fr, f"both attempts terminal "
                                 f"({pri.status} / {hed.status})")
        elif pri.finished:
            self.resolve_hedge(fr, f"primary {pri.status}: "
                                   f"{pri.status_reason}")
        elif hed.finished:
            self.purge_hedge(fr, f"hedge {hed.status}: "
                                 f"{hed.status_reason}")

    # ---------------------------------------------------------- failover
    def _scan_failover(self) -> None:
        """Settle finished fleet requests; resubmit replica-attributed
        failures ONCE to the best healthy replica; open KV handoffs for
        prefill-stage requests whose prefill completed.  Runs after
        every fleet step, off any engine's hot path."""
        if not self._live:
            return
        for fid in list(self._live):
            fr = self._requests[fid]
            if fr.hedge_rid >= 0:
                # a live hedge race settles BEFORE the terminal scan:
                # first finished wins, the loser is purged, and fr
                # points at the winner below
                self._settle_hedge_race(fr)
            # the engine-internal record is authoritative and cheap;
            # result() would build a RequestOutput copy per scan
            req = self._handles[fr.replica].engine._requests.get(
                fr.engine_rid)
            if req is None or not req.finished:
                continue
            if fr.role_stage == "prefill" and req.status == "finished":
                # the one-token prefill run completed.  A first token
                # that already ended the request (eos, or a one-token
                # budget that took the decode-direct guard's gap) is
                # genuinely done; otherwise open the KV handoff and
                # keep the fleet id live until the decode phase owns it
                if req.finish_reason == "eos" or fr.max_new_tokens <= 1:
                    self._journal_terminal(fr, req.status,
                                           req.status_reason)
                    self._live.discard(fid)
                    continue
                if fid not in self._handoffs.records:
                    self._stage_handoff(fr)
                continue
            if (self.failover and req.status == "failed"
                    and fr.attempts < 2
                    and not str(req.status_reason or "").startswith(
                        _CLIENT_FAULT_PREFIX)):
                if self._try_failover(fr, req):
                    continue        # re-owned: stays live on the target
            self._journal_terminal(fr, req.status, req.status_reason)
            self._live.discard(fid)

    def _try_failover(self, fr: _FleetRequest, failed_req) -> bool:
        """Resubmit one failed fleet request.  Returns True when a
        healthy replica accepted it (the router map now points there);
        False leaves the terminal ``failed`` standing.  A request that
        died during its PREFILL stage fails over as a FULL submission
        onto the decode plane — the prefill shortcut already proved
        unlucky, and decode/unified replicas prefill fine."""
        now = time.perf_counter()
        if fr.deadline_s is not None \
                and now - fr.submit_time >= fr.deadline_s:
            self.metrics.on_failover_exhausted(
                fr.fleet_id, fr.replica, "deadline already spent")
            return False
        # prefer a DIFFERENT replica; fall back to the (recovered)
        # origin only when it is the sole eligible one
        eligible = self._eligible("decode")
        targets = [h for h in eligible if h.index != fr.replica] \
            or eligible
        if not targets:
            self.metrics.on_failover_exhausted(
                fr.fleet_id, fr.replica, "no healthy replica")
            return False
        src, src_rid = fr.replica, fr.engine_rid
        reason = failed_req.status_reason or "failed"
        for h, hit in self._route_order(targets, fr.prompt):
            try:
                rid = self._submit_to(h, fr, now=now)
            except RequestRejected:
                continue
            # drop the surrendered attempt's record from the old engine
            # (terminal — purge only releases the host-side reference)
            fr.history.append((src, src_rid, reason))
            self._handles[src].engine.purge(src_rid)
            fr.replica, fr.engine_rid = h.index, rid
            fr.role_stage = "decode"
            fr.attempts += 1
            h.routed += 1
            self.metrics.on_failover(fr.fleet_id, src, h.index, reason)
            return True
        self.metrics.on_failover_exhausted(
            fr.fleet_id, fr.replica, "every healthy replica rejected")
        return False

    # --------------------------------------------------------- handoffs
    def _stage_handoff(self, fr: _FleetRequest) -> None:
        """Open the KV handoff for a prefill-stage request whose
        prefill just finished: pin its block path on the source replica
        and let :meth:`_pump_handoffs` drive the transfer."""
        src = self._handles[fr.replica]
        req = src.engine._requests.get(fr.engine_rid)
        rec = self._handoffs.stage(fr.fleet_id, src, fr.prompt,
                                   0 if req is None
                                   else req.prefix_hit_tokens)
        try:
            self.metrics.c_handoff_staged.inc()
            self.metrics.on_handoff("stage", fr.fleet_id, rec.src, -1,
                                    tokens=rec.tokens)
        except BaseException:
            # telemetry must never leak the staged pin
            self._handoffs.abort(rec, "stage telemetry failed")
            raise

    def _handoff_dst(self, fr: _FleetRequest,
                     tokens: int) -> Optional[ReplicaHandle]:
        """The transfer target: the healthiest, lightest-loaded decode
        replica (load on the decode side — the prefill side already
        spent its affinity), skipping replicas with no free staging
        slot while blocks actually need to move."""
        targets = sorted(
            self._eligible("decode"),
            key=lambda h: (h.health_rank, h.load, h.index))
        for h in targets:
            if tokens == 0 or h.engine.core.pool.free_slots > 0:
                return h
        return None

    def _pump_handoffs(self) -> None:
        """Advance every pending handoff one transition per fleet step:
        staged records transfer (or defer while no destination can
        stage them, bounded by the manager's patience), successful
        transfers commit + resubmit, terminal failures fall to the
        recovery path.  Any record whose request was settled meanwhile
        (cancel/purge) is aborted so its pin cannot leak."""
        for fid in list(self._handoffs.records):
            rec = self._handoffs.records.get(fid)
            if rec is None:
                continue
            fr = self._requests.get(fid)
            if fr is None or fid not in self._live:
                self._handoffs.abort(rec, "request settled mid-handoff")
                self.metrics.c_handoff_aborted.inc()
                self.metrics.on_handoff("abort", fid, rec.src, rec.dst,
                                        reason=rec.reason)
                continue
            dst = self._handoff_dst(fr, rec.tokens)
            if dst is None:
                rec.deferred_steps += 1
                if rec.deferred_steps > self._handoffs.stage_patience:
                    self._handoffs.abort(
                        rec, "no decode replica could stage the "
                             "transfer within patience")
                    self._abort_metrics(rec)
                    self._recover_handoff(fr, rec)
                continue
            src = self._handles[rec.src]
            if self._handoffs.transfer(rec, src, dst, fr.prompt):
                self._commit_handoff(fr, rec, dst)
            elif rec.state == ABORTED:
                self._abort_metrics(rec)
                self._recover_handoff(fr, rec)
            else:
                # retryable in-flight fault: the record fell back to
                # staged with the pin held; the next pump retries
                self.metrics.c_handoff_retries.inc()
                self.metrics.on_handoff("retry", fid, rec.src, rec.dst,
                                        attempt=rec.transfer_attempts)

    def _abort_metrics(self, rec) -> None:
        self.metrics.c_handoff_aborted.inc()
        self.metrics.on_handoff("abort", rec.fleet_id, rec.src, rec.dst,
                                reason=rec.reason)

    def _commit_handoff(self, fr: _FleetRequest, rec,
                        dst: ReplicaHandle) -> None:
        """Seal a successful transfer and hand the decode phase to the
        destination.  A commit-stage fault (the ``handoff_commit``
        chaos point) aborts instead — the blocks already moved, so the
        recovery resubmission simply finds them cached."""
        try:
            self._handoffs.commit(rec)
        except Exception as e:
            self._handoffs.abort(rec, f"commit fault: {e!r}")
            self._abort_metrics(rec)
            self._recover_handoff(fr, rec)
            return
        self.metrics.c_handoff_committed.inc()
        if rec.blocks_moved:
            self.metrics.c_handoff_blocks.inc(rec.blocks_moved)
        self.metrics.on_handoff("commit", fr.fleet_id, rec.src, rec.dst,
                                blocks=rec.blocks_moved,
                                tokens=rec.tokens)
        self._place_decode_phase(
            fr, first=dst,
            why=f"handoff committed ({rec.blocks_moved} blocks)")

    def _recover_handoff(self, fr: _FleetRequest, rec) -> None:
        """An aborted handoff's fallback: RE-PREFILL on the decode
        side — the request resubmits in full with no transferred state
        (whatever blocks DID land are found by normal admission
        matching).  When no decode replica accepts, the request fails
        terminally at the router (the engine-side record is a stale
        one-token view, so the terminal stamp lives on the fleet
        record)."""
        self._place_decode_phase(
            fr, first=None, why=f"handoff aborted: {rec.reason}")

    def _place_decode_phase(self, fr: _FleetRequest,
                            first: Optional[ReplicaHandle],
                            why: str) -> None:
        """Resubmit the full request for its decode phase, preferring
        ``first`` (the transfer destination — its cache is warm), then
        every other eligible decode replica.  Exhaustion is terminal.
        A deadline that expired while the handoff waited is terminal
        ``deadline_exceeded`` — not a zero-budget resubmission whose
        failure would masquerade as a placement problem (the same
        short-circuit ``_try_failover`` performs)."""
        now = time.perf_counter()
        if fr.deadline_s is not None \
                and now - fr.submit_time >= fr.deadline_s:
            self.metrics.on_handoff("expired", fr.fleet_id, fr.replica,
                                    -1, reason=why)
            fr.override = ("deadline_exceeded",
                           f"end-to-end deadline {fr.deadline_s}s "
                           f"spent during the KV handoff ({why})")
            self._journal_terminal(fr, *fr.override)
            self._live.discard(fr.fleet_id)
            return
        targets = [] if first is None else [first]
        targets += [h for h in self._eligible("decode")
                    if h not in targets]
        src, src_rid = fr.replica, fr.engine_rid
        for h in targets:
            try:
                rid = self._submit_to(h, fr, now=now, regenerate=False)
            except RequestRejected:
                continue
            fr.history.append((src, src_rid, why))
            self._handles[src].engine.purge(src_rid)
            fr.replica, fr.engine_rid = h.index, rid
            fr.role_stage = "decode"
            fr.handoffs += 1
            h.routed += 1
            return
        self.metrics.c_handoff_failed.inc()
        self.metrics.on_handoff("failed_terminal", fr.fleet_id, src, -1,
                                reason=why)
        fr.override = ("failed",
                       f"no decode replica accepted the post-handoff "
                       f"submission ({why})")
        self._journal_terminal(fr, *fr.override)
        self._live.discard(fr.fleet_id)

    # ------------------------------------------------------------ drains
    def drain(self, replica: int) -> None:
        """Stop routing NEW work to ``replica`` (index) while its
        in-flight requests finish normally — the graceful half of
        taking a replica out of rotation.  Balance with
        :meth:`undrain` — or :meth:`retire`, for permanent removal: a
        drain leaked on an
        exception path silently shrinks the fleet.

        Edge semantics (pinned by unit tests): an out-of-range index
        raises the descriptive ``KeyError`` every replica lookup uses;
        draining an ALREADY-draining or retired replica raises
        ``ValueError`` — a double drain is always a caller bug (two
        owners both believe they hold the drain window)."""
        h = self._handle(replica)
        if h.retired:
            raise ValueError(
                f"replica {replica} is retired — it left the rotation "
                f"permanently and cannot be drained")
        if h.draining:
            raise ValueError(
                f"replica {replica} is already draining — a second "
                f"drain means two owners think they hold the drain "
                f"window; undrain() first if that is intended")
        h.draining = True
        self.metrics.on_drain(replica, "drain")
        self.metrics.publish(self._handles)

    def undrain(self, replica: int) -> None:
        """Return a drained replica to the routing rotation
        (idempotent — undraining a non-draining replica is a no-op;
        out-of-range indices still raise the descriptive KeyError;
        retired replicas can never re-enter rotation)."""
        h = self._handle(replica)
        if h.retired:
            raise ValueError(
                f"replica {replica} is retired — its engine is closed "
                f"and it cannot return to rotation")
        h.draining = False
        self.metrics.on_drain(replica, "undrain")
        self.metrics.publish(self._handles)

    def drained(self, replica: int) -> bool:
        """True once a draining replica has no queued or in-flight
        work left — safe to rebuild/retire."""
        h = self._handle(replica)
        return h.draining and not h.engine.core.scheduler.has_work()

    # ----------------------------------------------------------- results
    def _record(self, fleet_id: int) -> _FleetRequest:
        fr = self._requests.get(fleet_id)
        if fr is None:
            raise KeyError(
                f"unknown fleet request_id {fleet_id} — never submitted "
                f"to this router, or already purged")
        return fr

    def _migrating(self, fr: _FleetRequest, out: RequestOutput) -> bool:
        """True while a prefill-stage request's one-token run has
        finished but the router still owes it a decode phase (handoff
        staged/pending or about to be) — the engine-side 'finished'
        is an interim view, not the request's terminal state."""
        return (fr.fleet_id in self._live
                and fr.role_stage == "prefill"
                and out.finished and out.status == "finished"
                and out.finish_reason != "eos"
                and fr.max_new_tokens > 1)

    def result(self, fleet_id: int) -> RequestOutput:
        """The request's current view FROM ITS OWNING REPLICA (the map
        is authoritative across failovers AND handoffs), re-keyed to
        the fleet id.  While a handoff is mid-flight the view shows
        the prefill side's delivered prefix with ``finished=False`` —
        a polling client must not mistake the one-token prefill run
        for the request's terminal state.  A router-level terminal
        stamp (handoff placement exhausted) overrides the stale engine
        record."""
        fr = self._record(fleet_id)
        if fr.replica < 0:
            # never placed on any engine (a recovered request whose
            # deadline was spent across the downtime, or whose
            # resubmission no replica accepted): the fleet record IS
            # the terminal view
            status, reason = fr.override
            return RequestOutput(
                request_id=fleet_id, prompt=fr.prompt, tokens=[],
                finished=True, finish_reason=None, ttft_s=None,
                status=status, status_reason=reason)
        out = self._handles[fr.replica].engine.result(fr.engine_rid)
        if fr.override is not None:
            status, reason = fr.override
            out = dataclasses.replace(out, finished=True, status=status,
                                      status_reason=reason)
        elif self._migrating(fr, out):
            out = dataclasses.replace(out, finished=False,
                                      finish_reason=None, status=None,
                                      status_reason=None)
        return dataclasses.replace(out, request_id=fleet_id)

    def _abort_pending_handoff(self, fleet_id: int, why: str) -> None:
        """Cancel/purge settled a request the pump still owns a pin
        for: abort its handoff so the source-side pin releases NOW, not
        at the next step."""
        rec = self._handoffs.records.get(fleet_id)
        if rec is not None:
            self._handoffs.abort(rec, why)
            self._abort_metrics(rec)

    def cancel(self, fleet_id: int) -> RequestOutput:
        """Cancel against the CURRENTLY-owning replica — after a
        failover the map already points at the new owner, so a cancel
        can never land on the stale replica's dead record.  Unknown or
        purged ids raise the same descriptive ``KeyError`` the engines
        use; cancelling an already-terminal request is idempotent.  A
        pending KV handoff is aborted (its source pin releases
        immediately)."""
        fr = self._record(fleet_id)
        if fr.replica < 0:
            return self.result(fleet_id)   # already terminal, unplaced
        self.purge_hedge(fr, "cancelled by client")
        out = self._handles[fr.replica].engine.cancel(fr.engine_rid)
        self._live.discard(fleet_id)   # settled: never fail over
        self._abort_pending_handoff(fleet_id, "cancelled by client")
        self._journal_terminal(fr, out.status, out.status_reason)
        return dataclasses.replace(out, request_id=fleet_id)

    def purge(self, fleet_id: int) -> RequestOutput:
        """``result()`` + drop every reference (router map AND the
        owning engine's record).  Long-running fleets must consume
        results this way, exactly like single engines."""
        fr = self._record(fleet_id)
        if fr.replica < 0:
            out = self.result(fleet_id)
            del self._requests[fleet_id]
            return out
        self.purge_hedge(fr, "purged by client")
        out = self._handles[fr.replica].engine.purge(fr.engine_rid)
        self._live.discard(fleet_id)
        self._abort_pending_handoff(fleet_id, "purged by client")
        self._journal_terminal(fr, out.status if fr.override is None
                               else fr.override[0],
                               out.status_reason if fr.override is None
                               else fr.override[1])
        del self._requests[fleet_id]
        if fr.override is not None:
            status, reason = fr.override
            out = dataclasses.replace(out, finished=True, status=status,
                                      status_reason=reason)
        return dataclasses.replace(out, request_id=fleet_id)

    # --------------------------------------------------------- lifecycle
    def stall_snapshot(self) -> Dict[str, object]:
        """Fleet-scope diagnostic state: every replica's
        ``EngineCore.stall_snapshot()`` plus the router's own view —
        roles, drain/retire flags, queue depth, live requests, pending
        handoffs and the autoscaler's state.  Attached to the stall
        detector's :class:`EngineStalledError`, so
        ``run_until_complete(stall_steps=)`` diagnoses wedges at fleet
        scope the way a single engine's snapshot does for one plane."""
        return {
            "queue_depth": self.queue_depth,
            "in_flight": self.in_flight,
            "live_requests": len(self._live),
            "routable_replicas": self.routable_count,
            "fleet_dead": self.fleet_dead,
            "failovers": self.metrics.c_failovers.value,
            "hedges_live": sum(1 for fr in self._requests.values()
                               if fr.hedge_rid >= 0),
            "brownout_level": self._brownout.level,
            "slow_replicas": [h.index for h in self._handles
                              if not h.retired
                              and h.engine.health.slow],
            "handoffs_pending": self._handoffs.pending,
            "handoffs": self._handoffs.snapshot(),
            "journal": None if self.journal is None
            else self.journal.position(),
            "autoscaler": None if self._autoscaler is None
            else self._autoscaler.snapshot(),
            "replicas": [
                {"index": h.index, "role": h.role,
                 "draining": h.draining, "retired": h.retired,
                 "killed": h.killed, "routed": h.routed,
                 "slow": h.engine.health.slow,
                 "step_ewma_s": round(h.step_ewma_s, 4),
                 # a killed replica's engine is a dead process: its
                 # internals are unreadable by definition, so the
                 # snapshot carries only the router-side view
                 **({} if h.killed
                    else h.engine.core.stall_snapshot())}
                for h in self._handles],
        }

    def fleet_snapshot(self) -> Dict[str, object]:
        """Back-compat alias for :meth:`stall_snapshot`."""
        return self.stall_snapshot()

    def metrics_dict(self) -> Dict[str, object]:
        """Fleet-level counters + each replica's own
        ``metrics_dict()``."""
        m = self.metrics
        return {
            "replicas": len(self._handles),
            "requests_routed": m.c_routed.value,
            "prefix_hit_tokens": m.c_hit_tokens.value,
            "failovers": m.c_failovers.value,
            "failovers_exhausted": m.c_failover_exhausted.value,
            "requests_rejected": m.c_rejected.value,
            "queue_depth": self.queue_depth,
            "roles": [h.role for h in self._handles],
            "retired_replicas": sum(1 for h in self._handles
                                    if h.retired),
            "killed_replicas": sum(1 for h in self._handles
                                   if h.killed),
            "crash_reattributed": m.c_crash_reattributed.value,
            "replay_resubmitted": m.c_replay_resubmitted.value,
            "replay_expired": m.c_replay_expired.value,
            "hedges": m.c_hedges.value,
            "hedge_wins": m.c_hedge_wins.value,
            "hedges_failed": m.c_hedge_failed.value,
            "shed_batch": m.c_shed_batch.value,
            "brownout_level": self._brownout.level,
            "slow_replicas": sum(1 for h in self._handles
                                 if not h.retired
                                 and h.engine.health.slow),
            "journal": None if self.journal is None
            else self.journal.position(),
            "handoffs_staged": m.c_handoff_staged.value,
            "handoffs_committed": m.c_handoff_committed.value,
            "handoffs_aborted": m.c_handoff_aborted.value,
            "handoff_retries": m.c_handoff_retries.value,
            "handoff_blocks_moved": m.c_handoff_blocks.value,
            "handoffs_failed_terminal": m.c_handoff_failed.value,
            "per_replica": [h.engine.metrics_dict()
                            for h in self._handles],
        }

    def accounting(self) -> Dict[str, object]:
        """The fleet total-accounting verdict (serving/fleet.py) over
        every request this router still tracks — call after a drain."""
        from . import fleet as _fleet
        return _fleet.fleet_accounting(self)

    def close(self) -> None:
        """Close every replica (idempotent, like
        :meth:`ServingEngine.close`)."""
        if self._closed:
            return
        self._closed = True
        for h in self._handles:
            h.engine.close()
