"""Drain-based decode-replica autoscaler for the fleet tier (the port's
own copy of paddle_tpu/serving/autoscaler.py).

Production decode demand breathes: a burst fills every replica's queue,
a lull leaves silicon idle.  The :class:`Autoscaler` is the host-side
control loop that sizes the DECODE side of a (possibly disaggregated)
fleet against the live ``router.queue_depth`` gauge:

  * **scale up** — queue depth at or above ``scale_up_depth`` for
    ``hysteresis_steps`` CONSECUTIVE ticks spawns one decode replica via
    the caller's ``spawn_fn`` (a zero-arg factory returning a ready
    ``ServingEngine``).  The spawn is gated: the replica joins the
    router's rotation ONLY after the factory (and the optional
    ``warmup_fn``) returned successfully — a half-built replica is never
    routable, and a spawn failure (the ``replica_spawn`` chaos point, or
    a real construction error) leaves the router topology untouched;
  * **scale down** — queue depth at or below ``scale_down_depth`` with
    no fleet backlog for ``hysteresis_steps`` consecutive ticks retires
    one AUTOSCALED decode replica (never an operator-built one, never
    below ``min_decode`` decode-capable replicas) through the graceful
    two-phase path: ``router.drain(i)`` stops new work immediately, and
    once the replica reports ``drained`` it is closed and marked retired
    (``router.retire(i)``) — in-flight requests always finish normally;
  * **hysteresis + cooldown** — the consecutive-tick requirement plus a
    ``cooldown_steps`` refractory period after every action stop the
    loop from flapping on a noisy queue;
  * **straggler replacement** (``replace_slow_after``) — an AUTOSCALED
    decode replica the router's straggler detector has marked slow for that
    many consecutive fleet steps is replaced: graceful drain → retire,
    replacement spawned through the normal warmup gate, same cooldown as every
    other action.

An autoscaled replica must eventually retire (or be explicitly kept), so
capacity accounting cannot silently drift.  All state is host-side; ``tick()``
is called by ``Router.step()`` once the autoscaler is attached
(``Autoscaler(router, ...)`` attaches itself).  Telemetry: ``autoscaler.*``
counters/gauges plus ``autoscaler_*`` events on the router's tracer lane.
"""

from __future__ import annotations

from typing import Callable, List, Optional

__all__ = ["Autoscaler"]


class Autoscaler:
    """Queue-depth-driven spawn/retire loop over a
    :class:`~paddle_tpu_torch.serving.router.Router` (see module docstring).

    ``spawn_fn()`` must return a fresh ``ServingEngine`` built onto the
    ROUTER's shared registry/tracer (and, for token parity across the
    fleet, the same weights as its peers).  ``warmup_fn(engine)``, when
    given, runs after construction and before the replica becomes
    routable — use it to serve a warm-up request so a spawned replica
    serves in steps, not captures.  With ``aot_store`` given and a
    factory that accepts ``aot_store=``, every spawn (scale-up,
    resurrection, straggler replacement) hands the shared store to the
    factory, so the replica installs its kernel libraries and captures
    its graphs at construction (serving/aot.py).
    """

    def __init__(self, router, spawn_fn: Callable, *,
                 warmup_fn: Optional[Callable] = None,
                 min_decode: int = 1, max_decode: int = 8,
                 scale_up_depth: int = 8, scale_down_depth: int = 0,
                 hysteresis_steps: int = 4, cooldown_steps: int = 16,
                 replace_slow_after: Optional[int] = None,
                 faults=None,
                 aot_store=None):
        if replace_slow_after is not None and replace_slow_after < 1:
            raise ValueError(
                "replace_slow_after must be >= 1 (or None to disable "
                "straggler replacement)")
        if min_decode < 1:
            raise ValueError("min_decode must be >= 1")
        if max_decode < min_decode:
            raise ValueError("max_decode must be >= min_decode")
        if scale_up_depth <= scale_down_depth:
            raise ValueError(
                "scale_up_depth must exceed scale_down_depth "
                "(overlapping thresholds would oscillate)")
        if hysteresis_steps < 1:
            raise ValueError("hysteresis_steps must be >= 1")
        self.router = router
        self.spawn_fn = spawn_fn
        self.warmup_fn = warmup_fn
        # the AOT store (serving/aot.py): when the fleet has a shared
        # store and the caller's factory can take it
        # (``spawn_fn(aot_store=...)``), every spawn — scale-up,
        # resurrection, straggler replacement — passes the store so the
        # new replica captures its graphs before it is routable.
        # Zero-arg factories keep working unchanged.
        self.aot_store = aot_store
        if aot_store is not None:
            import inspect
            try:
                params = inspect.signature(spawn_fn).parameters
            except (TypeError, ValueError):
                params = {}
            self._spawn_takes_store = "aot_store" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values())
        else:
            self._spawn_takes_store = False
        self.min_decode = min_decode
        self.max_decode = max_decode
        self.scale_up_depth = scale_up_depth
        self.scale_down_depth = scale_down_depth
        self.hysteresis_steps = hysteresis_steps
        self.cooldown_steps = cooldown_steps
        # straggler replacement: an AUTOSCALED decode replica continuously
        # marked slow by the router's detector for this many fleet steps is
        # replaced — drain → retire through the normal graceful path,
        # replacement spawned through the normal warmup gate.  None disables;
        # operator-built replicas are never replaced (slow hardware an operator
        # placed deliberately is the operator's call).
        self.replace_slow_after = replace_slow_after
        self.faults = faults            # chaos hook: replica_spawn
        self._above = 0                 # consecutive ticks over the bar
        self._below = 0                 # consecutive idle ticks
        self._cooldown = 0
        self._spawned: List[int] = []   # replica indices this loop added
        self._retiring: List[int] = []  # draining, waiting to retire
        # killed replica indices whose replacement already spawned —
        # resurrection is per-victim so a dead PREFILL replica is
        # replaced in kind, not as yet another decode replica
        self._resurrected: set = set()
        m = router.metrics
        g, c = m.registry.gauge, m.registry.counter
        self._g_decode = g("autoscaler.decode_replicas",
                           "decode-capable replicas in rotation "
                           "(decode + unified, not draining/retired)")
        self._c_spawns = c("autoscaler.spawns",
                           "decode replicas spawned into the rotation")
        self._c_retires = c("autoscaler.retires",
                            "decode replicas retired via drain")
        self._c_spawn_failures = c(
            "autoscaler.spawn_failures",
            "replica spawns that failed before becoming routable "
            "(the half-built replica was never in rotation)")
        self._c_resurrections = c(
            "autoscaler.resurrections",
            "replacements spawned for KILLED replicas (Router.kill — "
            "crash resurrection through the normal warmup gate)")
        self._c_slow_replacements = c(
            "autoscaler.slow_replacements",
            "autoscaled decode replicas replaced for persistent "
            "straggling (drain -> retire -> spawn)")
        self._lane = m.lane             # events share the router's lane
        self._tracer = m.tracer
        self._publish()
        router.attach_autoscaler(self)

    # ------------------------------------------------------------- sizing
    def decode_count(self) -> int:
        """Decode-capable replicas currently in rotation."""
        return sum(1 for h in self.router.replicas
                   if h.role in ("decode", "unified")
                   and not h.draining and not h.retired)

    def _publish(self) -> None:
        self._g_decode.set(self.decode_count())

    # --------------------------------------------------------------- tick
    def tick(self) -> Optional[str]:
        """One control iteration (the router calls this after every
        fleet step).  Returns the action taken ("spawn" / "retire" /
        "resurrect" / "retired:<i>") or None — test and operator
        visibility."""
        action = self._finish_retirements()
        # replica RESURRECTION: a killed replica is lost capacity, not queue
        # noise — replace it IN KIND (same role) through the same spawn/warmup
        # gate, ignoring hysteresis and cooldown (which exist to damp flapping
        # on a noisy queue, not to slow crash recovery).  A failed spawn
        # (replica_spawn chaos point) leaves the victim unresurrected and the
        # next tick retries.
        dead = [h for h in self.router.replicas
                if h.killed and h.index not in self._resurrected]
        for victim in dead:
            # max_decode bounds only the decode plane; a dead prefill
            # replica's replacement never counts against it — and a
            # decode-capped victim at the head of the list must not
            # starve later victims (a prefill replica especially)
            if victim.serves("decode") \
                    and self.decode_count() >= self.max_decode:
                continue
            if self.spawn(role=victim.role) is not None:
                self._resurrected.add(victim.index)
                self._c_resurrections.inc()
                self._tracer.event("autoscaler_resurrect",
                                   lane=self._lane,
                                   replica=victim.index,
                                   role=victim.role)
                return "resurrect"
            break       # spawn failed: retry next tick, no spawn storm
        if self._cooldown > 0:
            self._cooldown -= 1
            return action
        # straggler replacement: an autoscaled replica persistently marked slow
        # is retired through the normal graceful drain and its capacity
        # respawned at once — subject to the same cooldown as every other
        # action so one bad replica cannot start a churn storm
        if self.replace_slow_after is not None:
            victim = next(
                (self.router.replicas[i] for i in self._spawned
                 if not self.router.replicas[i].draining
                 and not self.router.replicas[i].retired
                 and self.router.replicas[i].slow_ticks
                 >= self.replace_slow_after), None)
            if victim is not None:
                # spawn the replacement FIRST: a failed spawn must not
                # shrink the fleet (slow capacity beats absent capacity
                # and min_decode must hold) — the victim keeps serving
                # and a post-cooldown tick retries.  The cooldown is
                # taken on BOTH outcomes: a persistently failing
                # spawn_fn must not be re-run (model build + warmup)
                # on every fleet step.  The one-tick overshoot of
                # max_decode resolves when the retire's drain starts
                # (a draining replica leaves decode_count immediately).
                self._cooldown = self.cooldown_steps
                if self.spawn() is None:
                    return action
                self.retire(victim.index)
                self._c_slow_replacements.inc()
                self._tracer.event("autoscaler_replace_slow",
                                   lane=self._lane,
                                   replica=victim.index,
                                   slow_ticks=victim.slow_ticks)
                return "replace_slow"
        depth = self.router.queue_depth
        self._above = self._above + 1 if depth >= self.scale_up_depth \
            else 0
        idle = depth <= self.scale_down_depth \
            and self.router.in_flight == 0
        self._below = self._below + 1 if idle else 0
        if self._above >= self.hysteresis_steps \
                and self.decode_count() < self.max_decode:
            self._above = 0
            self._cooldown = self.cooldown_steps
            return "spawn" if self.spawn() is not None else action
        if self._below >= self.hysteresis_steps and self._spawned \
                and self.decode_count() > self.min_decode:
            self._below = 0
            self._cooldown = self.cooldown_steps
            victim = self._pick_victim()
            if victim is not None:
                self.retire(victim)
                return "retire"
        return action

    def _finish_retirements(self) -> Optional[str]:
        """Close out replicas whose drain completed (second phase of
        retire)."""
        done = None
        for idx in list(self._retiring):
            if self.router.replicas[idx].retired:
                # killed (or otherwise force-removed) while draining:
                # the handle already left the fleet — nothing to close
                self._retiring.remove(idx)
                continue
            if self.router.drained(idx):
                self._retiring.remove(idx)
                self.router.retire(idx)
                self._publish()
                self._tracer.event("autoscaler_retired", lane=self._lane,
                                   replica=idx)
                done = f"retired:{idx}"
        return done

    def _pick_victim(self) -> Optional[int]:
        """Lightest-loaded autoscaled decode replica still in
        rotation."""
        live = [self.router.replicas[i] for i in self._spawned
                if not self.router.replicas[i].draining
                and not self.router.replicas[i].retired]
        if not live:
            return None
        return min(live, key=lambda h: (h.load, h.index)).index

    # ------------------------------------------------------ spawn/retire
    def spawn(self, role: str = "decode") -> Optional[int]:
        """Build one replica (``role`` defaults to the scaling loop's
        decode plane; resurrection passes the dead replica's role so a
        prefill victim is replaced in kind) and add it to the rotation;
        returns its replica index, or None when the spawn failed (the
        router is then untouched — a half-built replica is never
        routable).  Balance with :meth:`retire` over the replica's
        life."""
        engine = None
        try:
            if self.faults is not None:
                self.faults.fire("replica_spawn")
            if self._spawn_takes_store:
                engine = self.spawn_fn(aot_store=self.aot_store)
            else:
                engine = self.spawn_fn()
            if self.warmup_fn is not None:
                self.warmup_fn(engine)
        except Exception as e:
            if engine is not None:
                # the factory succeeded but the warmup raised: close the
                # half-built engine, or every failed spawn would keep a
                # device plane (and a record_events engine its profiler
                # source) alive
                try:
                    engine.close()
                except Exception:
                    pass
            self._c_spawn_failures.inc()
            self._tracer.event("autoscaler_spawn_failed", lane=self._lane,
                               error=repr(e)[:200])
            return None
        idx = self.router.add_replica(engine, role=role)
        if role != "prefill":
            # scale-down only ever retires decode-capable autoscaled
            # replicas — a resurrected prefill replica must never be
            # picked as an idle-retirement victim
            self._spawned.append(idx)
        self._c_spawns.inc()
        self._publish()
        self._tracer.event("autoscaler_spawn", lane=self._lane,
                           replica=idx, role=role)
        return idx

    def retire(self, replica: int) -> None:
        """Begin the graceful retirement of ``replica``: drain it now
        (no new work), close + mark retired once its in-flight work
        finishes (a later :meth:`tick` completes the second phase)."""
        self.router.drain(replica)
        self._retiring.append(replica)
        if replica in self._spawned:
            self._spawned.remove(replica)
        self._c_retires.inc()
        self._publish()
        self._tracer.event("autoscaler_retire", lane=self._lane,
                           replica=replica)

    # -------------------------------------------------------------- state
    def snapshot(self) -> dict:
        return {
            "decode_replicas": self.decode_count(),
            "spawned": list(self._spawned),
            "retiring": list(self._retiring),
            "cooldown": self._cooldown,
            "spawns": self._c_spawns.value,
            "retires": self._c_retires.value,
            "spawn_failures": self._c_spawn_failures.value,
            "resurrections": self._c_resurrections.value,
            "resurrected_victims": sorted(self._resurrected),
            "slow_replacements": self._c_slow_replacements.value,
        }
