"""Serving telemetry facade, updated by the engine OFF the hot path
(counterpart of paddle_tpu/serving/metrics.py, covering the features the
port serves).

Every counter/gauge/histogram lives in an
:class:`~paddle_tpu_torch.obs.MetricsRegistry` and every request carries
a lifecycle span trace in a ring-buffered
:class:`~paddle_tpu_torch.obs.Tracer`; ``snapshot()`` keeps the
reference's dict keys for the instruments the port records.

Every update is a host-side op on values the engine already holds: the
engine's single per-step token readback stays its only device sync.

CLOCK BASE: all timestamps entering this class MUST be
``time.perf_counter()`` readings (``Request.arrival_time`` is stamped
from that clock by ``Scheduler.submit``).
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional, Sequence, Tuple

from ..obs import Histogram, MetricsRegistry, Tracer

__all__ = ["ServingMetrics"]

# admission-projection clamps: a degenerate measurement window must
# yield a FINITE, bounded hint
MAX_RETRY_AFTER_S = 600.0
MAX_PROJECTED_TTFT_S = 3600.0


class ServingMetrics:
    def __init__(self, record_events: bool = False,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        # record_events=True runs each engine step inside a
        # profiler.RecordEvent and merges the tracer's request lanes into
        # every profiler chrome export
        self.record_events = record_events
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        # disjoint lane block per engine: the step timeline sits on
        # engine_lane, request r on engine_lane + 1 + r
        self.engine_lane = self.tracer.claim_lane_block()
        self.tracer.set_lane_name(self.engine_lane, "serving.engine",
                                  pin=True)
        if record_events:
            self.tracer.install_profiler_source()
        self._bind()

    def close(self) -> None:
        """Detach from the profiler's export sources.  Only balances what
        ``__init__`` installed, once: a ``record_events=False`` engine's
        close never decrements a shared tracer's count for its peers."""
        if self.record_events:
            self.record_events = False
            self.tracer.remove_profiler_source()

    def request_lane(self, request_id: int) -> int:
        """Tracer lane for one request, folded into this engine's lane
        block."""
        return self.engine_lane + 1 + request_id % (Tracer.LANE_BLOCK - 1)

    def _bind(self) -> None:
        """Get-or-create this engine's instruments (binding never zeroes
        a shared registry's instruments).  Everything bound here except the
        tp gauge lands in ``self._own``, the list :meth:`reset` zeroes."""
        reg = self.registry
        self._own = []

        def own(make):
            def bind(*a, **kw):
                inst = make(*a, **kw)
                self._own.append(inst)
                return inst
            return bind
        c, h, g = own(reg.counter), own(reg.histogram), own(reg.gauge)

        self._c_submitted = c("serving.requests_submitted",
                              "requests accepted by submit()")
        self._c_finished = c("serving.requests_finished",
                             "requests that reached eos/length")
        self._c_tokens = c("serving.tokens_generated",
                           "output tokens harvested")
        self._c_prefills = c("serving.prefills",
                             "completed request prefills")
        self._c_prefill_tokens = c("serving.prefill_tokens",
                                   "prompt tokens actually prefilled "
                                   "(uncached suffixes)")
        self._c_prefill_chunks = c("serving.prefill_chunks",
                                   "prefill chunks dispatched")
        self._c_prefill_chunk_tokens = c("serving.prefill_chunk_tokens",
                                         "real tokens covered by chunks")
        self._c_prefix_hits = c("serving.prefix_hits",
                                "admissions with a radix-cache match")
        self._c_prefix_hit_tokens = c("serving.prefix_hit_tokens",
                                      "prompt tokens served from cache")
        self._c_steps = c("serving.steps", "engine step() iterations")
        self._c_compiles = c("serving.compiles",
                             "step programs captured as CUDA graphs (the "
                             "engine's capture_counts)")
        self._h_ttft = h("serving.ttft_s",
                         "submit -> first generated token", unit="s")
        self._h_tpot = h("serving.tpot_s",
                         "per-output-token latency after the first",
                         unit="s")
        self._h_step = h("serving.step_s", "engine step wall time",
                         unit="s")
        self._h_chunk = h("serving.prefill_chunk_s",
                          "prefill chunk dispatch wall time", unit="s")
        self._h_queue_wait = h("serving.queue_wait_s",
                               "submit -> admission", unit="s")
        self._h_gather = h("serving.gather_s",
                           "prefix block gather / staging init", unit="s")
        self._h_decode_block = h("kernel.decode_block_s",
                                 "fused decode-block step dispatch wall "
                                 "time (engine fused_decode path)",
                                 unit="s")
        # tensor-parallel serving: the mesh degree, and the wall time of
        # the collective-bearing decode dispatch + readback of tp > 1
        # engines
        # bound outside self._own: the degree is published once, at
        # construction, and a reset must not zero it
        self._g_tp = reg.gauge("serving.tp_degree",
                               "tensor-parallel mesh degree (1 = one "
                               "shard)")
        self._h_collective = h("serving.collective_s",
                               "collective-bearing decode dispatch + "
                               "readback wall time (recorded only on tp > 1 "
                               "engines)", unit="s")
        self._g_queue_depth = g("serving.queue_depth",
                                "waiting requests at the last step")
        self._g_occupancy = g("serving.slot_occupancy",
                              "occupied/total slots at the last step")
        # terminal-status counters partition every submitted request:
        # finished + cancelled + deadline_exceeded + failed (+ rejected,
        # which never enters the queue) == submitted, once drained
        self._c_cancelled = c("serving.requests_cancelled",
                              "requests unwound by cancel()")
        self._c_deadline = c("serving.requests_deadline_exceeded",
                             "requests terminated by a blown deadline")
        self._c_failed = c("serving.requests_failed",
                           "requests terminally failed")
        self._c_rejected = c("serving.requests_rejected",
                             "submissions refused (backpressure/SLO/"
                             "circuit)")
        self._c_faults = c("serving.faults",
                           "faults observed by the watchdog (injected "
                           "or real)")
        self._c_retries = c("serving.step_retries",
                            "watchdog step retries (backoff sleeps)")
        self._c_quarantines = c("serving.quarantines",
                                "quarantine rebuilds of the device plane")
        # zeroed by reset() like the rest; a fault-tolerant engine
        # publishes the state again at the end of every step
        self._g_health = g("serving.health_state",
                           "0 healthy / 1 degraded / 2 quarantined / "
                           "3 circuit_open")
        self._g_degradation = g("serving.degradation_level",
                                "optional subsystems disabled by the "
                                "degradation ladder")
        self._last_health_state: Optional[str] = None
        # speculative decoding: draft tokens proposed vs draft tokens the
        # verify step accepted; accepted / drafted is the acceptance rate
        self._c_spec_draft = c("spec.draft_tokens",
                               "draft tokens proposed by the n-gram "
                               "tables (verify-window fill)")
        self._c_spec_accept = c("spec.accepted_tokens",
                                "draft tokens the verify step accepted "
                                "(free decode steps)")
        # the AOT store (serving/aot.py): attach accounting.  The counters
        # reset with the window; the two gauges are the engine's lifetime
        # facts (how long its last attach took, how long the store's
        # build took) and bind outside self._own, like serving.tp_degree:
        # nothing would publish them again after a reset
        self._c_aot_loads = c("aot.loads",
                              "legs attached from the AOT store (their "
                              "graphs captured at attach, not at first "
                              "use)")
        self._c_aot_misses = c("aot.misses",
                               "AOT lookups with no usable leg "
                               "(fingerprint skew / leg not in store)")
        self._c_aot_fallbacks = c("aot.fallbacks",
                                  "AOT leg attaches that failed (corrupt "
                                  "object, injected fault) and left the "
                                  "leg to capture at first use")
        self._g_aot_load_s = reg.gauge("aot.load_s",
                                       "wall seconds the engine's last "
                                       "attach spent")
        self._g_aot_build_s = reg.gauge("aot.build_s",
                                        "wall seconds the attached "
                                        "store's build spent on its "
                                        "legs (from the store index)")
        self._phase_h: Dict[str, Histogram] = {}
        self._zero_local()

    def _zero_local(self) -> None:
        # per-ENGINE tallies feeding the derived rates (a shared registry's
        # counters aggregate every engine bound to it)
        self._busy_s = 0.0
        self._queue_depth_sum = 0
        self._occupancy_sum = 0.0
        self._tokens_local = 0
        self._steps_local = 0
        self._finished_local = 0
        self._spec_draft_local = 0
        self._spec_accept_local = 0

    def reset(self) -> None:
        """Zero THIS engine's instruments and drop the tracer's recorded
        spans / events: a fresh measurement window (warm-up, then
        measure).  Only the serving instruments bound here reset; other
        producers' metrics in a shared registry are untouched.  A shared
        tracer's buffer is one, so its clear drops every producer's
        spans."""
        for inst in (*self._own, *self._phase_h.values()):
            inst.reset()
        self.tracer.clear()
        self._zero_local()

    # ------------------------------------------------------------ events
    def on_submit(self, n: int = 1) -> None:
        self._c_submitted.inc(n)

    def on_prefill(self, prompt_len: int) -> None:
        """One request's prefill completed; ``prompt_len`` counts only
        the tokens the model actually ran (the uncached suffix)."""
        self._c_prefills.inc()
        self._c_prefill_tokens.inc(prompt_len)

    def on_prefill_chunk(self, tokens: int,
                         seconds: Optional[float] = None) -> None:
        self._c_prefill_chunks.inc()
        self._c_prefill_chunk_tokens.inc(tokens)
        if seconds is not None:
            self._h_chunk.observe(seconds)

    def on_prefix_hit(self, tokens: int) -> None:
        self._c_prefix_hits.inc()
        self._c_prefix_hit_tokens.inc(tokens)

    def on_queue_wait(self, seconds: float) -> None:
        self._h_queue_wait.observe(seconds)

    def on_gather(self, seconds: float) -> None:
        self._h_gather.observe(seconds)

    def on_decode_block(self, active: bool, reason: Optional[str],
                        step: int = 0, tp: int = 1) -> None:
        """The engine resolved its decode path (emitted once, at
        construction): ``active`` says whether the fused decode-block
        kernels serve decode, ``reason`` carries the fallback cause when
        ``fused_decode`` asked for fusion but legality refused (None when
        fused engaged or the flag was off), ``tp`` the tensor-parallel
        degree.  Lands as a ``decode_block`` event on the engine lane."""
        self.tracer.event("decode_block", lane=self.engine_lane,
                          active=active,
                          reason=reason if reason is not None else "",
                          step=step, tp=tp)

    def on_aot_load(self, programs: int, seconds: float,
                    build_s: Optional[float] = None) -> None:
        """The engine finished an attach: ``programs`` legs of the AOT
        store attached in ``seconds`` of wall time (``build_s``: the
        store's recorded build time, published as the ``aot.build_s``
        gauge).  Lands as an ``aot_load`` event on the engine lane."""
        self._c_aot_loads.inc(programs)
        self._g_aot_load_s.set(seconds)
        if build_s is not None:
            self._g_aot_build_s.set(build_s)
        self.tracer.event("aot_load", lane=self.engine_lane,
                          programs=programs, seconds=round(seconds, 6))

    def on_aot_miss(self, program: str, reason: str) -> None:
        """An AOT lookup found no usable leg (store fingerprint skew, or
        ``program``'s leg absent): the engine captures at first use.  A
        degradation event (``aot_miss``), never an error."""
        self._c_aot_misses.inc()
        self.tracer.event("aot_miss", lane=self.engine_lane,
                          program=program, reason=reason)

    def on_aot_fallback(self, program: str, reason: str) -> None:
        """An attach of ``program``'s leg failed (a corrupt object, an
        injected ``aot_load`` fault) and the leg captures at first use.
        Lands as an ``aot_fallback`` event."""
        self._c_aot_fallbacks.inc()
        self.tracer.event("aot_fallback", lane=self.engine_lane,
                          program=program, reason=reason)

    def on_decode_block_step(self, seconds: float) -> None:
        """One fused-path decode dispatch's wall time (the engine calls
        this only on steps whose decode ran the fused kernel pair, so the
        ``kernel.decode_block_s`` histogram is separable from
        ``serving.phase.decode_dispatch_s`` in one registry)."""
        self._h_decode_block.observe(seconds)

    def set_tp_degree(self, tp: int) -> None:
        self._g_tp.set(tp)

    def on_collective(self, seconds: float) -> None:
        """One tensor-parallel decode step's dispatch + readback time (the
        engine calls this only when ``tp > 1``)."""
        self._h_collective.observe(seconds)

    def on_compile(self, program: str, n: int = 1) -> None:
        """``n`` captures of the engine's ``program`` (``"decode"``: its
        decode step as one CUDA graph)."""
        self._c_compiles.inc(n)

    def on_first_token(self, arrival_t: float,
                       now: Optional[float] = None) -> None:
        """Record one TTFT sample; ``arrival_t`` MUST be a
        ``time.perf_counter()`` reading (a mixed clock base raises)."""
        if now is None:
            now = time.perf_counter()
        ttft = now - arrival_t
        if ttft < 0:
            raise ValueError(
                f"on_first_token: arrival_t {arrival_t!r} is ahead of "
                f"perf_counter now {now!r} — arrival timestamps must be "
                f"time.perf_counter() readings")
        self._h_ttft.observe(ttft)

    def on_output_token(self, seconds: float) -> None:
        self._h_tpot.observe(seconds)

    def on_finish(self, n: int = 1) -> None:
        self._c_finished.inc(n)
        self._finished_local += n

    def on_terminal(self, status: str, reason: str, request_id: int,
                    now: Optional[float] = None) -> None:
        """One request reached an ABNORMAL terminal status (normal
        completion goes through :meth:`on_finish`)."""
        counter = {"cancelled": self._c_cancelled,
                   "deadline_exceeded": self._c_deadline,
                   "failed": self._c_failed,
                   "rejected": self._c_rejected}.get(status)
        if counter is None:
            raise ValueError(f"unknown terminal status {status!r}")
        counter.inc()
        self.tracer.event("request_" + status,
                          lane=self.request_lane(request_id),
                          t=now, request=request_id, reason=reason)

    def on_spec(self, drafted: int, accepted: int) -> None:
        """One speculative step's draft / accept tally (after the harvest
        of its verify windows)."""
        self._c_spec_draft.inc(drafted)
        self._c_spec_accept.inc(accepted)
        self._spec_draft_local += drafted
        self._spec_accept_local += accepted

    def on_spec_disable(self, reason: str) -> None:
        """Speculation was turned off at run time: a ``spec_disable``
        event on the engine lane marks where the engine fell back to one
        token per step."""
        self.tracer.event("spec_disable", lane=self.engine_lane,
                          reason=reason[:200])

    def on_fault(self, site: str, error: str, step: int = 0) -> None:
        """One fault (injected or real) attributed to ``site``: an
        injection point or a subsystem name."""
        self._c_faults.inc()
        self.tracer.event("fault", lane=self.engine_lane, site=site,
                          error=error[:200], step=step)

    def on_retry(self, attempt: int, backoff_s: float,
                 step: int = 0) -> None:
        self._c_retries.inc()
        self.tracer.event("step_retry", lane=self.engine_lane,
                          attempt=attempt, backoff_s=round(backoff_s, 4),
                          step=step)

    def on_degrade(self, subsystem: str, level: int, reason: str) -> None:
        """The degradation ladder disabled an optional subsystem: the gauge
        holds the ladder level, the event says which and why."""
        self._g_degradation.set(level)
        self.tracer.event("degrade", lane=self.engine_lane,
                          subsystem=subsystem, level=level,
                          reason=reason[:200])

    def on_health_state(self, state: str, code: int,
                        step: int = 0) -> None:
        """The gauge holds the latest state; the event fires only on a
        transition."""
        self._g_health.set(code)
        if state != self._last_health_state:
            self.tracer.event("health_state", lane=self.engine_lane,
                              state=state, step=step)
            self._last_health_state = state

    def on_quarantine(self, phase: str, reason: str, step: int = 0,
                      seconds: Optional[float] = None) -> None:
        """``phase`` is ``"enter"`` or ``"leave"``; one quarantine counts
        once, on enter; leave carries the rebuild's seconds."""
        if phase == "enter":
            self._c_quarantines.inc()
        attrs = {"reason": reason[:200], "step": step}
        if seconds is not None:
            attrs["seconds"] = round(seconds, 4)
        self.tracer.event(f"quarantine_{phase}", lane=self.engine_lane,
                          **attrs)

    # -------------------------------------------- admission projections
    @property
    def completion_rate(self) -> Optional[float]:
        """Requests completed per second of engine busy time (None until
        one finished, or when the window is degenerate)."""
        if self._finished_local <= 0 or self._busy_s <= 0:
            return None
        rate = self._finished_local / self._busy_s
        if not math.isfinite(rate) or rate <= 0.0:
            return None
        return rate

    def retry_after_hint(self, excess: int = 1) -> Optional[float]:
        rate = self.completion_rate
        if rate is None:
            return None
        return min(max(excess, 1) / rate, MAX_RETRY_AFTER_S)

    def projected_ttft_s(self, queue_depth: int) -> Optional[float]:
        """Queue drain time ahead of a new arrival plus the live p50
        TTFT (None with no history)."""
        rate = self.completion_rate
        if rate is None:
            return None
        base = self._h_ttft.quantile(0.50) or 0.0
        return min(queue_depth / rate + base, MAX_PROJECTED_TTFT_S)

    def record_step(self, active_slots: int, num_slots: int,
                    queue_depth: int, new_tokens: int,
                    step_seconds: float, step_index: int = 0,
                    phases: Optional[Sequence[Tuple[str, float, float]]]
                    = None) -> None:
        """One engine step's accounting (after the token harvest);
        ``phases`` are ``(name, start, end)`` perf_counter triples, each
        recorded in ``serving.phase.<name>_s`` and as a ``step.<name>``
        span on the engine lane."""
        occupancy = active_slots / max(num_slots, 1)
        self._c_steps.inc()
        self._c_tokens.inc(new_tokens)
        self._busy_s += step_seconds
        self._queue_depth_sum += queue_depth
        self._occupancy_sum += occupancy
        self._tokens_local += new_tokens
        self._steps_local += 1
        self._g_queue_depth.set(queue_depth)
        self._g_occupancy.set(occupancy)
        self._h_step.observe(step_seconds)
        for name, start, end in phases or ():
            hp = self._phase_h.get(name)
            if hp is None:
                hp = self.registry.histogram(f"serving.phase.{name}_s",
                                             f"step phase: {name}",
                                             unit="s")
                self._phase_h[name] = hp
            hp.observe(end - start)
            self.tracer.add_span(f"step.{name}", self.engine_lane, start,
                                 end, step=step_index)

    # --------------------------------------------------------- counters
    @property
    def requests_submitted(self) -> int:
        return self._c_submitted.value

    @property
    def requests_finished(self) -> int:
        return self._c_finished.value

    @property
    def tokens_generated(self) -> int:
        return self._c_tokens.value

    @property
    def prefills(self) -> int:
        return self._c_prefills.value

    @property
    def prefill_tokens(self) -> int:
        return self._c_prefill_tokens.value

    @property
    def prefill_chunks(self) -> int:
        return self._c_prefill_chunks.value

    @property
    def prefix_hits(self) -> int:
        return self._c_prefix_hits.value

    @property
    def prefix_hit_tokens(self) -> int:
        return self._c_prefix_hit_tokens.value

    @property
    def steps(self) -> int:
        return self._c_steps.value

    # ---------------------------------------------------------- derived
    def _q_ms(self, hist: Histogram, q: float) -> Optional[float]:
        v = hist.quantile(q)
        return None if v is None else 1e3 * v

    @property
    def mean_ttft_ms(self) -> Optional[float]:
        m = self._h_ttft.mean
        return None if m is None else 1e3 * m

    @property
    def ttft_p50_ms(self) -> Optional[float]:
        return self._q_ms(self._h_ttft, 0.50)

    @property
    def ttft_p99_ms(self) -> Optional[float]:
        return self._q_ms(self._h_ttft, 0.99)

    @property
    def tpot_p50_ms(self) -> Optional[float]:
        return self._q_ms(self._h_tpot, 0.50)

    @property
    def tpot_p99_ms(self) -> Optional[float]:
        return self._q_ms(self._h_tpot, 0.99)

    @property
    def tokens_per_sec(self) -> Optional[float]:
        if self._busy_s <= 0:
            return None
        return self._tokens_local / self._busy_s

    @property
    def batch_fill_ratio(self) -> Optional[float]:
        if self._steps_local == 0:
            return None
        return self._occupancy_sum / self._steps_local

    @property
    def mean_queue_depth(self) -> Optional[float]:
        if self._steps_local == 0:
            return None
        return self._queue_depth_sum / self._steps_local

    @property
    def spec_acceptance_rate(self) -> Optional[float]:
        """Accepted / drafted over THIS engine's window (None until the
        first speculative step)."""
        if self._spec_draft_local <= 0:
            return None
        return self._spec_accept_local / self._spec_draft_local

    # ---------------------------------------------------------- snapshot
    def snapshot(self) -> Dict[str, object]:
        """The reference's engine-counter dict, for the instruments the
        port records.  The full instrument dump is
        ``self.registry.snapshot()``."""
        r = lambda v, nd=4: None if v is None else round(v, nd)
        return {
            "requests_submitted": self.requests_submitted,
            "requests_finished": self.requests_finished,
            "tokens_generated": self.tokens_generated,
            "prefills": self.prefills,
            "prefill_tokens": self.prefill_tokens,
            "prefill_chunks": self.prefill_chunks,
            "prefill_chunk_tokens": self._c_prefill_chunk_tokens.value,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "steps": self.steps,
            "tokens_per_sec": r(self.tokens_per_sec, 1),
            "mean_ttft_ms": r(self.mean_ttft_ms, 2),
            "ttft_p50_ms": r(self.ttft_p50_ms, 2),
            "ttft_p99_ms": r(self.ttft_p99_ms, 2),
            "tpot_p50_ms": r(self.tpot_p50_ms, 3),
            "tpot_p99_ms": r(self.tpot_p99_ms, 3),
            "batch_fill_ratio": r(self.batch_fill_ratio),
            "mean_queue_depth": r(self.mean_queue_depth, 2),
            "requests_cancelled": self._c_cancelled.value,
            "requests_deadline_exceeded": self._c_deadline.value,
            "requests_failed": self._c_failed.value,
            "requests_rejected": self._c_rejected.value,
            "faults": self._c_faults.value,
            "step_retries": self._c_retries.value,
            "quarantines": self._c_quarantines.value,
            "health_state": self._g_health.value,
            "degradation_level": self._g_degradation.value,
            "spec_draft_tokens": self._c_spec_draft.value,
            "spec_accepted_tokens": self._c_spec_accept.value,
            "spec_acceptance_rate": r(self.spec_acceptance_rate),
        }
