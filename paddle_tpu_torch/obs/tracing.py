"""Request-lifecycle spans + discrete-event log, ring-buffered.

A :class:`Tracer` records two kinds of host-side facts:

  * **spans** — named ``[start, end)`` intervals on an integer *lane*
    (the serving engine uses lane 0 for its step phases and lane
    ``1 + request_id`` for each request's lifecycle: queued → admitted →
    prefix-match → gather → prefill chunk×N → first-token → decode →
    finish).  Two recording shapes:

      - ``sp = tracer.begin_span(name); ...; tracer.end_span(sp)`` for
        intervals measured live (end it in a ``finally`` so a raised
        step still closes its span);
      - ``tracer.add_span(name, lane, start, end)`` for intervals whose
        endpoints the caller ALREADY holds (the engine's request
        timestamps) — zero extra clock reads on the hot path;

  * **events** — zero-duration marks (program compiles, LRU evictions,
    head-of-line skips, slot churn) via ``tracer.event(name, ...)``.

All timestamps are ``time.perf_counter()`` seconds; :meth:`chrome_events`
renders every lane as a labelled row of a Chrome trace, and
:meth:`Tracer.install_profiler_source` merges those rows into every
``profiler`` chrome export.  The port's own copy of
paddle_tpu/obs/tracing.py.

Memory is bounded: spans and events live in fixed-size rings (oldest
evicted first) and lane labels in a capped map — a month-long serving
run holds the same telemetry footprint as a ten-second one.  Pure host
code; never imports torch, never touches a device tensor.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

__all__ = ["Span", "Tracer"]

# tracer lanes sit above real thread ids ([0, 100000)) so the two never
# collide when traces are merged
_TID_BASE = 100000
_MAX_LANE_NAMES = 1024
# lanes are handed out in blocks so several producers (e.g. two serving
# engines) sharing one tracer never collide on a lane id
_LANE_BLOCK = 1 << 20


class Span:
    """One named interval on a lane; ``attrs`` is small, JSON-able."""

    __slots__ = ("name", "lane", "start", "end", "attrs")

    def __init__(self, name: str, lane: int, start: float,
                 end: float = 0.0, attrs: Optional[dict] = None):
        self.name = name
        self.lane = lane
        self.start = start
        self.end = end
        self.attrs = attrs if attrs is not None else {}

    @property
    def duration(self) -> float:
        return self.end - self.start

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, lane={self.lane}, "
                f"start={self.start:.6f}, end={self.end:.6f})")


class Tracer:
    """Ring-buffered span/event recorder (one per engine or trainer)."""

    # width of one claim_lane_block() reservation; producers must fold
    # unbounded per-item lane offsets back into [base+1, base+LANE_BLOCK)
    LANE_BLOCK = _LANE_BLOCK

    def __init__(self, max_spans: int = 4096, max_events: int = 1024,
                 enabled: bool = True):
        self.enabled = enabled
        self._spans: deque = deque(maxlen=max_spans)
        self._events: deque = deque(maxlen=max_events)
        self._lane_names: "OrderedDict[int, str]" = OrderedDict()
        self._pinned_names: Dict[int, str] = {}
        self._next_lane_base = 0
        self._install_count = 0

    def claim_lane_block(self) -> int:
        """Reserve a disjoint lane range for one producer; every caller
        gets its own base, so two engines recording into a shared tracer
        never write different requests onto the same lane."""
        base = self._next_lane_base
        self._next_lane_base += _LANE_BLOCK
        return base

    # --------------------------------------------------------- recording
    def enable(self) -> None:
        """Start recording.  Pair it with ``disable`` in try/finally so
        a raised run cannot leave a tracer capturing forever."""
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    # ------------------------------------------------------------- spans
    def begin_span(self, name: str, lane: int = 0,
                   **attrs) -> Optional[Span]:
        """Open a live span; returns None while disabled (``end_span``
        accepts None, so callers need no enabled-guard of their own)."""
        if not self.enabled:
            return None
        return Span(name, lane, time.perf_counter(), 0.0, attrs or None)

    def end_span(self, span: Optional[Span]) -> None:
        """Close + record a span from :meth:`begin_span` (None = no-op)."""
        if span is None:
            return
        span.end = time.perf_counter()
        self._spans.append(span)

    def add_span(self, name: str, lane: int, start: float, end: float,
                 **attrs) -> None:
        """Record a completed span from timestamps the caller already
        holds — the off-hot-path shape (no clock reads here)."""
        if not self.enabled:
            return
        self._spans.append(Span(name, lane, start, end, attrs or None))

    # ------------------------------------------------------------ events
    def event(self, name: str, lane: int = 0, t: Optional[float] = None,
              **attrs) -> None:
        """Record a discrete mark (compile, eviction, skip, churn)."""
        if not self.enabled:
            return
        if t is None:
            t = time.perf_counter()
        self._events.append((name, lane, t, attrs))

    # ------------------------------------------------------------- lanes
    def set_lane_name(self, lane: int, name: str,
                      pin: bool = False) -> None:
        """Label a lane for trace viewers.  Unpinned labels live in a
        capped LRU map (oldest evicted — matching the span ring);
        ``pin=True`` labels (the engine's own lane) are never evicted."""
        if pin:
            self._pinned_names[lane] = name
            return
        if lane in self._lane_names:
            self._lane_names.move_to_end(lane)
        self._lane_names[lane] = name
        while len(self._lane_names) > _MAX_LANE_NAMES:
            self._lane_names.popitem(last=False)

    # -------------------------------------------------------------- read
    def spans(self, lane: Optional[int] = None,
              name: Optional[str] = None) -> List[Span]:
        """Recorded spans, oldest first, optionally filtered."""
        return [s for s in self._spans
                if (lane is None or s.lane == lane)
                and (name is None or s.name == name)]

    def events(self, name: Optional[str] = None
               ) -> List[Tuple[str, int, float, dict]]:
        return [e for e in self._events if name is None or e[0] == name]

    def clear(self) -> None:
        """Drop recorded spans/events (lane labels persist — the engine
        lane keeps its name across ``metrics.reset()`` windows)."""
        self._spans.clear()
        self._events.clear()

    # ------------------------------------------------------------ export
    def chrome_events(self, pid: Optional[int] = None) -> List[dict]:
        """Chrome-trace (catapult) event dicts: one ``X`` slice per span,
        one ``i`` instant per event, plus ``thread_name`` metadata so
        every lane renders as its own labelled row.  Timestamps are
        perf_counter microseconds — the exact base ``RecordEvent`` host
        events use, so merged traces line up."""
        if pid is None:
            pid = os.getpid()
        out: List[dict] = []
        lanes: Dict[int, bool] = {}
        for sp in list(self._spans):
            lanes[sp.lane] = True
            out.append({
                "name": sp.name, "ph": "X",
                "ts": sp.start * 1e6,
                "dur": max(sp.duration * 1e6, 1.0),
                "pid": pid, "tid": _TID_BASE + sp.lane,
                # a block BASE lane is a producer's own timeline (every
                # engine's, not just the first's); offsets are items
                "cat": "serving" if sp.lane % _LANE_BLOCK == 0
                       else "request",
                "args": dict(sp.attrs),
            })
        for name, lane, t, attrs in list(self._events):
            lanes[lane] = True
            out.append({
                "name": name, "ph": "i", "s": "t",
                "ts": t * 1e6,
                "pid": pid, "tid": _TID_BASE + lane,
                "cat": "event", "args": dict(attrs),
            })
        for lane in sorted(lanes):
            label = self._pinned_names.get(lane) \
                or self._lane_names.get(lane) or f"lane {lane}"
            out.append({
                "name": "thread_name", "ph": "M",
                "pid": pid, "tid": _TID_BASE + lane,
                "args": {"name": label},
            })
        return out

    def install_profiler_source(self) -> None:
        """Merge this tracer's lanes into every later ``profiler`` chrome
        export.  Install / remove pairs are refcounted: a shared tracer
        stays exported until every engine that installed it has removed
        it (one engine's ``close()`` must not blind the rest of a
        fleet)."""
        if self._install_count == 0:
            from ..profiler.profiler import register_trace_source
            register_trace_source(self.chrome_events)
        self._install_count += 1

    def remove_profiler_source(self) -> None:
        if self._install_count == 0:
            return
        self._install_count -= 1
        if self._install_count == 0:
            from ..profiler.profiler import unregister_trace_source
            unregister_trace_source(self.chrome_events)
