"""Step-level health state machine, degradation ladder and circuit breaker
(the port's own copy of paddle_tpu/serving/health.py).

The host-side control plane of ``engine.EngineCore``'s watchdog, enabled
by ``ServingEngine(fault_tolerance=...)``:

  * :class:`FaultToleranceConfig` — the step-retry budget and its
    exponential backoff, the per-subsystem fault threshold before the
    degradation ladder disables it, the quarantine limit and window of
    the circuit breaker, and the bounded submit queue;
  * :class:`DegradationLadder` — fault counters per OPTIONAL subsystem
    (``prefix_cache``, ``chunked_prefill``, ``fused_decode``,
    ``spec_verify``): a subsystem that faults ``ladder_threshold`` times
    is disabled and the engine serves without it (cache -> bypass,
    chunking -> whole-bucket prefill, fused decode -> the unfused or
    composed path, speculation -> one token a step);
  * :class:`EngineHealth` — the state machine ``healthy -> degraded ->
    quarantined`` (+ the terminal ``circuit_open``): consecutive core
    step faults earn backed-off retries until the budget is spent, then
    the engine quarantines (fails the in-flight requests, rebuilds its
    device plane, keeps queued work).  Close every ``enter_quarantine``
    with ``leave_quarantine`` in a ``finally``.  The breaker stops
    flapping: ``circuit_quarantine_limit`` quarantines within
    ``circuit_window_steps`` engine steps open the circuit, and the
    engine fails fast instead of rebuilding forever.

State codes of the ``serving.health_state`` gauge: 0 healthy, 1 degraded,
2 quarantined, 3 circuit_open.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Optional, Tuple

__all__ = ["FaultToleranceConfig", "DegradationLadder", "EngineHealth",
           "HEALTHY", "DEGRADED", "QUARANTINED", "CIRCUIT_OPEN",
           "STATE_CODES", "SUBSYSTEMS"]

HEALTHY = "healthy"
DEGRADED = "degraded"
QUARANTINED = "quarantined"
CIRCUIT_OPEN = "circuit_open"
STATE_CODES = {HEALTHY: 0, DEGRADED: 1, QUARANTINED: 2, CIRCUIT_OPEN: 3}

# the optional subsystems the ladder may disable, in ladder order: the
# engine serves correctly (if slower) without any of them
SUBSYSTEMS: Tuple[str, ...] = ("prefix_cache", "chunked_prefill",
                               "fused_decode", "spec_verify")


@dataclasses.dataclass
class FaultToleranceConfig:
    """The watchdog's and the backpressure's knobs."""
    max_step_retries: int = 3       # consecutive core-step faults before
                                    # quarantine
    backoff_base_s: float = 0.02    # sleep 2^(n-1) * base after fault n
    backoff_cap_s: float = 1.0
    ladder_threshold: int = 2       # faults per optional subsystem
                                    # before it is disabled
    circuit_quarantine_limit: int = 3
    circuit_window_steps: int = 512  # quarantines counted within this
                                     # many engine steps trip the breaker
    max_queue: Optional[int] = None  # bounded submit queue (None = off)

    def __post_init__(self):
        if self.max_step_retries < 1:
            raise ValueError("max_step_retries must be >= 1")
        if self.backoff_base_s < 0 or self.backoff_cap_s < 0:
            raise ValueError("backoff seconds must be >= 0")
        if self.ladder_threshold < 1:
            raise ValueError("ladder_threshold must be >= 1")
        if self.circuit_quarantine_limit < 1:
            raise ValueError("circuit_quarantine_limit must be >= 1")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")


class DegradationLadder:
    """Fault counters per optional subsystem.  Disabling is monotone for
    the engine's lifetime: a quarantine rebuild resets device state, not
    the decision that a subsystem is unreliable."""

    def __init__(self, threshold: int):
        self.threshold = threshold
        self._faults = {s: 0 for s in SUBSYSTEMS}
        self._disabled = {s: False for s in SUBSYSTEMS}

    def record_fault(self, subsystem: str) -> bool:
        """Count one fault; True exactly once, when the count reaches the
        threshold and the subsystem should now be disabled."""
        if subsystem not in self._faults:
            raise ValueError(f"unknown subsystem {subsystem!r}")
        if self._disabled[subsystem]:
            return False
        self._faults[subsystem] += 1
        if self._faults[subsystem] >= self.threshold:
            self._disabled[subsystem] = True
            return True
        return False

    def disabled(self, subsystem: str) -> bool:
        return self._disabled[subsystem]

    @property
    def level(self) -> int:
        """Disabled subsystems: the ``serving.degradation_level`` gauge
        (0 = full service)."""
        return sum(1 for v in self._disabled.values() if v)

    @property
    def disabled_subsystems(self) -> Tuple[str, ...]:
        return tuple(s for s in SUBSYSTEMS if self._disabled[s])


class _QuarantineToken:
    """Handle returned by ``enter_quarantine`` and consumed by
    ``leave_quarantine``."""

    __slots__ = ("reason", "t0")

    def __init__(self, reason: str, t0: float):
        self.reason = reason
        self.t0 = t0


class EngineHealth:
    """The watchdog's bookkeeping: consecutive-fault counter, retry
    backoff, quarantine history, breaker state.  The engine performs the
    unwind and the rebuild; this class only decides."""

    def __init__(self, cfg: FaultToleranceConfig):
        self.cfg = cfg
        self.consecutive_faults = 0
        self.quarantine_count = 0
        self.step_index = 0              # engine steps seen (ok or not)
        self._quarantine_steps: Deque[int] = deque(
            maxlen=cfg.circuit_quarantine_limit)
        self._in_quarantine = False
        self._circuit_open = False
        self.degraded = False            # set by the engine (ladder > 0)
        # the straggler signal a fleet router's outlier detector sets and
        # clears: an overlay on the states, not a state (a slow engine
        # stays routable, deprioritised)
        self.slow = False
        self.slow_reason: Optional[str] = None
        self.last_fault: Optional[str] = None

    # ------------------------------------------------------------- state
    @property
    def state(self) -> str:
        if self._circuit_open:
            return CIRCUIT_OPEN
        if self._in_quarantine:
            return QUARANTINED
        if self.degraded or self.consecutive_faults > 0:
            return DEGRADED
        return HEALTHY

    @property
    def state_code(self) -> int:
        return STATE_CODES[self.state]

    @property
    def circuit_open(self) -> bool:
        return self._circuit_open

    @property
    def routable(self) -> bool:
        """May a router hand this engine new work?  Not while quarantined
        (mid-rebuild) or circuit-open (terminal); a degraded engine stays
        routable."""
        return not (self._in_quarantine or self._circuit_open)

    # ------------------------------------------------------------- steps
    def on_step_ok(self) -> None:
        self.step_index += 1
        self.consecutive_faults = 0

    def record_step_fault(self, reason: str) -> Optional[float]:
        """One core-step fault.  Returns the backoff to sleep before the
        next retry, or None when the retry budget is spent and the caller
        must quarantine."""
        self.step_index += 1
        self.last_fault = reason
        self.consecutive_faults += 1
        n = self.consecutive_faults
        if n > self.cfg.max_step_retries:
            return None
        return min(self.cfg.backoff_base_s * (2 ** (n - 1)),
                   self.cfg.backoff_cap_s)

    def mark_slow(self, reason: str) -> None:
        """Stamp the straggler signal (the router's detector decides)."""
        self.slow = True
        self.slow_reason = reason

    def clear_slow(self) -> None:
        """The straggler recovered."""
        self.slow = False
        self.slow_reason = None

    def mark_dead(self, reason: str) -> None:
        """Pin this engine terminally dead (a router's killed replica): an
        opened circuit, so it is never routable again, ``submit`` rejects
        with ``circuit_open`` and ``step`` does nothing."""
        self._circuit_open = True
        self.last_fault = reason

    # -------------------------------------------------------- quarantine
    def enter_quarantine(self, reason: str) -> _QuarantineToken:
        """Open a quarantine window (a rebuild in progress); close it with
        :meth:`leave_quarantine` in a ``finally``."""
        self._in_quarantine = True
        self.quarantine_count += 1
        self._quarantine_steps.append(self.step_index)
        q = self._quarantine_steps
        if len(q) >= self.cfg.circuit_quarantine_limit \
                and q[-1] - q[0] <= self.cfg.circuit_window_steps:
            self._circuit_open = True
        return _QuarantineToken(reason, time.perf_counter())

    def leave_quarantine(self, token: _QuarantineToken) -> float:
        """Close the window; returns its duration in seconds."""
        self._in_quarantine = False
        self.consecutive_faults = 0
        return time.perf_counter() - token.t0
