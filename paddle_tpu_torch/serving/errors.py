"""Serving robustness exceptions: loud, typed, diagnosis-carrying (the
port's own copy of paddle_tpu/serving/errors.py).

The contract is that
no request ever ends ambiguously and no failure mode spins silently —
these exception types are the loud half of that contract.  Validation
errors at ``submit()`` stay plain ``ValueError``s (caller bugs);
capacity/SLO/circuit rejections raise :class:`RequestRejected`
(backpressure, carrying the retry hint); a wedged step loop raises
:class:`EngineStalledError` (engine bug or unrecoverable fault, carrying
the diagnostic snapshot).
"""

from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["RequestRejected", "EngineStalledError"]


class RequestRejected(RuntimeError):
    """``submit()`` refused the request — backpressure, not failure.

    ``reason`` is ``"queue_full"`` (the bounded submit queue is at
    ``max_queue``), ``"slo_unattainable"`` (projected TTFT already
    exceeds the request's ``ttft_deadline_s`` at submit time) or
    ``"circuit_open"`` (the watchdog's circuit breaker tripped: the
    engine fails fast until an operator replaces it).
    ``retry_after_s`` is the live-metrics-derived hint, always finite
    and clamped (``serving.metrics.MAX_RETRY_AFTER_S``; None when the
    engine has no throughput history yet, and for ``circuit_open``).  ``output`` is the terminal
    :class:`~paddle_tpu_torch.serving.api.RequestOutput` view with
    ``status="rejected"`` so callers that log every request still see an
    unambiguous terminal record.

    ``per_replica`` (a fleet rejection where every eligible replica
    refused) carries each replica's own rejection, a list of
    ``{"replica", "reason", "retry_after_s"}`` dicts in try order.
    """

    def __init__(self, reason: str, retry_after_s: Optional[float] = None,
                 output=None,
                 per_replica: Optional[List[Dict[str, object]]] = None):
        hint = "" if retry_after_s is None \
            else f" (retry after ~{retry_after_s:.3f}s)"
        super().__init__(f"request rejected: {reason}{hint}")
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.output = output
        self.per_replica = per_replica


class EngineStalledError(RuntimeError):
    """``run_until_complete`` detected a no-progress stall: N consecutive
    steps emitted no token, admitted no request and ran no prefill chunk
    while work was still queued.  Carries a host-state snapshot (queue
    depth, free slots/blocks, per-slot positions) so the
    wedge is diagnosable from the exception alone instead of from a
    spinning process."""

    def __init__(self, stall_steps: int, snapshot: Dict[str, object]):
        lines = ", ".join(f"{k}={v}" for k, v in snapshot.items())
        super().__init__(
            f"engine made no progress for {stall_steps} consecutive "
            f"steps with work queued — {lines}")
        self.stall_steps = stall_steps
        self.snapshot = dict(snapshot)
