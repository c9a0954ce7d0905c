"""Telemetry: metrics registry + request-lifecycle tracing (the port's
own copy of paddle_tpu/obs; pure host code, no device work)."""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .tracing import Span, Tracer

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "Span", "Tracer"]
