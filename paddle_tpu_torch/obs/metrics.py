"""Metrics registry: counters, gauges, log-bucketed histograms.

The port's own copy of paddle_tpu/obs/metrics.py (pure host code, so the
copy is verbatim apart from this header): the process-local instrument
store the serving engine records into.  Three design rules:

  * **pure host** — this module never imports torch and never touches a
    device tensor; every update is a few dict/list operations on Python
    numbers the caller already holds (the engine's single per-step token
    readback stays the only device sync);
  * **bounded memory** — histograms hold a FIXED bucket array sized at
    construction; counters keep a bounded ring of recent increments for
    windowed rates; nothing grows with request count;
  * **cheap quantiles** — log-spaced buckets (default 10 per decade, so
    adjacent bucket edges differ by ~26%) with within-bucket linear
    interpolation and clamping to the observed min/max give p50/p90/p99
    estimates good to a few percent on smooth latency distributions
    without storing samples.

Exports: ``MetricsRegistry.snapshot()`` (plain JSON-able dict) and
``MetricsRegistry.prometheus()`` (Prometheus text exposition v0.0.4 —
histograms emit cumulative ``_bucket{le=...}`` series plus ``_sum`` /
``_count``).

Instances are not thread-safe by design: each engine/trainer owns its
registry and records from its own step loop (the CPython ops used here
are atomic enough for read-side scraping from another thread).
"""

from __future__ import annotations

import bisect
import math
import re
import time
from collections import deque
from typing import Dict, List, Optional, Union

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]

# bounded history backing Counter.rate(); 512 marks cover any window the
# per-step increment cadence produces before the window itself ages out
_RATE_MARKS = 512


class Counter:
    """Monotonic event counter with a bounded increment ring so callers
    can ask for a trailing-window rate without any background thread."""

    __slots__ = ("name", "help", "unit", "_value", "_marks")

    def __init__(self, name: str, help: str = "", unit: str = ""):
        self.name = name
        self.help = help
        self.unit = unit
        self._value = 0
        self._marks = deque(maxlen=_RATE_MARKS)   # (perf_counter t, n)

    def inc(self, n: int = 1) -> None:
        self._value += n
        self._marks.append((time.perf_counter(), n))

    @property
    def value(self) -> int:
        return self._value

    def rate(self, window_s: float = 60.0,
             now: Optional[float] = None) -> float:
        """Increments/sec over the trailing ``window_s`` (perf_counter
        base).  Bounded by the mark ring: a counter bumped more than
        ``_RATE_MARKS`` times inside the window under-reports — windowed
        rates are an operator signal, not an accounting invariant."""
        if now is None:
            now = time.perf_counter()
        lo = now - window_s
        total = sum(n for t, n in self._marks if t >= lo)
        return total / window_s if window_s > 0 else 0.0

    def reset(self) -> None:
        self._value = 0
        self._marks.clear()

    def snapshot(self) -> int:
        return self._value


class Gauge:
    """Last-value-wins instrument (queue depth, slot occupancy)."""

    __slots__ = ("name", "help", "unit", "_value")

    def __init__(self, name: str, help: str = "", unit: str = ""):
        self.name = name
        self.help = help
        self.unit = unit
        self._value: float = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = 0.0

    def snapshot(self) -> float:
        return self._value


class Histogram:
    """Log-bucketed histogram with quantile estimation.

    Buckets are fixed at construction: ``per_decade`` log-spaced edges
    from ``lo`` to ``hi`` plus one overflow bucket; values at or below
    ``lo`` land in the first bucket, values past ``hi`` in the overflow.
    ``quantile(q)`` interpolates linearly inside the owning bucket and
    clamps to the observed min/max, so the estimate error is bounded by
    one bucket's width (~26% worst case at the default resolution,
    usually far less) and exact at the extremes.
    """

    __slots__ = ("name", "help", "unit", "bucket_params", "_edges",
                 "_counts", "_count", "_sum", "_min", "_max")

    def __init__(self, name: str, help: str = "", unit: str = "",
                 lo: float = 1e-5, hi: float = 1e3,
                 per_decade: int = 10):
        if not 0 < lo < hi:
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        if per_decade < 1:
            raise ValueError("per_decade must be >= 1")
        self.name = name
        self.help = help
        self.unit = unit
        self.bucket_params = (lo, hi, per_decade)
        n = int(math.ceil(per_decade * math.log10(hi / lo))) + 1
        self._edges: List[float] = [lo * 10 ** (i / per_decade)
                                    for i in range(n)]
        self._counts: List[int] = [0] * (n + 1)      # +1 = overflow
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self._counts[bisect.bisect_left(self._edges, v)] += 1
        self._count += 1
        self._sum += v
        if self._min is None or v < self._min:
            self._min = v
        if self._max is None or v > self._max:
            self._max = v

    # ------------------------------------------------------------ reads
    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> Optional[float]:
        return self._sum / self._count if self._count else None

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (q in [0, 1]); None while empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must lie in [0, 1], got {q}")
        if self._count == 0:
            return None
        target = q * self._count
        cum = 0.0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self._edges[i - 1] if i > 0 else min(
                    self._min if self._min is not None else 0.0,
                    self._edges[0])
                hi = self._edges[i] if i < len(self._edges) else (
                    self._max if self._max is not None else self._edges[-1])
                frac = (target - cum) / c
                val = lo + frac * (hi - lo)
                return min(max(val, self._min), self._max)
            cum += c
        return self._max

    def reset(self) -> None:
        self._counts = [0] * len(self._counts)
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None

    def snapshot(self) -> Dict[str, Optional[float]]:
        return {
            "count": self._count,
            "sum": self._sum,
            "mean": self.mean,
            "min": self._min,
            "max": self._max,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }


_Instrument = Union[Counter, Gauge, Histogram]


def _prom_name(name: str) -> str:
    """Dotted metric names -> Prometheus-legal (``serving.ttft_s`` ->
    ``serving_ttft_s``)."""
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


class MetricsRegistry:
    """Name -> instrument store with get-or-create accessors.

    ``counter()``/``gauge()``/``histogram()`` return the existing
    instrument when the name is already registered (so hot loops can
    call them without caching handles, though caching is cheaper) and
    raise ``TypeError`` when the name is bound to a different kind.
    """

    def __init__(self):
        self._metrics: Dict[str, _Instrument] = {}

    def _get_or_create(self, cls, name: str, args) -> _Instrument:
        inst = self._metrics.get(name)
        if inst is None:
            inst = cls(name, *args)
            self._metrics[name] = inst
        elif type(inst) is not cls:
            raise TypeError(
                f"metric {name!r} is already registered as "
                f"{type(inst).__name__}, not {cls.__name__}")
        return inst

    def counter(self, name: str, help: str = "", unit: str = "") -> Counter:
        return self._get_or_create(Counter, name, (help, unit))

    def gauge(self, name: str, help: str = "", unit: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, (help, unit))

    def histogram(self, name: str, help: str = "", unit: str = "",
                  lo: float = 1e-5, hi: float = 1e3,
                  per_decade: int = 10) -> Histogram:
        inst = self._get_or_create(Histogram, name,
                                   (help, unit, lo, hi, per_decade))
        if inst.bucket_params != (lo, hi, per_decade):
            # buckets are fixed at creation — silently returning the
            # existing instrument would drop the caller's range and
            # degrade its quantiles with no error (use get() to fetch
            # an existing histogram without restating its buckets)
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"(lo, hi, per_decade)={inst.bucket_params}, "
                f"conflicting with {(lo, hi, per_decade)}")
        return inst

    def get(self, name: str) -> Optional[_Instrument]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def reset(self) -> None:
        """Zero every instrument; definitions (names, buckets) persist."""
        for m in self._metrics.values():
            m.reset()

    # --------------------------------------------------------- exports
    def snapshot(self) -> Dict[str, object]:
        """Plain JSON-able dict: counters/gauges -> number, histograms
        -> {count, sum, mean, min, max, p50, p90, p99}."""
        return {name: self._metrics[name].snapshot()
                for name in sorted(self._metrics)}

    def prometheus(self) -> str:
        """Prometheus text exposition (v0.0.4) of every instrument."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            pname = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pname} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {m.value}")
            else:
                lines.append(f"# TYPE {pname} histogram")
                cum = 0
                for edge, c in zip(m._edges, m._counts):
                    cum += c
                    lines.append(f'{pname}_bucket{{le="{edge:.6g}"}} {cum}')
                cum += m._counts[-1]
                lines.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{pname}_sum {m.sum:.9g}")
                lines.append(f"{pname}_count {m.count}")
        return "\n".join(lines) + "\n"
