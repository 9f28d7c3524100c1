"""Metrics registry: counters, gauges, histograms — and a no-op default.

Design constraints, in priority order:

1. **Zero cost when nobody is collecting.**  The hot paths (QRServer flush,
   the blocked driver, kernel wrappers) are instrumented unconditionally;
   the default registry is ``NULL`` whose ``enabled`` is False and whose
   metric handles are shared no-op singletons.  Instrumentation sites guard
   expensive work (``block_until_ready``, flop models, host transfers) on
   ``registry.enabled`` — a single attribute read — so the uninstrumented
   throughput stays within noise of pre-instrumentation.
2. **No dependencies.**  Pure stdlib; exporters (``repro_torch.obs.export``) turn
   the same objects into JSONL snapshots and Prometheus text exposition.
3. **Label-aware.**  A metric *family* is a name ("serve.queue_wait_seconds");
   a *series* is a (name, labels) pair.  ``registry.histogram(name, **labels)``
   returns the series handle, creating it on first use.

Histograms store every observation (serving flushes observe O(groups) values
per flush, not O(requests) — bounded, and exact quantiles beat bucket
interpolation for the bench-sized runs this instruments).  ``Histogram.buckets``
lazily derives cumulative bucket counts for Prometheus exposition.
"""
from __future__ import annotations

import math
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullRegistry",
    "NULL",
    "DEFAULT_BUCKETS",
]

# Prometheus-style cumulative bucket upper bounds; spans microseconds (a
# single fused kernel dispatch) through minutes (a cold compile).
DEFAULT_BUCKETS = (
    1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0, 120.0,
)


class Counter:
    """Monotone event count.  ``inc()`` only accepts non-negative deltas."""

    kind = "counter"
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, delta: float = 1.0) -> None:
        if delta < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({delta})")
        self.value += delta


class Gauge:
    """Last-written value, plus the min/max seen (condition proxies care
    about the excursion, not just the latest sample)."""

    kind = "gauge"
    __slots__ = ("name", "labels", "value", "min", "max", "updates")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = math.nan
        self.min = math.inf
        self.max = -math.inf
        self.updates = 0

    def set(self, value: float) -> None:
        v = float(value)
        self.value = v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self.updates += 1


class Histogram:
    """Exact-quantile histogram over all observed values."""

    kind = "histogram"
    __slots__ = ("name", "labels", "values", "sum")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.values: list[float] = []
        self.sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.values.append(v)
        self.sum += v

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def min(self) -> float:
        return min(self.values) if self.values else math.nan

    @property
    def max(self) -> float:
        return max(self.values) if self.values else math.nan

    def quantile(self, q: float) -> float:
        """Exact q-quantile (linear interpolation between order statistics)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if not self.values:
            return math.nan
        xs = sorted(self.values)
        pos = q * (len(xs) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def buckets(self, bounds=DEFAULT_BUCKETS):
        """Cumulative (le, count) pairs for Prometheus exposition; the final
        +Inf bucket always equals ``count``."""
        out = []
        for le in bounds:
            out.append((le, sum(1 for v in self.values if v <= le)))
        out.append((math.inf, len(self.values)))
        return out


_METRIC_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """A collecting registry: get-or-create metric series by (name, labels).

    Creation is locked (serving may grow per-kind series from helper threads);
    updates on the returned handles are plain attribute writes — the GIL is
    enough for the float/list mutations they do.
    """

    enabled = True

    def __init__(self):
        self._metrics: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: dict):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, key[1])
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name: str, /, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, /, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, /, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def collect(self):
        """All series, sorted by (name, labels) for stable exports."""
        return [self._metrics[k] for k in sorted(self._metrics)]

    def families(self) -> set[str]:
        return {m.name for m in self._metrics.values()}

    def find(self, name: str, /, **labels):
        """The series for (name, labels), or None — test/assertion helper."""
        return self._metrics.get((name, _label_key(labels)))


class _NullMetric:
    """Shared do-nothing handle; every mutator is a no-op, every stat NaN."""

    __slots__ = ()
    kind = "null"
    name = ""
    labels = ()
    value = math.nan
    sum = 0.0
    count = 0

    def inc(self, delta: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def quantile(self, q: float) -> float:
        return math.nan


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """The default registry: nothing is recorded, nothing is allocated."""

    enabled = False

    def counter(self, name: str, /, **labels) -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str, /, **labels) -> _NullMetric:
        return _NULL_METRIC

    def histogram(self, name: str, /, **labels) -> _NullMetric:
        return _NULL_METRIC

    def collect(self):
        return []

    def families(self) -> set[str]:
        return set()

    def find(self, name: str, /, **labels):
        return None


NULL = NullRegistry()
