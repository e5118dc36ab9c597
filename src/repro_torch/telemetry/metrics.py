"""The unified metrics plane: counters, gauges, histograms — one registry.

Before this module, the platform's numbers lived in ad-hoc places: the
object store bumped ``StoreStats`` fields, the executor kept a private
latency list per function fingerprint, the warm cache counted cold
starts on its own dataclass.  The registry absorbs them behind one
interface without breaking any of those call sites: ``StoreStats.bump``
forwards every delta here when a registry is attached
(``attach_metrics``), and the executor observes task durations into a
histogram next to its speculation baselines.

Instruments are cheap, thread-safe and allocation-light on the hot path
(one small lock per instrument); ``snapshot()`` is the single read
surface the CLI/benchmarks/tests consume.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Deque, Dict, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """Monotonically increasing count (events, bytes, retries...)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """A point-in-time level (queue depth, in-flight stages...)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, delta: float) -> None:
        with self._lock:
            self._value += delta

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Streaming distribution: exact count/sum/min/max plus percentile
    estimates over a bounded reservoir of the most recent observations
    (the same shape as the executor's bounded latency history)."""

    __slots__ = ("name", "_count", "_sum", "_min", "_max", "_recent", "_lock")

    def __init__(self, name: str, *, reservoir: int = 512):
        self.name = name
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._recent: Deque[float] = deque(maxlen=reservoir)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)
            self._recent.append(v)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            if self._count == 0:
                return {"count": 0, "sum": 0.0}
            recent = sorted(self._recent)
            return {
                "count": self._count,
                "sum": self._sum,
                "mean": self._sum / self._count,
                "min": self._min,
                "max": self._max,
                "p50": recent[len(recent) // 2],
                "p95": recent[min(len(recent) - 1, int(len(recent) * 0.95))],
            }


class MetricsRegistry:
    """Name -> instrument, created on first touch (no registration step).

    Dotted names namespace by component: ``store.puts``,
    ``executor.task_duration_s``, ``query.shards_read`` — one flat
    snapshot, greppable like the rest of the system.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            inst = self._counters.get(name)
            if inst is None:
                inst = self._counters[name] = Counter(name)
            return inst

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            inst = self._gauges.get(name)
            if inst is None:
                inst = self._gauges[name] = Gauge(name)
            return inst

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            inst = self._histograms.get(name)
            if inst is None:
                inst = self._histograms[name] = Histogram(name)
            return inst

    def snapshot(self) -> Dict[str, Any]:
        """Every instrument's current value, one JSON-able dict."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {n: c.value for n, c in sorted(counters.items())},
            "gauges": {n: g.value for n, g in sorted(gauges.items())},
            "histograms": {
                n: h.summary() for n, h in sorted(histograms.items())
            },
        }
