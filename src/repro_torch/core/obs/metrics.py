"""The metrics registry: counters, gauges, fixed-bucket histograms.

The ledger's outcome counts, the caches' hits, the shared oracles'
tallies and ``DSEService``'s queue stats all live behind one *pull*
interface:

    reg = MetricsRegistry()
    reg.counter("oracle.points.fresh").inc()
    reg.histogram("service.latency_s").observe(wall)
    reg.snapshot()        # -> one deterministic JSON-able dict

Every instrument is internally locked, so incrementing from a worker
thread and snapshotting from the service thread is always consistent;
classes that expose bare-int counter names keep them as properties over
registry counters (lock-consistent by construction).

Instruments are create-on-first-use and name-unique: asking for the
same name with a different type (or different histogram buckets) is a
programming error and raises.  ``DSEService.stats()`` embeds the
snapshot.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "LATENCY_BUCKETS_S",
]

#: default fixed buckets for latency histograms, in seconds (upper
#: bounds; observations above the last edge land in "+Inf")
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0)


class Counter:
    """A monotonically increasing count (lock-protected)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> int:
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def snapshot(self) -> int:
        return self.value


class Gauge:
    """A point-in-time value (queue depth, running queries)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, delta: float) -> float:
        with self._lock:
            self._value += delta
            return self._value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Fixed-bucket distribution: cumulative-style bucket counts plus
    ``count``/``sum`` (enough for rates and coarse percentiles without
    keeping observations)."""

    __slots__ = ("name", "buckets", "_counts", "_count", "_sum", "_lock")

    def __init__(self, name: str,
                 buckets: Sequence[float] = LATENCY_BUCKETS_S):
        edges = tuple(float(b) for b in buckets)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(f"histogram {name!r}: bucket edges must be "
                             f"non-empty, unique, and ascending: {buckets}")
        self.name = name
        self.buckets = edges
        self._counts = [0] * (len(edges) + 1)      # +1 = overflow (+Inf)
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = len(self.buckets)
        for j, edge in enumerate(self.buckets):
            if value <= edge:
                i = j
                break
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += value

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self._counts)
            count, total = self._count, self._sum
        out: Dict[str, Any] = {"count": count, "sum": round(total, 6)}
        buckets: Dict[str, int] = {}
        for edge, n in zip(self.buckets, counts):
            buckets[f"le_{edge:g}"] = n
        buckets["le_inf"] = counts[-1]
        out["buckets"] = buckets
        return out


class MetricsRegistry:
    """Name -> instrument, create-on-first-use, one snapshot call.

    A name is permanently bound to its first-requested type (and, for
    histograms, bucket edges): a mismatch raises rather than silently
    splitting a metric in two.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, Any] = {}

    def _get(self, name: str, cls, factory):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = factory()
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(inst).__name__}, "
                    f"requested as {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name))

    def histogram(self, name: str,
                  buckets: Sequence[float] = LATENCY_BUCKETS_S
                  ) -> Histogram:
        hist = self._get(name, Histogram, lambda: Histogram(name, buckets))
        if hist.buckets != tuple(float(b) for b in buckets):
            raise ValueError(f"histogram {name!r} already registered with "
                             f"buckets {hist.buckets}")
        return hist

    def names(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._instruments))

    def snapshot(self) -> Dict[str, Any]:
        """Every instrument's current value, sorted by name — the pull
        interface ``DSEService.stats()`` (and the benches) read."""
        with self._lock:
            items = sorted(self._instruments.items())
        return {name: inst.snapshot() for name, inst in items}
