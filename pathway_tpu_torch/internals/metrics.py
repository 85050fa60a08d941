"""Metric primitives: counters, gauges, fixed-bucket histograms and the registry that
names them.

Counterpart of the primitives of ``pathway_tpu/internals/metrics.py`` (``Counter``,
``Gauge``, ``Histogram``, ``Registry`` and the process-wide ``REGISTRY``): the
scheduler's probe sets ``pathway_queue_depth`` here, and the async device pipeline
keeps its queue depth, occupancy, dispatch-to-completion latency and commit count
here. Instrument handles are made once, under the registry's lock, and cached by the
call site; a bump is a plain attribute add. The snapshots, the Prometheus exposition,
the flight recorder, the request log and the pull collectors are not ported yet
(ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Any, Iterable

DEFAULT_LATENCY_BUCKETS = (
    0.001,
    0.0025,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
    5.0,
    10.0,
)


class Counter:
    """Monotonic counter; ``inc`` is a bare attribute add."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Point-in-time value; ``set`` is a bare attribute store."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram: ``len(bounds) + 1`` per-bucket counts (the last one is
    +Inf), a running sum and a total count. ``observe`` is a bisect plus three adds."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Iterable[float]) -> None:
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly increasing")
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (0 when empty)."""
        if self.count <= 0:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= target and c > 0:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
                frac = (target - seen) / c
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
            seen += c
        return self.bounds[-1]


class Registry:
    """Named metric families, each a set of label-addressed series. Handle creation
    takes the lock; the returned instrument is meant to be cached by the call site."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: name -> (kind, {sorted label items: instrument})
        self._families: dict[str, tuple[str, dict[tuple, Any]]] = {}  # guarded-by: self._lock

    def _series(self, name: str, kind: str, labels: dict, factory) -> Any:
        key = tuple(sorted(labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = (kind, {})
            elif fam[0] != kind:
                raise ValueError(f"metric {name!r} already registered as {fam[0]}")
            inst = fam[1].get(key)
            if inst is None:
                inst = fam[1][key] = factory()
            return inst

    def counter(self, name: str, help: str = "", **labels: str) -> Counter:
        return self._series(name, "counter", labels, Counter)

    def gauge(self, name: str, help: str = "", **labels: str) -> Gauge:
        return self._series(name, "gauge", labels, Gauge)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS,
        **labels: str,
    ) -> Histogram:
        buckets = tuple(float(b) for b in buckets)
        return self._series(name, "histogram", labels, lambda: Histogram(buckets))


#: the process-wide registry every instrumented layer reports into
REGISTRY = Registry()
