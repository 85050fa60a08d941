"""Metric primitives: counters, gauges, fixed-bucket histograms and the registry that
names them.

Counterpart of the primitives of ``pathway_tpu/internals/metrics.py`` (``Counter``,
``Gauge``, ``Histogram``, ``Registry`` and the process-wide ``REGISTRY``): the
scheduler's probe sets ``pathway_queue_depth`` here, and the async device pipeline
keeps its queue depth, occupancy, dispatch-to-completion latency and commit count
here. Instrument handles are made once, under the registry's lock, and cached by the
call site; a bump is a plain attribute add. The residency plane's event counters are a
:class:`MirroredCounterDict`. Pull collectors (:meth:`Registry.register_collector`, read
by :meth:`Registry.collect`) report the C++ host kernels' calls and nanoseconds
(``pathway_native_kernel_hits_total``, ``pathway_native_kernel_ns_total``), the
optimizer's counters and the device operators' launches, times and placement
(``pathway_device_ops_placement``, 1 = card, 0 = host).
The snapshots, the Prometheus exposition, the flight recorder and the request log are
not ported yet (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Any, Callable, Iterable

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
        self._collectors: list[Callable[[], Iterable[tuple]]] = []  # guarded-by: self._lock

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

    # -- pull collectors --------------------------------------------------------

    def register_collector(self, fn: Callable[[], Iterable[tuple]]) -> None:
        """``fn`` yields ``(name, kind, help, labels_dict, value)`` sample tuples when
        the registry is read."""
        with self._lock:
            self._collectors.append(fn)

    def collect(self) -> list[tuple]:
        """Every registered collector's samples, in registration order."""
        with self._lock:
            collectors = list(self._collectors)
        out: list[tuple] = []
        for fn in collectors:
            out.extend(fn())
        return out


#: the process-wide registry every instrumented layer reports into
REGISTRY = Registry()


class MirroredCounterDict(dict):
    """A plain dict whose integer writes mirror into a labelled counter family: call
    sites write ``d[key] += 1`` (or ``d[key] = 0`` to reset), i.e. ``__setitem__`` with
    the new total, so the mirror sets the counter's value and the dict stays the
    authoritative alias."""

    def __init__(self, metric: str, label: str, initial: dict, help: str = "") -> None:
        super().__init__(initial)
        self._metric = metric
        self._label = label
        self._help = help
        self._series: dict[Any, Counter] = {}
        for key, value in initial.items():
            self[key] = value

    def __setitem__(self, key, value) -> None:
        dict.__setitem__(self, key, value)
        c = self._series.get(key)
        if c is None:
            c = REGISTRY.counter(self._metric, self._help, **{self._label: str(key)})
            self._series[key] = c
        c.value = float(value)


# -- built-in pull collectors (imports deferred to read time) ---------------------------


def _native_collector() -> list[tuple]:
    """The C++ host kernels' calls and cumulative nanoseconds, per kernel (none before
    the kernels are first built: reading the registry builds nothing)."""
    from pathway_tpu_torch import native

    out = []
    for kernel, hits in native.hit_counts().items():
        out.append((
            "pathway_native_kernel_hits_total",
            "counter",
            "C++ kernel engagements (native.hit_counts)",
            {"kernel": kernel},
            hits,
        ))
    for kernel, ns in native.kernel_ns().items():
        out.append((
            "pathway_native_kernel_ns_total",
            "counter",
            "cumulative nanoseconds inside each C++ kernel",
            {"kernel": kernel},
            ns,
        ))
    return out


def _optimizer_collector() -> list[tuple]:
    from pathway_tpu_torch.optimize import optimizer_stats

    return [
        (
            f"pathway_optimizer_{key}",
            "gauge",
            "graph-rewriter counter from the most recent optimize run",
            {},
            value,
        )
        for key, value in optimizer_stats().items()
    ]


def _device_ops_collector() -> list[tuple]:
    """The device operators' launch and ns counters, and the placement policy's
    current decision per operator (1 = card, 0 = host)."""
    from pathway_tpu_torch.engine import device_ops
    from pathway_tpu_torch.optimize import placement

    out = []
    for kernel, hits in device_ops.hit_counts().items():
        out.append((
            "pathway_device_ops_kernel_hits_total",
            "counter",
            "device operator calls (device_ops.hit_counts)",
            {"kernel": kernel},
            hits,
        ))
    for kernel, ns in device_ops.kernel_ns().items():
        out.append((
            "pathway_device_ops_kernel_ns_total",
            "counter",
            "cumulative host-observed nanoseconds per device operator",
            {"kernel": kernel},
            ns,
        ))
    for op, st in placement.POLICY.decisions().items():
        out.append((
            "pathway_device_ops_placement",
            "gauge",
            "current operator placement (1 = device, 0 = host)",
            {"op": op},
            1 if st["device"] else 0,
        ))
    return out


REGISTRY.register_collector(_native_collector)
REGISTRY.register_collector(_optimizer_collector)
REGISTRY.register_collector(_device_ops_collector)
