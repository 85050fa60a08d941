"""Metrics history ring + SLO sentinel: the trend side of the metrics plane.

Counterpart of ``pathway_tpu/internals/timeseries.py``, with the same names, env vars
(``PATHWAY_TPU_TIMESERIES``, ``PATHWAY_TPU_SLO``, ``PATHWAY_TPU_TS_INTERVAL``,
``PATHWAY_TPU_TS_MAX_SERIES``), ring sizes, flight events and families. The registry
(``internals/metrics.py``) is point-in-time; this module keeps a bounded, down-sampling
history of every registry family:

- :class:`TimeSeriesStore` — per-series tiered rings (raw → 1s → 10s), each tier a
  fixed-length deque, plus a global series-count cap, so total memory is a hard
  constant regardless of run length or label cardinality. Histogram families are
  stored as derived scalar tracks (``stat`` label: count / sum / p50 / p95 / p99).
- :class:`TelemetryLoop` — the daemon recorder (thread ``pathway-timeseries``): every
  tick it snapshots the local registry (with the scheduler's operator series) into the
  store under a ``worker`` label, plus every mesh snapshot the monitor holds, and runs
  the sentinel. Served as ``/timeseries?family=...&window=...`` on the monitoring port.
- :class:`SloSentinel` — declarative SLOs (latency burn rate, queue-depth ceiling,
  staleness bound, throughput floor) evaluated against the ring; every evaluation sets
  the ``pathway_slo_burn_ratio`` gauge and a breach crossing records one ``slo_burn``
  flight event and bumps ``pathway_slo_breaches_total``.

The loop keeps the first exception a tick raises (a card error read by a pull
collector, say), stops ticking, and :meth:`TelemetryLoop.stop` (so ``stop_loop``, which
``pw.run`` calls) raises it on the caller's thread; the JAX package swallows it and
ticks on (ROADMAP: deliberate differences). The read tier's replica snapshots, which
the JAX package's tick reads from the serving stream server, wait for the serving
tier (ROADMAP queue 1 item 8); :meth:`TimeSeriesStore.ingest_read_tier` is ported whole
but has no caller until then. :meth:`TimeSeriesStore.prune_workers` is called by the
mesh's recovery and rescale paths (``engine/distributed.py``, ``DistributedGraphRunner``),
and the tick keeps the mesh snapshots of workers inside the mesh's width.
"""

from __future__ import annotations

import json
import os
import threading
import time as _time
from collections import deque
from typing import Any, Iterable

from pathway_tpu_torch.internals import metrics as _metrics

__all__ = [
    "SeriesRing",
    "TimeSeriesStore",
    "SloSpec",
    "SloSentinel",
    "TelemetryLoop",
    "STORE",
    "SENTINEL",
    "loop_enabled",
    "start_loop",
    "stop_loop",
]

#: down-sampling tier periods, seconds (raw tier records every tick)
MID_PERIOD = 1.0
COARSE_PERIOD = 10.0

#: per-tier point caps — with the series cap these fix the memory
#: ceiling: MAX_SERIES * (RAW + MID + COARSE) points, ~3 floats each
RAW_POINTS = 240
MID_POINTS = 360
COARSE_POINTS = 360

_TRUTHY = ("1", "true", "yes")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


class SeriesRing:
    """One scalar series: three fixed-length tiers.  Every append lands
    in the raw tier; a point also promotes to the 1s / 10s tier when
    that tier's period has elapsed — so a window query older than the
    raw span still has (coarser) coverage."""

    __slots__ = ("raw", "mid", "coarse", "_last_mid", "_last_coarse")

    def __init__(
        self,
        raw_points: int = RAW_POINTS,
        mid_points: int = MID_POINTS,
        coarse_points: int = COARSE_POINTS,
    ) -> None:
        self.raw: deque = deque(maxlen=raw_points)
        self.mid: deque = deque(maxlen=mid_points)
        self.coarse: deque = deque(maxlen=coarse_points)
        self._last_mid = float("-inf")
        self._last_coarse = float("-inf")

    def append(self, t: float, v: float) -> None:
        self.raw.append((t, v))
        if t - self._last_mid >= MID_PERIOD:
            self.mid.append((t, v))
            self._last_mid = t
        if t - self._last_coarse >= COARSE_PERIOD:
            self.coarse.append((t, v))
            self._last_coarse = t

    def points(self, since: float) -> list[list[float]]:
        """Ascending ``[t, v]`` points covering ``since``..now: the
        coarse/mid tiers fill the span the raw ring has already
        evicted, deduplicated on timestamp (finest tier wins)."""
        raw = [p for p in self.raw if p[0] >= since]
        floor = raw[0][0] if raw else float("inf")
        merged = [p for p in self.coarse if since <= p[0] < floor]
        merged += [
            p
            for p in self.mid
            if since <= p[0] < floor
            and not any(abs(p[0] - q[0]) < 1e-9 for q in merged)
        ]
        merged.sort()
        return [[t, v] for t, v in merged + raw]

    def n_points(self) -> int:
        return len(self.raw) + len(self.mid) + len(self.coarse)

    def last(self) -> tuple[float, float] | None:
        return self.raw[-1] if self.raw else None


#: histogram-derived scalar tracks recorded per histogram series
_HIST_STATS = ("count", "sum", "p50", "p95", "p99")


def _hist_quantile_from_snapshot(
    bounds: list, counts: list, count: int, q: float
) -> float:
    """Bucket-interpolated quantile from a snapshot's per-bucket counts
    (same estimate as ``Histogram.quantile``, which operates on live
    instruments rather than snapshots)."""
    if count <= 0:
        return 0.0
    target = q * count
    seen = 0
    for i, c in enumerate(counts):
        if seen + c >= target and c > 0:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else (bounds[-1] if bounds else 0.0)
            frac = (target - seen) / c
            return lo + (hi - lo) * min(1.0, max(0.0, frac))
        seen += c
    return bounds[-1] if bounds else 0.0


class TimeSeriesStore:
    """Bounded in-process time-series store over registry snapshots.

    Series are keyed by ``(family, sorted-label-items)`` — labels
    always include ``worker`` — and capped globally: once
    ``max_series`` distinct series exist, new ones are dropped (and
    counted) rather than grown, so the memory budget holds under label
    churn."""

    def __init__(self, max_series: int | None = None) -> None:
        if max_series is None:
            max_series = _env_int("PATHWAY_TPU_TS_MAX_SERIES", 1024)
        self.max_series = max(1, max_series)
        self._lock = threading.Lock()
        self._series: dict[tuple, SeriesRing] = {}  # guarded-by: self._lock
        self._kinds: dict[str, str] = {}  # guarded-by: self._lock
        self._dropped_series = 0  # guarded-by: self._lock

    # -- write side ----------------------------------------------------------

    def observe(
        self, family: str, labels: dict, value: float, t: float | None = None
    ) -> None:
        if t is None:
            t = _time.time()
        key = (family, tuple(sorted(labels.items())))
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                if len(self._series) >= self.max_series:
                    self._dropped_series += 1
                    return
                ring = self._series[key] = SeriesRing()
            ring.append(float(t), float(value))

    def ingest_snapshot(
        self, snap: dict, worker: str, t: float | None = None
    ) -> None:
        """Record one registry snapshot (``Registry.snapshot`` shape)
        under a ``worker`` label.  Scalars record as-is; histograms
        record their derived count/sum/quantile tracks."""
        if t is None:
            t = _time.time()
        for family, fam in snap.items():
            if family.startswith("__") or not isinstance(fam, dict):
                continue  # reserved piggyback keys are not families
            kind = fam.get("kind")
            series = fam.get("series")
            if kind is None or not isinstance(series, list):
                continue
            with self._lock:
                self._kinds.setdefault(family, kind)
            bounds = list(fam.get("buckets") or [])
            for entry in series:
                labels = dict(entry.get("labels") or {})
                labels["worker"] = worker
                if kind == "histogram":
                    counts = entry.get("counts") or []
                    count = int(entry.get("count", 0))
                    derived = {
                        "count": float(count),
                        "sum": float(entry.get("sum", 0.0)),
                        "p50": _hist_quantile_from_snapshot(
                            bounds, counts, count, 0.50
                        ),
                        "p95": _hist_quantile_from_snapshot(
                            bounds, counts, count, 0.95
                        ),
                        "p99": _hist_quantile_from_snapshot(
                            bounds, counts, count, 0.99
                        ),
                    }
                    for stat in _HIST_STATS:
                        self.observe(
                            family,
                            dict(labels, stat=stat),
                            derived[stat],
                            t,
                        )
                else:
                    self.observe(family, labels, entry.get("value", 0.0), t)

    def ingest_read_tier(
        self, snap: dict, worker: str, t: float | None = None
    ) -> None:
        """Derive the read-tier health families from one registry
        snapshot and record them under ``worker`` — the PR-19 read-path
        metrics reduced to the three numbers an operator watches:

        - ``pathway_read_cache_hit_rate`` — hits / (hits + misses) of
          the result cache (skipped until the first lookup);
        - ``pathway_read_federation_fanout_mean`` — mean backend
          requests per federated query (sum/count of the fan-out
          histogram);
        - ``pathway_read_replica_lag_seconds`` — freshest-cut age per
          replica, re-labelled so replica series prune with their
          ``r<id>`` worker label on disconnect.
        """
        if t is None:
            t = _time.time()
        derived: list[tuple[str, dict, float]] = []
        cache = snap.get("pathway_serving_cache_events_total")
        if isinstance(cache, dict):
            counts = {
                (entry.get("labels") or {}).get("kind"): float(
                    entry.get("value", 0.0)
                )
                for entry in cache.get("series") or []
            }
            total = counts.get("hit", 0.0) + counts.get("miss", 0.0)
            if total > 0:
                derived.append(
                    (
                        "pathway_read_cache_hit_rate",
                        {},
                        counts.get("hit", 0.0) / total,
                    )
                )
        fanout = snap.get("pathway_serving_federation_fanout")
        if isinstance(fanout, dict):
            for entry in fanout.get("series") or []:
                count = float(entry.get("count", 0.0))
                if count > 0:
                    derived.append(
                        (
                            "pathway_read_federation_fanout_mean",
                            dict(entry.get("labels") or {}),
                            float(entry.get("sum", 0.0)) / count,
                        )
                    )
        lag = snap.get("pathway_serving_replica_lag_seconds")
        if isinstance(lag, dict):
            for entry in lag.get("series") or []:
                derived.append(
                    (
                        "pathway_read_replica_lag_seconds",
                        dict(entry.get("labels") or {}),
                        float(entry.get("value", 0.0)),
                    )
                )
        if not derived:
            return
        with self._lock:
            for family, _labels, _value in derived:
                self._kinds.setdefault(family, "gauge")
        for family, labels, value in derived:
            labels["worker"] = worker
            self.observe(family, labels, value, t)

    def prune_workers(
        self, dead: Iterable[str] = (), width: int | None = None
    ) -> None:
        """Drop every series labelled with a dead ``worker`` — the
        timeseries twin of ``prune_mesh_metrics``, hooked from the
        same rescale/failover/recovery paths.  ``width`` additionally
        drops numeric worker ids beyond the current mesh width (a
        rescale that shrank the mesh leaves them as dead
        incarnations)."""
        gone = {str(w) for w in dead}
        if not gone and width is None:
            return
        with self._lock:
            for key in list(self._series):
                worker = dict(key[1]).get("worker")
                if worker in gone or (
                    width is not None
                    and isinstance(worker, str)
                    and worker.isdigit()
                    and int(worker) >= width
                ):
                    self._series.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            self._kinds.clear()
            self._dropped_series = 0

    # -- read side -----------------------------------------------------------

    def families(self) -> list[dict]:
        with self._lock:
            counts: dict[str, int] = {}
            for family, _labels in self._series:
                counts[family] = counts.get(family, 0) + 1
            return [
                {
                    "family": family,
                    "kind": self._kinds.get(family, "gauge"),
                    "series": n,
                }
                for family, n in sorted(counts.items())
            ]

    def query(
        self,
        family: str,
        window_s: float = 60.0,
        labels: dict | None = None,
        now: float | None = None,
    ) -> dict:
        """Windowed read: every series of ``family`` whose labels are a
        superset of ``labels``, each with its ascending ``[t, v]``
        points over the last ``window_s`` seconds — the shape
        ``/timeseries`` serves and the autoscaler loop will read."""
        if now is None:
            now = _time.time()
        since = now - max(0.0, float(window_s))
        want = {str(k): str(v) for k, v in (labels or {}).items()}
        out = []
        with self._lock:
            matches = [
                (key, ring)
                for key, ring in self._series.items()
                if key[0] == family
            ]
            kind = self._kinds.get(family, "gauge")
        for (fam, label_items), ring in sorted(matches):
            label_dict = dict(label_items)
            if any(str(label_dict.get(k)) != v for k, v in want.items()):
                continue
            pts = ring.points(since)
            out.append({"labels": label_dict, "points": pts})
        return {
            "family": family,
            "kind": kind,
            "window_s": float(window_s),
            "now": now,
            "series": out,
        }

    def stats(self) -> dict:
        """Bound accounting for tests and the ``/timeseries`` index:
        series/point totals plus the hard caps they stay under."""
        with self._lock:
            n_series = len(self._series)
            n_points = sum(r.n_points() for r in self._series.values())
            dropped = self._dropped_series
        return {
            "series": n_series,
            "points": n_points,
            "dropped_series": dropped,
            "max_series": self.max_series,
            "max_points": self.max_series
            * (RAW_POINTS + MID_POINTS + COARSE_POINTS),
        }


# -- SLO sentinel -------------------------------------------------------------

_SLO_KINDS = ("latency", "queue_depth", "staleness", "throughput")


class SloSpec:
    """One declarative SLO:

    - ``latency``: burn rate — the fraction of windowed quantile points
      above ``bound`` seconds, divided by the error ``budget`` fraction
      (burn > 1 means the budget is being spent too fast);
    - ``queue_depth``: ceiling — max windowed value over ``bound``;
    - ``staleness``: bound — last observed value over ``bound`` seconds;
    - ``throughput``: floor — ``bound`` rows/s over the windowed
      counter rate.

    Every kind normalizes to a burn ratio where > 1.0 is a violation.
    """

    __slots__ = (
        "name", "kind", "family", "labels", "bound", "window_s",
        "budget", "quantile",
    )

    def __init__(
        self,
        name: str,
        kind: str,
        family: str,
        bound: float,
        labels: dict | None = None,
        window_s: float = 60.0,
        budget: float = 0.1,
        quantile: str = "p99",
    ) -> None:
        if kind not in _SLO_KINDS:
            raise ValueError(f"slo {name!r}: unknown kind {kind!r}")
        if bound <= 0:
            raise ValueError(f"slo {name!r}: bound must be > 0")
        if quantile not in ("p50", "p95", "p99"):
            raise ValueError(f"slo {name!r}: unknown quantile {quantile!r}")
        self.name = name
        self.kind = kind
        self.family = family
        self.labels = dict(labels or {})
        self.bound = float(bound)
        self.window_s = float(window_s)
        self.budget = min(1.0, max(1e-6, float(budget)))
        self.quantile = quantile

    @classmethod
    def from_dict(cls, d: dict) -> "SloSpec":
        return cls(
            name=d["name"],
            kind=d["kind"],
            family=d["family"],
            bound=float(d["bound"]),
            labels=d.get("labels"),
            window_s=float(d.get("window_s", 60.0)),
            budget=float(d.get("budget", 0.1)),
            quantile=d.get("quantile", "p99"),
        )

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "family": self.family,
            "labels": dict(self.labels),
            "bound": self.bound,
            "window_s": self.window_s,
            "budget": self.budget,
            "quantile": self.quantile,
        }


class SloSentinel:
    """Evaluates SLO specs against the history ring; every evaluation
    sets ``pathway_slo_burn_ratio{slo=...}`` and a burn crossing
    (ratio rising through 1.0) records an ``slo_burn`` flight event and
    bumps ``pathway_slo_breaches_total`` — re-armed once the ratio
    falls back under 1.0, so a sustained violation is one event."""

    def __init__(self, specs: Iterable[SloSpec] = ()) -> None:
        self._lock = threading.Lock()
        self._specs: list[SloSpec] = list(specs)  # guarded-by: self._lock
        self._burning: set[str] = set()  # guarded-by: self._lock

    def configure(self, specs: Iterable[SloSpec] | None = None) -> int:
        """Install specs, or (re)load them from ``PATHWAY_TPU_SLO`` —
        inline JSON or a path to a JSON file holding a spec list.
        Returns the number of active specs."""
        if specs is None:
            raw = os.environ.get("PATHWAY_TPU_SLO", "").strip()
            loaded: list[SloSpec] = []
            if raw:
                try:
                    if not raw.lstrip().startswith(("[", "{")):
                        with open(raw, encoding="utf-8") as fh:
                            raw = fh.read()
                    data = json.loads(raw)
                    if isinstance(data, dict):
                        data = [data]
                    loaded = [SloSpec.from_dict(d) for d in data]
                except (OSError, ValueError, KeyError, TypeError) as exc:
                    _metrics.FLIGHT.record("slo_config_error", error=repr(exc))
            specs = loaded
        with self._lock:
            self._specs = list(specs)
            self._burning.clear()
            return len(self._specs)

    def specs(self) -> list[SloSpec]:
        with self._lock:
            return list(self._specs)

    def _measure(
        self, spec: SloSpec, store: TimeSeriesStore, now: float
    ) -> tuple[float, float] | None:
        """Returns ``(burn_ratio, measured)`` or None when the ring has
        no data for the spec yet (no data is not a violation)."""
        labels = dict(spec.labels)
        if spec.kind == "latency":
            labels.setdefault("stat", spec.quantile)
        result = store.query(spec.family, spec.window_s, labels, now=now)
        points = [p for s in result["series"] for p in s["points"]]
        if not points:
            return None
        points.sort()
        if spec.kind == "latency":
            violating = sum(1 for _t, v in points if v > spec.bound)
            frac = violating / len(points)
            return frac / spec.budget, max(v for _t, v in points)
        if spec.kind == "queue_depth":
            peak = max(v for _t, v in points)
            return peak / spec.bound, peak
        if spec.kind == "staleness":
            last = points[-1][1]
            return last / spec.bound, last
        # throughput floor: windowed counter rate (counters are
        # cumulative, so the rate is the endpoint delta over time)
        t0, v0 = points[0]
        t1, v1 = points[-1]
        if t1 - t0 < 1e-6:
            return None
        rate = max(0.0, (v1 - v0) / (t1 - t0))
        return spec.bound / max(rate, 1e-9), rate

    def evaluate(
        self, store: TimeSeriesStore, now: float | None = None
    ) -> list[dict]:
        """One evaluation pass; returns per-spec reports (for tests and
        the ``/timeseries`` index page)."""
        if now is None:
            now = _time.time()
        reports = []
        for spec in self.specs():
            measured = self._measure(spec, store, now)
            if measured is None:
                reports.append(
                    {"slo": spec.name, "burn": None, "measured": None}
                )
                continue
            burn, value = measured
            _metrics.REGISTRY.gauge(
                "pathway_slo_burn_ratio",
                "SLO burn ratio (> 1.0 = violating)",
                slo=spec.name,
            ).set(round(burn, 6))
            with self._lock:
                burning = spec.name in self._burning
                if burn > 1.0 and not burning:
                    self._burning.add(spec.name)
                    crossed = True
                elif burn <= 1.0 and burning:
                    self._burning.discard(spec.name)
                    crossed = False
                else:
                    crossed = False
            if crossed:
                _metrics.REGISTRY.counter(
                    "pathway_slo_breaches_total",
                    "SLO burn events recorded by the sentinel",
                    slo=spec.name,
                ).inc(1)
                _metrics.FLIGHT.record(
                    "slo_burn",
                    slo=spec.name,
                    slo_kind=spec.kind,
                    family=spec.family,
                    burn=round(burn, 6),
                    measured=round(value, 6),
                    bound=spec.bound,
                    window_s=spec.window_s,
                )
            reports.append(
                {
                    "slo": spec.name,
                    "kind": spec.kind,
                    "burn": round(burn, 6),
                    "measured": round(value, 6),
                    "bound": spec.bound,
                }
            )
        return reports


# -- the recorder loop --------------------------------------------------------


class TelemetryLoop:
    """Daemon thread recording registry snapshots into the store and
    running the sentinel — one per process, started by ``pw.run``
    alongside the monitoring HTTP server (or whenever
    ``PATHWAY_TPU_TIMESERIES=1`` / an SLO spec is configured)."""

    def __init__(
        self,
        store: TimeSeriesStore,
        sentinel: SloSentinel,
        monitor: Any = None,
        period_s: float | None = None,
    ) -> None:
        if period_s is None:
            period_s = _env_float("PATHWAY_TPU_TS_INTERVAL", 0.5)
        self.store = store
        self.sentinel = sentinel
        self.monitor = monitor
        self.period_s = max(0.05, period_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: the first exception a tick of the thread raised; ``stop`` raises it
        self.error: BaseException | None = None
        try:
            self.worker_id = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
        except ValueError:
            self.worker_id = 0

    def start(self) -> "TelemetryLoop":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="pathway-timeseries", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the thread, then one final pass, so a run shorter than the period
        still lands its last state in the ring (and the sentinel sees it). Raises the
        first exception a tick of the thread met, else the final pass's."""
        self._stop.set()
        thread = self._thread
        self._thread = None
        if thread is not None and thread.is_alive():
            thread.join(timeout=2.0)
        error, self.error = self.error, None
        if error is not None:
            raise error
        self.tick()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def tick(self, now: float | None = None) -> None:
        """One recording pass (the loop body; tests call it directly):
        local registry (plus scheduler operator series) under this
        worker's label, then every piggybacked mesh snapshot under its
        peer's label, then the sentinel. Raises what the snapshot raises."""
        if now is None:
            now = _time.time()
        scheduler = getattr(self.monitor, "scheduler", None)
        snap = _metrics.full_snapshot(scheduler)
        self.store.ingest_snapshot(snap, str(self.worker_id), t=now)
        self.store.ingest_read_tier(snap, str(self.worker_id), t=now)
        mesh = getattr(self.monitor, "mesh_snapshots", None) or {}
        width = getattr(scheduler, "n_processes", None)
        for peer, peer_snap in sorted(mesh.items()):
            if width is not None and int(peer) >= width:
                continue  # dead-incarnation filter, as prometheus_text
            if isinstance(peer_snap, dict):
                self.store.ingest_snapshot(peer_snap, str(peer), t=now)
        self.sentinel.evaluate(self.store, now=now)

    def _run(self) -> None:
        tick_hist = _metrics.REGISTRY.histogram(
            "pathway_timeseries_tick_seconds",
            "wall cost of one timeseries recording pass",
            buckets=(1e-4, 1e-3, 1e-2, 0.1, 1.0),
        )
        while not self._stop.wait(self.period_s):
            t0 = _time.perf_counter()
            try:
                self.tick()
            except Exception as exc:  # noqa: BLE001 — kept, raised by stop()
                self.error = exc
                return
            tick_hist.observe(_time.perf_counter() - t0)


#: process-wide store + sentinel (the /timeseries endpoint reads these)
STORE = TimeSeriesStore()
SENTINEL = SloSentinel()

_LOOP: TelemetryLoop | None = None
_LOOP_LOCK = threading.Lock()


def loop_enabled() -> bool:
    """True when the recorder should run even without a monitoring
    HTTP server: an explicit opt-in or a configured SLO spec."""
    return (
        os.environ.get("PATHWAY_TPU_TIMESERIES", "").lower() in _TRUTHY
        or bool(os.environ.get("PATHWAY_TPU_SLO", "").strip())
    )


def start_loop(monitor: Any = None) -> TelemetryLoop:
    """Start (or rebind) the process-wide recorder loop; idempotent."""
    global _LOOP
    if not SENTINEL.specs():
        SENTINEL.configure()  # pick up PATHWAY_TPU_SLO if set
    with _LOOP_LOCK:
        if _LOOP is None:
            _LOOP = TelemetryLoop(STORE, SENTINEL, monitor=monitor)
        else:
            _LOOP.monitor = monitor if monitor is not None else _LOOP.monitor
        return _LOOP.start()


def stop_loop() -> None:
    global _LOOP
    with _LOOP_LOCK:
        loop = _LOOP
        _LOOP = None
    if loop is not None:
        loop.stop()
