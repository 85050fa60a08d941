"""Unified metrics plane: registry, histograms, snapshots, flight recorder.

Counterpart of ``pathway_tpu/internals/metrics.py``, with the same names, families,
exposition text and flight-recorder events. One process-wide :data:`REGISTRY` holds
every counter, gauge and fixed-bucket histogram the engine's hot paths touch:

- **lock-cheap, allocation-free hot path**: instrument handles are made once, under the
  registry's lock, and cached by the call site; a bump is a plain attribute ``+=`` and a
  histogram observe is a ``bisect`` plus three adds;
- **snapshots**: :meth:`Registry.snapshot` returns a plain picklable, JSON-able dict;
  :func:`full_snapshot` adds a scheduler's per-operator series and
  :func:`render_snapshots` renders worker-keyed snapshots as one Prometheus exposition
  (``worker="<key>"`` labels), checked by :func:`validate_exposition`;
- **no engine imports**: ``engine/graph.py`` and friends import this module, so it
  depends on the stdlib only; the pull collectors of the C++ host kernels, the graph
  optimizer and the device operators import their modules when the registry is read.

A collector that raises fails the snapshot: the JAX package skips it, but here a card
error raises (ROADMAP: deliberate differences).

The :class:`FlightRecorder` is the crash-forensics side of the same plane: a bounded
ring of recent structured events (``run_start``, ``commit``, ``retractions``,
``error``, ``run_end``, ``run_error``) that ``pw.run`` dumps to a JSON file when a run
raises (``PATHWAY_TPU_FLIGHT_DIR`` picks the directory, ``PATHWAY_TPU_FLIGHT_EVENTS``
the ring size); events and dumps carry the id of the sampled trace in flight
(:func:`set_trace_id_provider`, registered by ``internals/tracing.py``).
:class:`RequestLog` is the read tier's per-request ring (``PATHWAY_TPU_REQUEST_TRACE_RING``),
whose writers come with the serving tier (ROADMAP queue 1 item 8).

Families the port reports: the connectors' ``pathway_connector_entries_total``,
``_batches_total`` and ``_retries_total``; ``pathway_output_rows_total`` and
``pathway_ingest_to_sink_latency_seconds``; the scheduler probe's
``pathway_queue_depth``; the device pipeline's ``pathway_device_queue_depth``,
``pathway_device_occupancy_ratio``, ``pathway_device_dispatch_complete_seconds`` and
``pathway_device_pipeline_commits_total``; ``pathway_device_knn_updates_total`` and
``pathway_device_knn_queries_total``; the residency plane's transfer and event
counters; the pull collectors' ``pathway_native_kernel_*``, ``pathway_optimizer_*`` and
``pathway_device_ops_*``; the profiler's ``pathway_profile_*`` and
``pathway_device_memory_bytes``; the mesh's families (``pathway_mesh_*``: recoveries,
send retries, epochs, fenced frames, elections, rescales, receive backpressure), which
``engine/distributed.py`` and ``DistributedGraphRunner`` report.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time as _time
from bisect import bisect_left
from collections import deque
from typing import Any, Callable, Iterable

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "REGISTRY",
    "FLIGHT",
    "FlightRecorder",
    "REQUESTS",
    "RequestLog",
    "MirroredCounterDict",
    "DEFAULT_LATENCY_BUCKETS",
    "full_snapshot",
    "render_snapshots",
    "parse_prometheus_text",
    "validate_exposition",
]

#: ingest->sink latency bucket upper bounds, seconds (power-of-~2.5 ladder
#: from 1ms to 10s, the span between "same-commit" and "stalled mesh")
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
    """Fixed-bucket histogram: ``len(bounds) + 1`` per-bucket counts (the
    last one is +Inf), a running sum and a total count.  ``observe`` is a
    bisect plus three adds — no allocation, no lock."""

    __slots__ = ("bounds", "counts", "sum", "count", "exemplars")

    def __init__(self, bounds: Iterable[float]) -> None:
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly increasing")
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        #: bucket index -> (trace_id, value); written only for sampled
        #: requests, read at scrape — whole-tuple replacement per slot,
        #: so concurrent writers/readers see either value, never a tear
        self.exemplars: dict[int, tuple] = {}

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def exemplar(self, v: float, trace_id: str) -> None:
        """Attach a trace-id exemplar to the bucket ``v`` falls in —
        called only for SAMPLED requests (off the unsampled hot path),
        so ``observe`` itself stays a bisect plus three adds."""
        self.exemplars[bisect_left(self.bounds, v)] = (
            str(trace_id),
            float(v),
        )

    def observe_n(self, v: float, n: int) -> None:
        """One value standing for ``n`` events (e.g. every row of a delta
        batch shares the batch's ingest->sink latency)."""
        if n <= 0:
            return
        self.counts[bisect_left(self.bounds, v)] += n
        self.sum += v * n
        self.count += n

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


class _Family:
    __slots__ = ("name", "kind", "help", "buckets", "series")

    def __init__(self, name: str, kind: str, help: str, buckets=None) -> None:
        self.name = name
        self.kind = kind
        self.help = help
        self.buckets = buckets
        #: sorted-label-items tuple -> Counter | Gauge | Histogram
        self.series: dict[tuple, Any] = {}


class Registry:
    """Named metric families, each a set of label-addressed series.

    Handle creation takes the lock; the returned instrument is meant to
    be cached by the call site so the hot path never re-enters here."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}  # guarded-by: self._lock
        self._collectors: list[Callable[[], Iterable[tuple]]] = []  # guarded-by: self._lock

    # -- instrument handles --------------------------------------------------

    def _series(self, name, kind, help, labels, factory, buckets=None):
        key = tuple(sorted(labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(name, kind, help, buckets)
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}"
                )
            inst = fam.series.get(key)
            if inst is None:
                inst = fam.series[key] = factory()
            return inst

    def counter(self, name: str, help: str = "", **labels: str) -> Counter:
        return self._series(name, "counter", help, labels, Counter)

    def gauge(self, name: str, help: str = "", **labels: str) -> Gauge:
        return self._series(name, "gauge", help, labels, Gauge)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS,
        **labels: str,
    ) -> Histogram:
        buckets = tuple(float(b) for b in buckets)
        return self._series(
            name,
            "histogram",
            help,
            labels,
            lambda: Histogram(buckets),
            buckets,
        )

    # -- pull collectors -----------------------------------------------------

    def register_collector(self, fn: Callable[[], Iterable[tuple]]) -> None:
        """``fn`` yields ``(name, kind, help, labels_dict, value)`` sample
        tuples at scrape/snapshot time (native kernels, optimizer, ...)."""
        with self._lock:
            self._collectors.append(fn)

    # -- snapshots -----------------------------------------------------------

    def snapshot(self) -> dict:
        """Plain-dict view of every family (plus collector samples):
        ``{name: {kind, help, buckets, series: [{labels, ...values}]}}``.
        Picklable (mesh frames) and JSON-able (flight dumps)."""
        with self._lock:
            fams = [
                (f.name, f.kind, f.help, f.buckets, list(f.series.items()))
                for f in self._families.values()
            ]
            collectors = list(self._collectors)
        out: dict = {}
        for name, kind, help, buckets, series in fams:
            fam = out[name] = {
                "kind": kind,
                "help": help,
                "buckets": list(buckets) if buckets else None,
                "series": [],
            }
            for key, inst in series:
                entry: dict = {"labels": dict(key)}
                if kind == "histogram":
                    entry["counts"] = list(inst.counts)
                    entry["sum"] = inst.sum
                    entry["count"] = inst.count
                    ex = getattr(inst, "exemplars", None)
                    if ex:
                        entry["exemplars"] = {
                            str(i): [tid, v]
                            for i, (tid, v) in sorted(ex.items())
                        }
                else:
                    entry["value"] = inst.value
                fam["series"].append(entry)
        for fn in collectors:
            merge_samples(out, fn())
        return out

    def collect(self) -> list[tuple]:
        """Every registered collector's samples, in registration order."""
        with self._lock:
            collectors = list(self._collectors)
        out: list[tuple] = []
        for fn in collectors:
            out.extend(fn())
        return out

    def reset(self) -> None:
        """Drop every family (tests only — cached handles go stale)."""
        with self._lock:
            self._families.clear()


def merge_samples(snap: dict, samples: Iterable[tuple]) -> dict:
    """Fold ``(name, kind, help, labels, value)`` tuples into a snapshot
    dict (collector output, per-operator scheduler series)."""
    for name, kind, help, labels, value in samples:
        fam = snap.get(name)
        if fam is None:
            fam = snap[name] = {
                "kind": kind,
                "help": help,
                "buckets": None,
                "series": [],
            }
        fam["series"].append({"labels": dict(labels), "value": float(value)})
    return snap


def operator_samples(stats: dict, nodes: Iterable = ()) -> list[tuple]:
    """Per-operator sample tuples from a scheduler's ``stats`` mapping
    (index -> OperatorStats); ``nodes`` supplies names when available."""
    names = {}
    for node in nodes:
        try:
            names[node.index] = node.name
        except Exception:
            pass
    out = []
    for index, st in sorted(stats.items()):
        labels = {
            "operator": str(names.get(index, "")),
            "index": str(index),
        }
        out.append(
            (
                "pathway_operator_rows",
                "gauge",
                "net rows resident per operator",
                labels,
                st.insertions - st.deletions,
            )
        )
        out.append(
            (
                "pathway_operator_time_seconds",
                "counter",
                "cumulative process() wall time per operator",
                labels,
                st.time_spent,
            )
        )
        out.append(
            (
                "pathway_operator_batches_total",
                "counter",
                "delta batches processed per operator",
                labels,
                st.batches,
            )
        )
    return out


def full_snapshot(scheduler: Any = None) -> dict:
    """Registry snapshot plus this worker's per-operator series — the
    payload a follower piggybacks to the leader."""
    snap = REGISTRY.snapshot()
    if scheduler is not None:
        stats = getattr(scheduler, "stats", None)
        if stats:
            scope = getattr(scheduler, "scope", None)
            nodes = getattr(scope, "nodes", ()) if scope is not None else ()
            merge_samples(snap, operator_samples(dict(stats), list(nodes)))
    return snap


# -- exposition rendering ----------------------------------------------------


def escape_label_value(v: str) -> str:
    """Prometheus exposition label escaping: backslash, quote, newline."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_bound(b: float) -> str:
    return _fmt_value(b) if b == int(b) else ("%g" % b)


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_exemplar(ex) -> str:
    """OpenMetrics exemplar suffix for one bucket line
    (`` # {trace_id="..."} <value>``), or "" when the bucket has none."""
    if not ex:
        return ""
    tid, value = ex[0], ex[1]
    return (
        f' # {{trace_id="{escape_label_value(str(tid))}"}}'
        f" {_fmt_value(float(value))}"
    )


def render_snapshots(snaps: "dict[str, dict]") -> str:
    """Exposition text for worker-keyed snapshots.  Key ``""`` renders
    without a ``worker`` label (the leader's legacy local series); any
    other key is added as ``worker="<key>"`` on every sample.  Each
    family name gets exactly one HELP/TYPE block even when several
    workers report it.  Keys starting with ``__`` are reserved for
    piggybacked sidecar payloads (e.g. the profiler's
    ``"__profile__"``) and are never rendered as families."""
    order: list[str] = []
    meta: dict[str, dict] = {}
    for snap in snaps.values():
        for name, fam in snap.items():
            if name.startswith("__"):
                continue
            if name not in meta:
                meta[name] = fam
                order.append(name)
    lines: list[str] = []
    for name in order:
        fam = meta[name]
        help = fam.get("help") or name
        lines.append(f"# HELP {name} {help}".replace("\n", " "))
        lines.append(f"# TYPE {name} {fam['kind']}")
        for worker, snap in snaps.items():
            wfam = snap.get(name)
            if wfam is None:
                continue
            for entry in wfam["series"]:
                labels = dict(entry["labels"])
                if worker != "":
                    labels["worker"] = worker
                if fam["kind"] == "histogram":
                    bounds = list(wfam.get("buckets") or [])
                    counts = entry["counts"]
                    exemplars = entry.get("exemplars") or {}
                    cum = 0
                    for i, (bound, c) in enumerate(zip(bounds, counts)):
                        cum += c
                        blabels = dict(labels)
                        blabels["le"] = _fmt_bound(bound)
                        lines.append(
                            f"{name}_bucket{_label_str(blabels)} {cum}"
                            f"{_fmt_exemplar(exemplars.get(str(i)))}"
                        )
                    blabels = dict(labels)
                    blabels["le"] = "+Inf"
                    lines.append(
                        f"{name}_bucket{_label_str(blabels)} {entry['count']}"
                        f"{_fmt_exemplar(exemplars.get(str(len(bounds))))}"
                    )
                    lines.append(
                        f"{name}_sum{_label_str(labels)} "
                        f"{_fmt_value(entry['sum'])}"
                    )
                    lines.append(
                        f"{name}_count{_label_str(labels)} {entry['count']}"
                    )
                else:
                    lines.append(
                        f"{name}{_label_str(labels)} "
                        f"{_fmt_value(entry['value'])}"
                    )
    return "\n".join(lines) + "\n" if lines else ""


# -- exposition parsing ------------------------------------------------------


def _parse_labels(text: str, lineno: int) -> dict:
    labels: dict[str, str] = {}
    i = 0
    n = len(text)
    while i < n:
        while i < n and text[i] in " \t":
            i += 1
        j = i
        while j < n and (text[j].isalnum() or text[j] == "_"):
            j += 1
        if j == i:
            raise ValueError(f"line {lineno}: bad label name at {text[i:]!r}")
        name = text[i:j]
        if j >= n or text[j] != "=":
            raise ValueError(f"line {lineno}: expected '=' after {name}")
        j += 1
        if j >= n or text[j] != '"':
            raise ValueError(f"line {lineno}: expected '\"' in {name} value")
        j += 1
        buf = []
        while j < n and text[j] != '"':
            if text[j] == "\\":
                j += 1
                if j >= n:
                    raise ValueError(f"line {lineno}: dangling escape")
                c = text[j]
                buf.append({"n": "\n", "\\": "\\", '"': '"'}.get(c, "\\" + c))
            else:
                buf.append(text[j])
            j += 1
        if j >= n:
            raise ValueError(f"line {lineno}: unterminated label value")
        labels[name] = "".join(buf)
        j += 1
        if j < n and text[j] == ",":
            j += 1
        elif j < n:
            raise ValueError(f"line {lineno}: expected ',' got {text[j]!r}")
        i = j
    return labels


def parse_prometheus_text(text: str) -> dict:
    """Parse exposition text into
    ``{family: {"type", "help", "samples": [(name, labels, value)]}}``.
    Histogram ``_bucket``/``_sum``/``_count`` samples are grouped under
    their family name.  Raises ``ValueError`` on malformed lines."""
    families: dict[str, dict] = {}

    def fam(name: str) -> dict:
        f = families.get(name)
        if f is None:
            f = families[name] = {"type": None, "help": None, "samples": []}
        return f

    typed: dict[str, str] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(f"line {lineno}: bad comment {raw!r}")
            name = parts[2]
            if parts[1] == "TYPE":
                kind = parts[3].strip() if len(parts) > 3 else ""
                if kind not in ("counter", "gauge", "histogram", "summary"):
                    raise ValueError(f"line {lineno}: bad type {kind!r}")
                fam(name)["type"] = kind
                typed[name] = kind
            else:
                fam(name)["help"] = parts[3] if len(parts) > 3 else ""
            continue
        # OpenMetrics exemplar suffix: `<sample> # {labels} <value>` —
        # split it off FIRST so rfind("}") sees the sample's own braces
        line, _sep, exemplar_part = line.partition(" # ")
        exemplar_part = exemplar_part.strip()
        brace = line.find("{")
        if brace >= 0:
            close = line.rfind("}")
            if close < brace:
                raise ValueError(f"line {lineno}: unbalanced braces")
            sample_name = line[:brace]
            labels = _parse_labels(line[brace + 1 : close], lineno)
            rest = line[close + 1 :].strip()
        else:
            bits = line.split()
            if len(bits) < 2:
                raise ValueError(f"line {lineno}: no value on {raw!r}")
            sample_name, rest = bits[0], " ".join(bits[1:])
            labels = {}
        value_str = rest.split()[0] if rest else ""
        try:
            value = float(value_str)
        except ValueError:
            raise ValueError(
                f"line {lineno}: bad value {value_str!r}"
            ) from None
        base = sample_name
        for suffix in ("_bucket", "_sum", "_count"):
            cand = sample_name[: -len(suffix)]
            if sample_name.endswith(suffix) and typed.get(cand) == "histogram":
                base = cand
                break
        fam(base)["samples"].append((sample_name, labels, value))
        if exemplar_part:
            if not exemplar_part.startswith("{"):
                raise ValueError(
                    f"line {lineno}: bad exemplar {exemplar_part!r}"
                )
            ex_close = exemplar_part.find("}")
            if ex_close < 0:
                raise ValueError(
                    f"line {lineno}: unterminated exemplar labels"
                )
            ex_labels = _parse_labels(exemplar_part[1:ex_close], lineno)
            ex_rest = exemplar_part[ex_close + 1 :].split()
            if not ex_rest:
                raise ValueError(f"line {lineno}: exemplar without value")
            try:
                ex_value = float(ex_rest[0])
            except ValueError:
                raise ValueError(
                    f"line {lineno}: bad exemplar value {ex_rest[0]!r}"
                ) from None
            fam(base).setdefault("exemplars", []).append(
                (sample_name, labels, ex_labels, ex_value)
            )
    return families


def validate_exposition(text: str) -> dict:
    """Strict OpenMetrics-style conformance check used by the test suite:
    every sample must belong to a family with HELP and TYPE lines;
    histogram families must expose cumulative ``_bucket`` series with an
    ``le="+Inf"`` bucket equal to ``_count``.  Returns the parse."""
    families = parse_prometheus_text(text)
    for name, fam in families.items():
        if fam["type"] is None:
            raise ValueError(f"family {name}: missing # TYPE line")
        if fam["help"] is None:
            raise ValueError(f"family {name}: missing # HELP line")
        if not fam["samples"]:
            raise ValueError(f"family {name}: no samples")
        if fam["type"] != "histogram":
            for sample_name, _labels, _v in fam["samples"]:
                if sample_name != name:
                    raise ValueError(
                        f"family {name}: stray sample {sample_name}"
                    )
            continue
        # histogram: group by label set minus le
        groups: dict[tuple, dict] = {}
        for sample_name, labels, value in fam["samples"]:
            rest = tuple(
                sorted((k, v) for k, v in labels.items() if k != "le")
            )
            g = groups.setdefault(
                rest, {"buckets": [], "sum": None, "count": None}
            )
            if sample_name == name + "_bucket":
                if "le" not in labels:
                    raise ValueError(f"family {name}: bucket without le")
                g["buckets"].append((labels["le"], value))
            elif sample_name == name + "_sum":
                g["sum"] = value
            elif sample_name == name + "_count":
                g["count"] = value
            else:
                raise ValueError(f"family {name}: stray sample {sample_name}")
        for rest, g in groups.items():
            if not g["buckets"] or g["sum"] is None or g["count"] is None:
                raise ValueError(
                    f"family {name}{dict(rest)}: incomplete "
                    "_bucket/_sum/_count triple"
                )
            if g["buckets"][-1][0] != "+Inf":
                raise ValueError(f"family {name}: last bucket must be +Inf")
            values = [v for _le, v in g["buckets"]]
            if values != sorted(values):
                raise ValueError(f"family {name}: non-cumulative buckets")
            if values[-1] != g["count"]:
                raise ValueError(f"family {name}: +Inf bucket != _count")
    return families


# -- mirrored counter dicts ---------------------------------------------------


class MirroredCounterDict(dict):
    """A plain dict whose integer writes mirror into a labelled counter family: call
    sites write ``d[key] += 1`` (or ``d[key] = 0`` to reset), i.e. ``__setitem__`` with
    the new total, so the mirror sets the counter's value and the dict stays the
    authoritative alias (the residency plane's ``RESIDENCY_STATS``).

    ``extra_labels`` attaches further constant labels per key."""

    def __init__(
        self,
        metric: str,
        label: str,
        initial: dict,
        help: str = "",
        extra_labels: dict | None = None,
    ) -> None:
        super().__init__(initial)
        self._metric = metric
        self._label = label
        self._help = help
        self._extra = dict(extra_labels or {})
        self._series: dict[Any, Counter] = {}
        for key, value in initial.items():
            self[key] = value

    def __setitem__(self, key, value) -> None:
        dict.__setitem__(self, key, value)
        c = self._series.get(key)
        if c is None:
            labels = {self._label: str(key)}
            labels.update(self._extra.get(key, {}))
            c = REGISTRY.counter(self._metric, self._help, **labels)
            self._series[key] = c
        c.value = float(value)


# -- flight recorder ---------------------------------------------------------

# Optional callback returning the id of the in-flight sampled trace, if
# any (internals/tracing.py registers one at import; this module stays
# free of engine imports).  Flight events and dumps reference it so
# crash forensics can be joined against exported traces.
_TRACE_ID_PROVIDER = None


def set_trace_id_provider(fn) -> None:
    global _TRACE_ID_PROVIDER
    _TRACE_ID_PROVIDER = fn


def _active_trace_id():
    fn = _TRACE_ID_PROVIDER
    if fn is None:
        return None
    try:
        return fn()
    except Exception:
        return None


class FlightRecorder:
    """Bounded ring of recent structured events; dumped to JSON when a
    run raises so post-mortems see the last commits/exchanges/errors of
    *this* worker without any live scrape."""

    def __init__(self, maxlen: int | None = None) -> None:
        if maxlen is None:
            try:
                maxlen = int(
                    os.environ.get("PATHWAY_TPU_FLIGHT_EVENTS", "256")
                )
            except ValueError:
                maxlen = 256
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max(1, maxlen))  # guarded-by: self._lock
        self._seq = 0  # guarded-by: self._lock
        self._dumps = 0  # guarded-by: self._lock

    def record(self, kind: str, **fields: Any) -> None:
        event = {"kind": kind, "wall": _time.time(), **fields}
        trace_id = _active_trace_id()
        if trace_id is not None:
            event.setdefault("trace_id", trace_id)
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._events.append(event)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def dump(self, reason: str) -> str | None:
        """Write the ring to ``PATHWAY_TPU_FLIGHT_DIR`` (default: the
        system temp dir); returns the path, or None when even the dump
        fails (forensics must never mask the original error)."""
        try:
            directory = os.environ.get(
                "PATHWAY_TPU_FLIGHT_DIR", tempfile.gettempdir()
            )
            os.makedirs(directory, exist_ok=True)
            process_id = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
            with self._lock:
                self._dumps += 1
                dump_no = self._dumps
            # pid + per-recorder counter in the name: concurrent workers
            # (and repeated dumps from one worker) sharing a FLIGHT_DIR
            # never clobber each other
            path = os.path.join(
                directory,
                f"pathway_flight_p{process_id}"
                f"_pid{os.getpid()}_{dump_no:03d}.json",
            )
            payload = {
                "reason": reason,
                "process_id": process_id,
                "pid": os.getpid(),
                "dumped_at": _time.time(),
                "trace_id": _active_trace_id(),
                "events": self.snapshot(),
            }
            with open(path, "w") as fh:
                json.dump(payload, fh, default=repr, indent=1)
            return path
        except Exception:
            return None


class RequestLog:
    """Bounded ring of per-request WIDE EVENTS: one structured record
    per served read-tier request (endpoint, status, stamp vector, cache
    disposition, fan-out width, shed/refusal reason, per-hop ns, trace
    id), served raw at ``/requests`` on the monitoring port.

    Same shape as the :class:`FlightRecorder` but a separate ring: the
    flight ring is crash forensics (commits, exchanges, errors) and a
    query flood must not evict it."""

    def __init__(self, maxlen: int | None = None) -> None:
        if maxlen is None:
            try:
                maxlen = int(
                    os.environ.get("PATHWAY_TPU_REQUEST_TRACE_RING", "256")
                )
            except ValueError:
                maxlen = 256
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max(1, maxlen))  # guarded-by: self._lock
        self._seq = 0  # guarded-by: self._lock

    def record(self, **fields: Any) -> None:
        event = dict(fields)
        event.setdefault("wall", _time.time())
        trace_id = _active_trace_id()
        if trace_id is not None:
            event.setdefault("trace_id", trace_id)
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._events.append(event)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


#: the process-wide registry every engine hot path bumps
REGISTRY = Registry()

#: the process-wide flight recorder ``pw.run`` dumps on a raising run
FLIGHT = FlightRecorder()

#: the process-wide per-request wide-event ring behind ``/requests``
REQUESTS = RequestLog()


# -- built-in pull collectors (imports deferred to scrape time) ---------------


def _native_collector() -> list[tuple]:
    """The C++ host kernels' calls and cumulative nanoseconds, per kernel (none before
    the kernels are first built: reading the registry builds nothing)."""
    from pathway_tpu_torch import native

    out = []
    for kernel, hits in native.hit_counts().items():
        out.append(
            (
                "pathway_native_kernel_hits_total",
                "counter",
                "C++ kernel engagements (native.hit_counts)",
                {"kernel": kernel},
                hits,
            )
        )
    for kernel, ns in native.kernel_ns().items():
        out.append(
            (
                "pathway_native_kernel_ns_total",
                "counter",
                "cumulative nanoseconds inside each C++ kernel",
                {"kernel": kernel},
                ns,
            )
        )
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
    """The device-operator twin of :func:`_native_collector`: the device operators'
    launch and ns counters, and the placement policy's current decision per operator
    (1 = card, 0 = host)."""
    from pathway_tpu_torch.engine import device_ops
    from pathway_tpu_torch.optimize import placement

    out = []
    for kernel, hits in device_ops.hit_counts().items():
        out.append(
            (
                "pathway_device_ops_kernel_hits_total",
                "counter",
                "device operator calls (device_ops.hit_counts)",
                {"kernel": kernel},
                hits,
            )
        )
    for kernel, ns in device_ops.kernel_ns().items():
        out.append(
            (
                "pathway_device_ops_kernel_ns_total",
                "counter",
                "cumulative host-observed nanoseconds per device operator",
                {"kernel": kernel},
                ns,
            )
        )
    for op, st in placement.POLICY.decisions().items():
        out.append(
            (
                "pathway_device_ops_placement",
                "gauge",
                "current operator placement (1 = device, 0 = host)",
                {"op": op},
                1 if st["device"] else 0,
            )
        )
    return out


REGISTRY.register_collector(_native_collector)
REGISTRY.register_collector(_optimizer_collector)
REGISTRY.register_collector(_device_ops_collector)
