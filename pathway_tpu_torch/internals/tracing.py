"""Sampled per-commit tracing: spans, critical path, export.

Counterpart of ``pathway_tpu/internals/tracing.py``, with the same names, span names and
categories, buckets and export format. The metrics plane (``internals/metrics.py``)
answers *how much*; this module answers *why*: for a sampled commit it records the
spans of the connector ingest wait (``ingest-wait``), every operator ``process()``
(``op``, ``sink``, the fused chains' ``fused-sweep:<name>``), the KNN index's
``knn-update`` and ``knn-search`` and the device pipeline's ``device-backpressure``
wait, and assembles them into one trace.

- **cheap when idle**: tracing is off unless ``PATHWAY_TPU_TRACE=1``; when on, every
  Nth commit is sampled (``PATHWAY_TPU_TRACE_SAMPLE``, default 16) and the hot-path
  guard of an unsampled commit is one attribute load (:func:`current` returning
  ``None``). Assembled traces live in a bounded ring (``PATHWAY_TPU_TRACE_RING``).
- **self-limiting**: the recorder measures its own bookkeeping per sampled commit and
  doubles the sampling interval when the amortized cost nears the 5% observability
  gate, decaying back to the configured base when comfortably under
  (:meth:`TraceRecorder._adapt`).
- **exported** as one Chrome trace-event JSON file per :meth:`TraceRecorder.export`
  into ``PATHWAY_TPU_TRACE_DIR`` (:func:`chrome_trace`, checked by
  :func:`validate_chrome_trace`).

Span timestamps are microseconds since the epoch, from one per-process wall anchor plus
``perf_counter`` deltas, so each track is monotonic by construction.

Critical-path attribution (:func:`critical_path`) buckets a traced commit's wall time
into ``queue_wait`` (the connector ingest wait plus ``cat="wait"`` spans),
``exchange`` (``cat="exchange"`` spans), ``device`` (the deltas of the C++ host
kernels' ``native.kernel_ns`` and the device operators' ``device_ops.kernel_ns``) and
``host_compute`` (the residual, clamped at zero and flagged ``clamped``); the four sum
to the commit wall. Spans are host-clock stamps around host calls: a span whose work
ends in a device-to-host copy (``knn-search``) covers the device work, and one whose
work only enqueues (``knn-update``, an operator whose output stays on the card) may end
before its kernels do, as the JAX package's spans do under XLA's async dispatch. The
device operators record their ns on the pipeline's completion thread, so that time may
land in a later commit's window.

The mesh half (:meth:`TraceRecorder.ctx_frame`, :meth:`~TraceRecorder.adopt`,
:meth:`~TraceRecorder.take_spans`, peer spans in :meth:`~TraceRecorder.end`) is called by
the mesh's exchange rounds (``engine/distributed.py``): the leader's context rides the
round frames, the followers adopt it and ship their spans back. The request half
(:class:`RequestTrace`, :meth:`~TraceRecorder.begin_request`,
:meth:`~TraceRecorder.record_query`, the header helpers) is called by the serving
tier (``pathway_tpu_torch/serving``): the query server's handlers begin, adopt and end
a request's trace, and its micro-batcher records each batched search.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time as _time
from collections import deque
from typing import Any

from pathway_tpu_torch.internals import metrics as _metrics

__all__ = [
    "TraceContext",
    "RequestTrace",
    "TraceRecorder",
    "TRACER",
    "TRACE_HEADER",
    "SPANS_HEADER",
    "current",
    "parse_trace_header",
    "encode_spans",
    "decode_spans",
    "critical_path",
    "chrome_trace",
    "validate_chrome_trace",
]

#: spans kept per commit per worker before dropping (bounds frame size)
MAX_SPANS = 2048

#: amortized (overhead / interval) share of commit wall that triggers an
#: interval doubling — half the 5% observability gate, for headroom
OVERHEAD_TARGET = 0.02

#: request header carrying the read-tier trace context across HTTP hops:
#: ``"<trace_id>;<parent_span_id>;<0|1 sampling bit>"``
TRACE_HEADER = "X-Pathway-Trace"

#: response header piggybacking a remote hop's span list back to its
#: caller (compact JSON; dropped rather than split when oversized)
SPANS_HEADER = "X-Pathway-Trace-Spans"

#: span-piggyback budget — one HTTP header line; an oversized payload is
#: dropped (the caller keeps its own leg span, so the trace stays valid)
MAX_SPANS_HEADER_BYTES = 16384


def parse_trace_header(value: str | None) -> tuple[str, str, bool] | None:
    """Decode an ``X-Pathway-Trace`` value into
    ``(trace_id, parent_span_id, sampled)``; ``None`` when absent or
    garbled — a skewed peer must never break the request path."""
    if not value:
        return None
    parts = str(value).split(";")
    if len(parts) != 3 or not parts[0] or not parts[1]:
        return None
    return parts[0], parts[1], parts[2] == "1"


def encode_spans(spans: list[dict]) -> str | None:
    """Compact JSON for the response-header span piggyback, or ``None``
    when there is nothing to send or the payload would blow the header
    budget."""
    if not spans:
        return None
    try:
        payload = json.dumps(spans, separators=(",", ":"), default=repr)
    except (TypeError, ValueError):
        return None
    if len(payload) > MAX_SPANS_HEADER_BYTES:
        return None
    return payload


def decode_spans(value: str | None) -> list[dict]:
    """Parse a piggybacked span list defensively: malformed input yields
    ``[]``, and only dict entries with a string name and numeric ``ts``
    survive (the shape :func:`chrome_trace` depends on)."""
    if not value:
        return []
    try:
        spans = json.loads(value)
    except (TypeError, ValueError):
        return []
    if not isinstance(spans, list):
        return []
    out: list[dict] = []
    for s in spans:
        if (
            isinstance(s, dict)
            and isinstance(s.get("name"), str)
            and isinstance(s.get("ts"), (int, float))
        ):
            out.append(s)
    return out

# one per-process clock anchor: wall time is captured once, every span
# timestamp is the anchor plus a perf_counter/monotonic delta — so per-
# worker timestamps are strictly monotonic even if the system clock steps
_ANCHOR_WALL = _time.time()
_ANCHOR_PERF = _time.perf_counter()
_ANCHOR_MONO = _time.monotonic()


def perf_to_wall(t: float) -> float:
    return _ANCHOR_WALL + (t - _ANCHOR_PERF)


def mono_to_wall(t: float) -> float:
    return _ANCHOR_WALL + (t - _ANCHOR_MONO)


def _us(wall: float) -> int:
    return int(wall * 1e6)


def _kernel_ns_snapshot() -> dict:
    """Per-kernel cumulative ns across both kernel planes: the C++ host kernels
    (``native.kernel_ns``) and the device operators (``engine.device_ops``), the latter
    prefixed ``device_ops.``. Span deltas over this snapshot feed the critical path's
    device bucket, so device-resident operators show up as device time."""
    from pathway_tpu_torch import native
    from pathway_tpu_torch.engine import device_ops

    out = dict(native.kernel_ns())
    for name, ns in device_ops.kernel_ns().items():
        out["device_ops." + name] = ns
    return out


class TraceContext:
    """The in-flight sampled commit: identity plus the span accumulator.

    Created by the leader (:meth:`TraceRecorder.begin`) or adopted from
    the leader's round-frame context tuple on a follower
    (:meth:`TraceRecorder.adopt`, ``remote=True``)."""

    __slots__ = (
        "trace_id",
        "commit_time",
        "origin_wall",
        "epoch",
        "pid",
        "remote",
        "begin_wall",
        "spans",
        "dropped",
        "sink_rows",
        "native_ns0",
        "overhead_s",
    )

    def __init__(
        self,
        trace_id: str,
        commit_time: int,
        origin_wall: float,
        epoch: int,
        pid: int,
        remote: bool = False,
    ) -> None:
        self.trace_id = trace_id
        self.commit_time = int(commit_time)
        self.origin_wall = float(origin_wall)
        self.epoch = int(epoch)
        self.pid = int(pid)
        self.remote = remote
        self.begin_wall = perf_to_wall(_time.perf_counter())
        self.spans: list[dict] = []
        self.dropped = 0
        self.sink_rows = 0
        self.native_ns0: dict | None = None
        self.overhead_s = 0.0

    def span(
        self, name: str, cat: str, t0: float, t1: float, **args: Any
    ) -> None:
        """Record one completed span from perf_counter stamps ``t0``/``t1``
        (taken by the instrumented call site around the work)."""
        if len(self.spans) >= MAX_SPANS:
            self.dropped += 1
            return
        ev: dict = {
            "name": name,
            "cat": cat,
            "ts": _us(perf_to_wall(t0)),
            "dur": max(0, int((t1 - t0) * 1e6)),
            "pid": self.pid,
        }
        if args:
            ev["args"] = args
        self.spans.append(ev)

    def note_sink(self, rows: int) -> None:
        self.sink_rows += int(rows)


class RequestTrace:
    """One in-flight read-tier request: identity plus span accumulator.

    Unlike :class:`TraceContext` (single-slot, pump-thread-private), a
    request trace is born on an HTTP handler thread and accumulates
    spans from the federation scatter pool concurrently, so its span
    list and span-id counter are lock-guarded.  ``track`` is the OS
    pid: every process a request crosses renders on its own Chrome
    track, so per-track timestamps stay monotonic even though each
    process stamps spans off its own clock anchor."""

    __slots__ = (
        "trace_id",
        "parent_span",
        "endpoint",
        "remote",
        "track",
        "origin_wall",
        "begin_wall",
        "spans",
        "dropped",
        "overhead_s",
        "_lock",
        "_sid",
    )

    def __init__(
        self,
        trace_id: str,
        endpoint: str,
        parent_span: str | None = None,
        remote: bool = False,
    ) -> None:
        self.trace_id = trace_id
        self.parent_span = parent_span
        self.endpoint = endpoint
        self.remote = remote
        self.track = os.getpid()
        self.begin_wall = perf_to_wall(_time.perf_counter())
        self.origin_wall = self.begin_wall
        self._lock = threading.Lock()
        self.spans: list[dict] = []  # guarded-by: self._lock
        self._sid = 0  # guarded-by: self._lock
        self.dropped = 0  # guarded-by: self._lock
        self.overhead_s = 0.0

    def alloc_sid(self) -> str:
        """Reserve a span id BEFORE the RPC it will name, so the
        outbound trace header can carry it as the callee's parent."""
        with self._lock:
            self._sid += 1
            return f"{self.track:x}.{self._sid}"

    def span(
        self,
        name: str,
        cat: str,
        t0: float,
        t1: float,
        sid: str | None = None,
        **args: Any,
    ) -> None:
        """Record one completed span from perf_counter stamps; safe to
        call from any thread holding a reference to this context."""
        ev: dict = {
            "name": name,
            "cat": cat,
            "ts": _us(perf_to_wall(t0)),
            "dur": max(0, int((t1 - t0) * 1e6)),
            "pid": self.track,
        }
        if sid is not None:
            args["sid"] = sid
        if self.parent_span is not None:
            args.setdefault("parent", self.parent_span)
        if args:
            ev["args"] = args
        with self._lock:
            if len(self.spans) >= MAX_SPANS:
                self.dropped += 1
                return
            self.spans.append(ev)

    def add_remote_spans(
        self, spans: list[dict], parent_sid: str
    ) -> None:
        """Merge a callee's piggybacked spans.  Each span keeps the
        ``pid`` track its own process stamped; spans that did not carry
        a parent (older peers) are adopted under this leg's sid."""
        with self._lock:
            for s in spans:
                if len(self.spans) >= MAX_SPANS:
                    self.dropped += 1
                    continue
                args = dict(s.get("args") or {})
                args.setdefault("parent", parent_sid)
                self.spans.append(dict(s, args=args))

    def header(self, parent_sid: str) -> str:
        """The outbound ``X-Pathway-Trace`` value for one hop — only
        sampled requests ever propagate, so the bit is always 1."""
        return f"{self.trace_id};{parent_sid};1"

    def take_spans(self) -> list[dict]:
        with self._lock:
            return list(self.spans)


class TraceRecorder:
    """Process-wide sampling trace recorder (singleton: :data:`TRACER`).

    The engine's only hot-path contact points are :func:`current` (one
    attribute read, ``None`` when the running commit is unsampled) and
    :meth:`begin` (a counter bump + modulo when tracing is enabled, a
    single boolean test when it is not)."""

    def __init__(
        self,
        enabled: bool | None = None,
        sample: int | None = None,
        maxlen: int | None = None,
    ) -> None:
        if maxlen is None:
            try:
                maxlen = int(os.environ.get("PATHWAY_TPU_TRACE_RING", "64"))
            except ValueError:
                maxlen = 64
        self._lock = threading.Lock()
        #: the ring and the query counter are the cross-thread surface:
        #: serving workers record queries and exporters snapshot the ring
        #: while the pump appends.  _ctx/_count/_export_seq/_overhead_ema
        #: are pump-thread-private and deliberately unguarded.
        self._traces: deque = deque(maxlen=max(1, maxlen))  # guarded-by: self._lock
        self._ctx: TraceContext | None = None
        self._count = 0
        self._query_count = 0  # guarded-by: self._lock
        self._request_count = 0  # guarded-by: self._lock
        #: per-HTTP-handler-thread request context slot; thread-local so
        #: concurrent requests on the serving pool never share a trace
        self._req_local = threading.local()
        self._export_seq = 0
        self._overhead_ema: float | None = None
        self._req_overhead_ema: float | None = None
        self.epoch = 0
        self.configure(enabled=enabled, sample=sample)

    # -- configuration -------------------------------------------------------

    def configure(
        self,
        enabled: bool | None = None,
        sample: int | None = None,
        clear: bool = False,
        request_enabled: bool | None = None,
        request_sample: int | None = None,
    ) -> None:
        """(Re)read the knobs; tests and benches call this directly
        instead of mutating the environment."""
        if enabled is None:
            enabled = os.environ.get("PATHWAY_TPU_TRACE", "").lower() in (
                "1",
                "true",
                "yes",
            )
        if sample is None:
            try:
                sample = int(
                    os.environ.get("PATHWAY_TPU_TRACE_SAMPLE", "16")
                )
            except ValueError:
                sample = 16
        if request_enabled is None:
            request_enabled = os.environ.get(
                "PATHWAY_TPU_REQUEST_TRACE", ""
            ).lower() in ("1", "true", "yes")
        if request_sample is None:
            try:
                request_sample = int(
                    os.environ.get(
                        "PATHWAY_TPU_REQUEST_TRACE_SAMPLE", "16"
                    )
                )
            except ValueError:
                request_sample = 16
        self.enabled = bool(enabled)
        self.base_interval = max(1, int(sample))
        self.interval = self.base_interval
        self.request_enabled = bool(request_enabled)
        self.request_base_interval = max(1, int(request_sample))
        self.request_interval = self.request_base_interval
        try:
            self.worker_id = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
        except ValueError:
            self.worker_id = 0
        self._ctx = None
        self._req_local = threading.local()
        self._overhead_ema = None
        self._req_overhead_ema = None
        if clear:
            with self._lock:
                self._traces.clear()
                self._query_count = 0
                self._request_count = 0
            self._count = 0
            self._export_seq = 0

    # -- commit lifecycle ----------------------------------------------------

    def begin(
        self,
        commit_time: int,
        origin_mono: float | None = None,
        sources: list[str] | None = None,
    ) -> TraceContext | None:
        """Leader/local-side sampling decision at commit start.

        ``origin_mono`` is the connector ingest stamp
        (``InputDriver.first_pending_wall``, a ``time.monotonic`` value)
        popped by the runner — the trace's time zero.  Returns the
        active context when this commit is sampled, else ``None``."""
        if not self.enabled:
            return None
        self._count += 1
        if (self._count - 1) % self.interval:
            return None
        t0 = _time.perf_counter()
        now_wall = perf_to_wall(t0)
        origin_wall = (
            mono_to_wall(origin_mono) if origin_mono is not None else now_wall
        )
        origin_wall = min(origin_wall, now_wall)
        ctx = TraceContext(
            trace_id=(
                f"t{self.worker_id:02d}-{os.getpid():x}-{self._count:06x}"
            ),
            commit_time=commit_time,
            origin_wall=origin_wall,
            epoch=self.epoch,
            pid=self.worker_id,
        )
        ctx.native_ns0 = _kernel_ns_snapshot()
        if now_wall - origin_wall > 1e-6:
            # the connector-ingest wait, synthesized as the first span —
            # rendered on the track, but bucketed via the begin/origin
            # delta (not the "wait" category) to avoid double counting
            ev: dict = {
                "name": "ingest-wait",
                "cat": "queue",
                "ts": _us(origin_wall),
                "dur": max(0, int((now_wall - origin_wall) * 1e6)),
                "pid": self.worker_id,
            }
            if sources:
                ev["args"] = {"sources": sources}
            ctx.spans.append(ev)
        self._ctx = ctx
        ctx.overhead_s += _time.perf_counter() - t0
        return ctx

    def ctx_frame(self) -> tuple | None:
        """The context tuple the leader piggybacks on round frames —
        ``("ctx", trace_id, commit_time, origin_wall, epoch)``."""
        ctx = self._ctx
        if ctx is None or ctx.remote:
            return None
        return ("ctx", ctx.trace_id, ctx.commit_time, ctx.origin_wall,
                ctx.epoch)

    def adopt(self, payload: tuple) -> TraceContext | None:
        """Follower-side: activate the leader's trace context from a
        round-frame tuple.  A context stamped with an epoch below this
        process's fence floor is a zombie ex-leader's — ignored."""
        epoch = int(payload[4])
        if epoch < self.epoch:
            return None
        self.epoch = epoch
        ctx = self._ctx
        if ctx is not None and ctx.trace_id == payload[1]:
            return ctx
        ctx = TraceContext(
            trace_id=str(payload[1]),
            commit_time=int(payload[2]),
            origin_wall=float(payload[3]),
            epoch=epoch,
            pid=self.worker_id,
            remote=True,
        )
        self._ctx = ctx
        return ctx

    def take_spans(self) -> list[dict]:
        """Copy of the active context's spans so far — what a quiet
        follower piggybacks to the leader (the leader keeps the latest
        copy per peer, so the final quiescent round wins)."""
        ctx = self._ctx
        return list(ctx.spans) if ctx is not None else []

    def drop(self) -> None:
        """Abandon the in-flight context (followers at commit end;
        every process on recovery/failover — call AFTER the flight
        dump so forensics still reference the trace id)."""
        self._ctx = None

    def end(
        self, commit_time: int, peer_spans: dict | None = None
    ) -> dict | None:
        """Leader/local-side commit end: assemble the trace (local +
        piggybacked peer spans), attribute the critical path, ring it,
        and feed the adaptive sampler."""
        ctx = self._ctx
        self._ctx = None
        if ctx is None or ctx.remote:
            return None
        t_end = _time.perf_counter()
        end_wall = perf_to_wall(t_end)
        kernels: dict[str, int] = {}
        device_s = 0.0
        if ctx.native_ns0 is not None:
            now_ns = _kernel_ns_snapshot() or {}
            for k, ns in now_ns.items():
                d = int(ns) - int(ctx.native_ns0.get(k, 0))
                if d > 0:
                    kernels[k] = d
            device_s = sum(kernels.values()) / 1e9
        workers: dict[int, list] = {}
        if peer_spans:
            for peer, spans in sorted(peer_spans.items()):
                if spans:
                    workers[int(peer)] = list(spans)
        trace: dict = {
            "trace_id": ctx.trace_id,
            "commit_time": int(commit_time),
            "epoch": ctx.epoch,
            "worker": ctx.pid,
            "origin_wall": ctx.origin_wall,
            "begin_wall": ctx.begin_wall,
            "end_wall": end_wall,
            "spans": ctx.spans,
            "workers": workers,
            "sink_rows": ctx.sink_rows,
            "dropped_spans": ctx.dropped,
            "device_kernel_ns": kernels,
            "device_s": device_s,
        }
        trace["critical_path"] = critical_path(trace)
        with self._lock:
            self._traces.append(trace)
        overhead = ctx.overhead_s + (_time.perf_counter() - t_end)
        self._adapt(overhead, max(end_wall - ctx.begin_wall, 0.0))
        return trace

    def _adapt(self, overhead_s: float, commit_wall_s: float) -> None:
        """Keep the amortized tracing cost under the overhead target by
        doubling the sampling interval when a sampled commit's
        bookkeeping is too large a share of the (interval-amortized)
        commit wall, decaying back toward the configured base when the
        cost is comfortably below it."""
        amortized = overhead_s / max(1, self.interval)
        ratio = amortized / max(commit_wall_s, 1e-6)
        ema = self._overhead_ema
        self._overhead_ema = ratio if ema is None else 0.5 * ema + 0.5 * ratio
        if self._overhead_ema > OVERHEAD_TARGET:
            self.interval = min(self.interval * 2, 4096)
            self._overhead_ema /= 2.0  # doubling halves the amortized cost
        elif (
            self.interval > self.base_interval
            and self._overhead_ema < OVERHEAD_TARGET / 4.0
        ):
            self.interval = max(self.base_interval, self.interval // 2)
            self._overhead_ema *= 2.0

    # -- serving-plane query traces ------------------------------------------

    def record_query(
        self,
        name: str,
        t0: float,
        t1: float,
        commit_time: int = 0,
        **args: Any,
    ) -> dict | None:
        """Record one served query (or query micro-batch) as a standalone
        ``kind="serving"`` trace in the same ring.

        Queries run on serving threads CONCURRENTLY with commits, so
        they never touch the single-slot commit context (``_ctx``) —
        each call assembles its own one-span trace.  Sampling uses its
        own counter at the same interval, so query volume cannot starve
        commit traces (and vice versa).  ``commit_time`` is the served
        snapshot's commit time: ``cli trace`` correlates query spans
        with the commit that published their view."""
        if not self.enabled:
            return None
        with self._lock:
            self._query_count += 1
            if (self._query_count - 1) % self.interval:
                return None
        origin_wall = perf_to_wall(t0)
        end_wall = perf_to_wall(t1)
        span: dict = {
            "name": name,
            "cat": "serving",
            "ts": _us(origin_wall),
            "dur": max(0, int((t1 - t0) * 1e6)),
            "pid": self.worker_id,
        }
        if args:
            span["args"] = dict(args)
        trace: dict = {
            "kind": "serving",
            "trace_id": (
                f"q{self.worker_id:02d}-{os.getpid():x}"
                f"-{self._query_count:06x}"
            ),
            "commit_time": int(commit_time),
            "epoch": self.epoch,
            "worker": self.worker_id,
            "origin_wall": origin_wall,
            "begin_wall": origin_wall,
            "end_wall": end_wall,
            "spans": [span],
            "workers": {},
            "sink_rows": 0,
            "dropped_spans": 0,
            "device_kernel_ns": {},
            "device_s": 0.0,
        }
        trace["critical_path"] = critical_path(trace)
        with self._lock:
            self._traces.append(trace)
        return trace

    # -- read-tier request traces --------------------------------------------

    def begin_request(self, endpoint: str) -> RequestTrace | None:
        """Root-side sampling decision for one read-tier request.

        The first request is always sampled (a single smoke query must
        yield a trace), then every ``request_interval``-th; the counter
        is lock-guarded because requests land on concurrent handler
        threads.  The context lives in a thread-local slot for the
        handler's duration."""
        if not self.request_enabled:
            return None
        t0 = _time.perf_counter()
        with self._lock:
            self._request_count += 1
            count = self._request_count
        if (count - 1) % self.request_interval:
            return None
        ctx = RequestTrace(
            trace_id=f"r{self.worker_id:02d}-{os.getpid():x}-{count:06x}",
            endpoint=endpoint,
        )
        self._req_local.ctx = ctx
        ctx.overhead_s += _time.perf_counter() - t0
        return ctx

    def adopt_request(
        self, header_value: str | None, endpoint: str = ""
    ) -> RequestTrace | None:
        """Downstream-hop side: adopt the caller's trace context from an
        ``X-Pathway-Trace`` header.  The ROOT owns the sampling
        decision, so a sampled header is honored even when this
        process's own request tracing is off (a traced federation
        front can stitch through untraced workers)."""
        parsed = parse_trace_header(header_value)
        if parsed is None or not parsed[2]:
            return None
        ctx = RequestTrace(
            trace_id=parsed[0],
            endpoint=endpoint,
            parent_span=parsed[1],
            remote=True,
        )
        self._req_local.ctx = ctx
        return ctx

    def current_request(self) -> RequestTrace | None:
        """This thread's in-flight request trace, or None — the guard
        every read-tier instrumentation site checks first."""
        return getattr(self._req_local, "ctx", None)

    def take_request_spans(self) -> list[dict]:
        """A remote hop's accumulated spans, for the response-header
        piggyback back to the caller."""
        ctx = self.current_request()
        return ctx.take_spans() if ctx is not None else []

    def drop_request(self) -> None:
        """Clear this thread's request slot — called unconditionally in
        handler ``finally`` blocks so pooled serving threads never leak
        a context into the next request they pick up."""
        self._req_local.ctx = None

    def end_request(
        self, ctx: RequestTrace | None, status: int = 200, **fields: Any
    ) -> dict | None:
        """Root-side request end: assemble the trace (local + merged
        remote spans, each on its own per-process track), attribute the
        critical path, ring it, and feed the request sampler."""
        self._req_local.ctx = None
        if ctx is None or ctx.remote:
            return None
        t_end = _time.perf_counter()
        end_wall = perf_to_wall(t_end)
        with ctx._lock:
            spans = list(ctx.spans)
            dropped = ctx.dropped
        trace: dict = {
            "kind": "request",
            "trace_id": ctx.trace_id,
            "endpoint": ctx.endpoint,
            "status": int(status),
            "commit_time": int(fields.pop("commit_time", 0) or 0),
            "epoch": self.epoch,
            "worker": ctx.track,
            "origin_wall": ctx.origin_wall,
            "begin_wall": ctx.begin_wall,
            "end_wall": end_wall,
            "spans": spans,
            "workers": {},
            "sink_rows": 0,
            "dropped_spans": dropped,
            "device_kernel_ns": {},
            "device_s": 0.0,
        }
        if fields:
            trace["request"] = dict(fields)
        trace["critical_path"] = critical_path(trace)
        with self._lock:
            self._traces.append(trace)
        overhead = ctx.overhead_s + (_time.perf_counter() - t_end)
        self._adapt_request(
            overhead, max(end_wall - ctx.begin_wall, 0.0)
        )
        return trace

    def _adapt_request(self, overhead_s: float, wall_s: float) -> None:
        """Same EMA-doubling discipline as :meth:`_adapt`, on the
        request sampler's own interval so query floods cannot push the
        commit sampler around (and vice versa)."""
        amortized = overhead_s / max(1, self.request_interval)
        ratio = amortized / max(wall_s, 1e-6)
        ema = self._req_overhead_ema
        self._req_overhead_ema = (
            ratio if ema is None else 0.5 * ema + 0.5 * ratio
        )
        if self._req_overhead_ema > OVERHEAD_TARGET:
            self.request_interval = min(self.request_interval * 2, 4096)
            self._req_overhead_ema /= 2.0
        elif (
            self.request_interval > self.request_base_interval
            and self._req_overhead_ema < OVERHEAD_TARGET / 4.0
        ):
            self.request_interval = max(
                self.request_base_interval, self.request_interval // 2
            )
            self._req_overhead_ema *= 2.0

    # -- read side -----------------------------------------------------------

    def traces(self) -> list[dict]:
        with self._lock:
            return list(self._traces)

    def active_trace_id(self) -> str | None:
        ctx = self._ctx
        return ctx.trace_id if ctx is not None else None

    def summary(self) -> dict:
        """Structured roll-up for bench JSON: trace count, span volume,
        the mean critical-path buckets, and the last commit's full
        breakdown.  Serving-plane query traces are rolled up separately
        (``query_traces`` / ``query_ms_mean``) so query latency cannot
        skew the commit critical-path means."""
        all_traces = self.traces()
        queries = [t for t in all_traces if t.get("kind") == "serving"]
        requests = [t for t in all_traces if t.get("kind") == "request"]
        traces = [
            t
            for t in all_traces
            if t.get("kind") not in ("serving", "request")
        ]
        query_summary: dict = {}
        if queries:
            query_summary = {
                "query_traces": len(queries),
                "query_ms_mean": round(
                    sum(
                        (t["end_wall"] - t["origin_wall"]) for t in queries
                    )
                    / len(queries)
                    * 1000.0,
                    3,
                ),
            }
        if requests:
            query_summary["request_traces"] = len(requests)
            query_summary["request_ms_mean"] = round(
                sum((t["end_wall"] - t["origin_wall"]) for t in requests)
                / len(requests)
                * 1000.0,
                3,
            )
            query_summary["request_sample_interval"] = self.request_interval
        if not traces:
            return {
                "traces": 0,
                "sample_interval": self.interval,
                **query_summary,
            }
        n = len(traces)
        keys = (
            "wall_s",
            "host_compute_s",
            "exchange_s",
            "queue_wait_s",
            "device_s",
        )
        mean = {
            k: round(sum(t["critical_path"][k] for t in traces) / n, 6)
            for k in keys
        }
        # mean bucket shares as fractions of the mean wall — computed
        # from the means (not averaged per-trace) so older ring entries
        # without a "shares" field cannot skew the roll-up
        mean["shares"] = _bucket_shares(
            mean["wall_s"],
            mean["host_compute_s"],
            mean["exchange_s"],
            mean["queue_wait_s"],
            mean["device_s"],
        )
        spans = sum(
            len(t["spans"]) + sum(len(v) for v in t["workers"].values())
            for t in traces
        )
        return {
            "traces": n,
            "spans": spans,
            "sample_interval": self.interval,
            "critical_path_mean": mean,
            "last": traces[-1]["critical_path"],
            **query_summary,
        }

    def export(self, directory: str | None = None) -> str | None:
        """Dump the ring as one Chrome trace-event JSON file
        (``pathway_trace_p<worker>_pid<pid>_<n>.json``) into
        ``directory`` / ``PATHWAY_TPU_TRACE_DIR`` / the system temp
        dir.  Returns the path, or None when there is nothing to dump
        or the dump itself fails (export must never mask a run)."""
        traces = self.traces()
        if not traces:
            return None
        try:
            directory = (
                directory
                or os.environ.get("PATHWAY_TPU_TRACE_DIR")
                or tempfile.gettempdir()
            )
            os.makedirs(directory, exist_ok=True)
            self._export_seq += 1
            path = os.path.join(
                directory,
                f"pathway_trace_p{self.worker_id}"
                f"_pid{os.getpid()}_{self._export_seq:03d}.json",
            )
            payload = chrome_trace(traces)
            payload["otherData"] = {
                "worker": self.worker_id,
                "pid": os.getpid(),
                "traces": [
                    {
                        "trace_id": t["trace_id"],
                        "kind": t.get("kind", "commit"),
                        "commit_time": t["commit_time"],
                        "epoch": t["epoch"],
                        "sink_rows": t["sink_rows"],
                        "critical_path": t["critical_path"],
                        **(
                            {"spans": t["spans"]}
                            if t.get("kind") in ("serving", "request")
                            else {}
                        ),
                        **(
                            {
                                "endpoint": t.get("endpoint", ""),
                                "status": t.get("status", 0),
                                "request": t.get("request", {}),
                            }
                            if t.get("kind") == "request"
                            else {}
                        ),
                    }
                    for t in traces
                ],
            }
            with open(path, "w") as fh:
                json.dump(payload, fh, default=repr)
            return path
        except Exception:
            return None


# -- critical-path attribution ------------------------------------------------


def critical_path(trace: dict) -> dict:
    """Bucket a trace's wall time (origin -> commit end) into
    queue-wait / exchange / device / host-compute, plus the serialized
    chain of significant spans in timestamp order.

    The buckets sum to ``wall_s`` exactly by construction: queue-wait is
    the ingest wait (begin - origin) plus ``cat="wait"`` spans, exchange
    is the ``cat="exchange"`` spans (none on one worker), device is the
    ``kernel_ns`` delta of both kernel planes, and host-compute is the
    residual (clamped at zero, flagged via ``clamped``)."""
    wall = max(1e-9, trace["end_wall"] - trace["origin_wall"])
    queue = max(0.0, trace["begin_wall"] - trace["origin_wall"])
    exchange = 0.0
    for s in trace["spans"]:
        cat = s.get("cat")
        dur = s.get("dur", 0) / 1e6
        if cat == "wait":
            queue += dur
        elif cat == "exchange":
            exchange += dur
    device = float(trace.get("device_s", 0.0))
    host = wall - queue - exchange - device
    clamped = host < 0.0
    host = max(0.0, host)
    chain: list[dict] = []
    for s in sorted(trace["spans"], key=lambda s: s["ts"]):
        if s.get("cat") == "commit":
            continue
        dur_ms = s.get("dur", 0) / 1000.0
        if dur_ms >= wall * 1000.0 * 0.01 or s.get("cat") in (
            "wait",
            "exchange",
            "queue",
        ):
            chain.append(
                {
                    "name": s["name"],
                    "cat": s.get("cat", ""),
                    "ms": round(dur_ms, 3),
                }
            )
            if len(chain) >= 64:
                break
    return {
        "wall_s": round(wall, 6),
        "host_compute_s": round(host, 6),
        "exchange_s": round(exchange, 6),
        "queue_wait_s": round(queue, 6),
        "device_s": round(device, 6),
        # per-bucket shares as fractions of commit wall: the docs/s
        # trajectory and the bucket trajectory stay comparable across
        # BENCH_r* files regardless of absolute commit duration
        "shares": _bucket_shares(wall, host, exchange, queue, device),
        "clamped": clamped,
        "chain": chain,
    }


def _bucket_shares(
    wall: float, host: float, exchange: float, queue: float, device: float
) -> dict:
    w = max(wall, 1e-9)
    return {
        "host_compute": round(host / w, 4),
        "exchange": round(exchange / w, 4),
        "queue_wait": round(queue / w, 4),
        "device": round(device / w, 4),
    }


# -- Chrome trace-event export ------------------------------------------------


def chrome_trace(traces: list[dict]) -> dict:
    """Render assembled traces as a Chrome trace-event JSON object
    (Perfetto/chrome://tracing loadable): complete ``"X"`` events on one
    track per worker (``pid``/``tid`` = worker id), a root ``commit``
    span per worker per trace for containment parentage, and ``"M"``
    metadata events naming the tracks.  Events are sorted by timestamp,
    so each track's sequence is monotonic — the invariant
    :func:`validate_chrome_trace` checks."""
    events: list[dict] = []
    pids: set[int] = set()
    for trace in traces:
        groups: dict[int, list[dict]] = {}
        for s in trace["spans"]:
            groups.setdefault(int(s.get("pid", trace["worker"])), []).append(s)
        for peer, spans in trace["workers"].items():
            for s in spans:
                groups.setdefault(int(s.get("pid", peer)), []).append(s)
        for wid, spans in sorted(groups.items()):
            if not spans:
                continue
            pids.add(wid)
            start = min(s["ts"] for s in spans)
            end = max(s["ts"] + s.get("dur", 0) for s in spans)
            root_args: dict = {
                "trace": trace["trace_id"],
                "commit_time": trace["commit_time"],
            }
            if wid == trace["worker"]:
                root_args["critical_path"] = {
                    k: v
                    for k, v in trace["critical_path"].items()
                    if k != "chain"
                }
                if trace["device_kernel_ns"]:
                    root_args["device_kernel_ns"] = trace["device_kernel_ns"]
            events.append(
                {
                    "name": (
                        f"query @{trace['commit_time']}"
                        if trace.get("kind") == "serving"
                        else f"request {trace.get('endpoint') or '?'}"
                        if trace.get("kind") == "request"
                        else f"commit {trace['commit_time']}"
                    ),
                    "cat": "commit",
                    "ph": "X",
                    "ts": start,
                    "dur": max(0, end - start),
                    "pid": wid,
                    "tid": wid,
                    "args": root_args,
                }
            )
            for s in spans:
                ev = {
                    "name": s["name"],
                    "cat": s.get("cat", ""),
                    "ph": "X",
                    "ts": s["ts"],
                    "dur": s.get("dur", 0),
                    "pid": wid,
                    "tid": wid,
                    "args": dict(
                        s.get("args") or {}, trace=trace["trace_id"]
                    ),
                }
                events.append(ev)
    # a root span shares its start ts with its first child: emit the
    # longer (enclosing) event first so viewers nest them correctly
    events.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
    meta = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": wid,
            "tid": wid,
            "args": {"name": f"worker {wid}"},
        }
        for wid in sorted(pids)
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def validate_chrome_trace(obj: Any) -> list[dict]:
    """Strict Chrome trace-event conformance check: the object is a ``{"traceEvents": [...]}``
    dict or a bare event list; every event is ``"X"`` (with a numeric
    non-negative ``dur``), a matched ``"B"``/``"E"`` pair, or ``"M"``
    metadata; and timestamps are monotonic non-decreasing per
    ``(pid, tid)`` track.  Returns the event list; raises
    ``ValueError`` on any violation."""
    if isinstance(obj, list):
        events = obj
    elif isinstance(obj, dict):
        events = obj.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError("trace object has no traceEvents list")
    else:
        raise ValueError(f"not a trace object: {type(obj).__name__}")
    last_ts: dict[tuple, float] = {}
    open_begins: dict[tuple, list] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        ph = ev.get("ph")
        if ph == "M":
            continue
        if ph not in ("X", "B", "E"):
            raise ValueError(f"event {i}: unsupported phase {ph!r}")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            raise ValueError(f"event {i}: missing/non-numeric ts")
        track = (ev.get("pid"), ev.get("tid"))
        if ts < last_ts.get(track, float("-inf")):
            raise ValueError(
                f"event {i}: non-monotonic ts on track {track}"
            )
        last_ts[track] = ts
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(
                    f"event {i}: X event needs a non-negative dur"
                )
        elif ph == "B":
            open_begins.setdefault(track, []).append(ev.get("name"))
        else:  # "E"
            stack = open_begins.get(track)
            if not stack:
                raise ValueError(
                    f"event {i}: E without a matching B on track {track}"
                )
            stack.pop()
    for track, stack in open_begins.items():
        if stack:
            raise ValueError(
                f"track {track}: unclosed B events {stack!r}"
            )
    return events


#: the process-wide recorder every instrumented hot path consults
TRACER = TraceRecorder()


def current() -> TraceContext | None:
    """The active sampled-commit context, or None — THE hot-path guard;
    call once per batch/sweep, not per row."""
    return TRACER._ctx


def _active_trace_id() -> str | None:
    rctx = TRACER.current_request()
    if rctx is not None:
        return rctx.trace_id
    ctx = TRACER._ctx
    return ctx.trace_id if ctx is not None else None


# flight-recorder integration: every event recorded (and every dump
# written) while a sampled commit is in flight references its trace id
_metrics.set_trace_id_provider(_active_trace_id)
