"""Concurrent HTTP query front over the snapshot store.

Counterpart of ``pathway_tpu/serving/server.py``. The read plane's port scheme is the
monitoring endpoint's, one block up: each process serves its own shard's snapshots on
``21000 + PATHWAY_PROCESS_ID`` (``PATHWAY_TPU_SERVING_PORT_BASE`` overrides the base),
loopback only. Three mechanisms keep concurrent queries off the dataflow's back:

- **Admission control**: accepted connections enter a bounded queue drained by a fixed
  thread pool; when the queue is full the connection is shed at once with ``503`` +
  ``Retry-After``, and an admitted request is always answered.
- **Micro-batching**: concurrently arriving KNN queries are packed into one snapshot
  ``search`` call (one top-k launch on the card for a view there), up to the batch size
  of the device pipeline's adaptive controller, within a short packing window
  (``PATHWAY_TPU_SERVING_BATCH_WINDOW_MS``). A batch of n rows may round apart from n
  batches of one row in the card's matmul; on the host the search is exact.
- **Snapshot reads**: every answer comes from a refcounted immutable
  :class:`~pathway_tpu_torch.serving.snapshot.ReadSnapshot`; queries touch no operator
  state and hold no scheduler lock.

An error in a batched search (a CUDA error, a view used after reclamation) is handed to
every waiter of that batch and raised on its handler thread, so the client gets a 5xx:
never an empty hit list. ``_suggested_batch`` reads the pipeline's controller with no
``try`` around it: the port's ``device_pipeline.PIPELINE`` always exists, where the
reference falls back to 1024 on any error (ROADMAP: deliberate differences).

Endpoints (all JSON):

- ``GET  /serving/health``  — liveness + snapshot seq/commit/staleness
- ``GET  /serving/stats``   — request/shed counters, latency quantiles
- ``POST /serving/query``   — ``{"vector": [...] | "vectors": [[...]],
  "k": 10}`` -> KNN hits from the newest snapshot
- ``POST /serving/lookup``  — ``{"keys": [...]}`` -> operator rows by
  repr-stringified key (point reads on groupby/join state)
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time as _time
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

from pathway_tpu_torch.engine import device_pipeline as _device_pipeline
from pathway_tpu_torch.internals import metrics as _metrics
from pathway_tpu_torch.internals import tracing as _tracing
from pathway_tpu_torch.serving import result_cache as _result_cache
from pathway_tpu_torch.serving import snapshot as _snapshot
from pathway_tpu_torch.serving.snapshot import StaleReadError

__all__ = ["QueryServer", "BASE_PORT", "serving_port"]

BASE_PORT = 21000

_LAT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5,
)

_REQS = {
    ep: _metrics.REGISTRY.counter(
        "pathway_serving_requests_total",
        "admitted serving requests by endpoint",
        endpoint=ep,
    )
    for ep in ("query", "lookup", "health", "stats", "other")
}
_SHED = _metrics.REGISTRY.counter(
    "pathway_serving_shed_total",
    "connections shed at admission (503 + Retry-After)",
)
_LATENCY = _metrics.REGISTRY.histogram(
    "pathway_serving_latency_seconds",
    "per-request serving latency (admission to response flush)",
    buckets=_LAT_BUCKETS,
)
_BATCHED = _metrics.REGISTRY.histogram(
    "pathway_serving_batch_queries",
    "KNN queries packed per snapshot search dispatch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
)
_EMPTY = _metrics.REGISTRY.counter(
    "pathway_serving_no_snapshot_total",
    "admitted queries answered 200-with-empty because no snapshot exists yet",
)
_STALE = _metrics.REGISTRY.counter(
    "pathway_serving_stale_503_total",
    "admitted requests answered 503 because the store's freshest "
    "consistent view exceeded its staleness bound",
)

_ERRORS = _metrics.REGISTRY.counter(
    "pathway_serving_errors_total",
    "admitted requests answered 500 because the search itself failed",
)

_started_wall: list[float] = []  # first QueryServer.start() in this process


def _collect_uptime():
    if _started_wall:
        yield (
            "pathway_serving_uptime_seconds",
            "gauge",
            "seconds since this process's query server started",
            {},
            _time.time() - _started_wall[0],
        )


_metrics.REGISTRY.register_collector(_collect_uptime)


def serving_port(process_id: int | None = None) -> int:
    base = int(os.environ.get("PATHWAY_TPU_SERVING_PORT_BASE", BASE_PORT))
    if process_id is None:
        process_id = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
    return base + process_id


def stamp_header_value(stamp) -> str:
    """Deterministic ``X-Pathway-Stamp`` value from a cache stamp
    (``(commit_time, seq-or-cut, fingerprint)``): the commit identity
    without the fingerprint, compact-JSON so a hit and a miss answered
    at the same stamp carry byte-identical headers."""
    try:
        return json.dumps(
            list(stamp[:2]), separators=(",", ":"), default=repr
        )
    except Exception:
        return repr(stamp)


def _suggested_batch() -> int:
    """Micro-batch capacity from the device pipeline's adaptive
    controller — when the device side is backpressured the controller
    grows its batches, and serving follows so queries amortize into
    fewer top_k dispatches."""
    return max(1, int(_device_pipeline.PIPELINE.controller.batch_size))


class _MicroBatcher:
    """Packs concurrently-arriving KNN queries into one snapshot search."""

    def __init__(self, store: "_snapshot.SnapshotStore", window_s: float):
        self.store = store
        self.window_s = max(0.0, window_s)
        self._cv = threading.Condition()
        self._pending: list[dict] = []  # guarded-by: self._cv
        self._stop = False  # guarded-by: self._cv
        self._thread: threading.Thread | None = None
        self.dispatches = 0

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="pw-serving-batcher", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def submit(self, vectors: np.ndarray, k: int, timeout: float = 30.0):
        """Enqueue ``vectors`` ([n, dim]) and block until the batcher
        answers.  Returns ``(hits, snapshot_meta)``; hits is None only
        when no snapshot has ever been published."""
        item = {
            "vecs": vectors,
            "k": int(k),
            "event": threading.Event(),
            "hits": None,
            "meta": None,
            "error": None,
        }
        with self._cv:
            self._pending.append(item)
            self._cv.notify_all()
        if not item["event"].wait(timeout):
            raise TimeoutError("serving batcher did not answer in time")
        if item["error"] is not None:
            raise item["error"]
        return item["hits"], item["meta"]

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait(0.25)
                if self._stop:
                    pending, self._pending = self._pending, []
                else:
                    # packing window: wait briefly for more arrivals, up
                    # to the controller-suggested batch capacity
                    cap = _suggested_batch()
                    deadline = _time.perf_counter() + self.window_s
                    while (
                        sum(len(i["vecs"]) for i in self._pending) < cap
                        and not self._stop
                    ):
                        left = deadline - _time.perf_counter()
                        if left <= 0:
                            break
                        self._cv.wait(left)
                    pending, self._pending = self._pending, []
            if not pending:
                if self._stop:
                    return
                continue
            self._dispatch(pending)
            if self._stop:
                with self._cv:
                    leftover, self._pending = self._pending, []
                if leftover:
                    self._dispatch(leftover)
                return

    def _dispatch(self, pending: list[dict]) -> None:
        t0 = _time.perf_counter()
        snap = None
        try:
            # inside the try: a raising store (a replica past its
            # staleness bound) must fail the waiters, not this thread
            snap = self.store.acquire_latest()
            t_pin = _time.perf_counter()
            n = sum(len(i["vecs"]) for i in pending)
            if snap is None:
                for item in pending:
                    item["hits"] = None
                    item["meta"] = None
                return
            max_k = max(i["k"] for i in pending)
            flat = [vec for item in pending for vec in item["vecs"]]
            try:
                results = snap.search(flat, max_k)
            except LookupError as exc:
                for item in pending:
                    item["error"] = exc
                return
            t_search = _time.perf_counter()
            meta = {
                "seq": snap.seq,
                "commit_time": snap.commit_time,
                "staleness_s": round(snap.staleness_s(), 6),
                # stripped by the handler before serialization: the
                # result cache only inserts when the snapshot actually
                # answered matches the stamp it keyed the lookup on
                "cache_stamp": snap.cache_stamp(),
                # stripped likewise: (name, cat, t0, t1, args) tuples the
                # handler replays into its request trace — the batcher
                # thread has no request context, the waiters do
                "_req_spans": [
                    (
                        # a ReplicaStore pin waits for a consistent cut;
                        # a plain SnapshotStore pin is a refcount bump
                        (
                            "cut-wait"
                            if hasattr(self.store, "lag_s")
                            else "snapshot-pin"
                        ),
                        "wait",
                        t0,
                        t_pin,
                        {"seq": snap.seq, "commit_time": snap.commit_time},
                    ),
                    (
                        "search",
                        "serving",
                        t_pin,
                        t_search,
                        {"queries": n, "k": max_k},
                    ),
                ],
            }
            self.dispatches += 1
            _BATCHED.observe_n(float(n), 1)
            pos = 0
            for item in pending:
                rows = results[pos : pos + len(item["vecs"])]
                item["hits"] = [r[: item["k"]] for r in rows]
                # a COPY per waiter: handlers pop cache_stamp/_req_spans
                # from their own meta, so concurrent batch-mates never
                # race on one shared dict
                item["meta"] = dict(meta)
                pos += len(item["vecs"])
            _tracing.TRACER.record_query(
                "knn-batch",
                t0,
                _time.perf_counter(),
                commit_time=snap.commit_time,
                queries=n,
                requests=len(pending),
                k=max_k,
            )
        except Exception as exc:  # noqa: BLE001 — fail the waiters, not the loop
            for item in pending:
                if item["error"] is None and item["hits"] is None:
                    item["error"] = exc
        finally:
            if snap is not None:
                snap.release()
            for item in pending:
                item["event"].set()


class _Handler(BaseHTTPRequestHandler):
    # default HTTP/1.0 + Connection: close — one bounded-pool turn per
    # connection, so admission control maps 1:1 to requests
    server_version = "PathwayServing/1.0"

    #: per-request trace context / wide-event state; handler instances
    #: are per-connection (HTTP/1.0 + close => per-request)
    _rctx = None
    _last_status = 0

    def log_message(self, fmt: str, *args) -> None:  # noqa: A003
        pass  # the metrics registry is the access log

    # -- helpers -------------------------------------------------------------

    def _json(
        self, code: int, payload: dict, headers: dict | None = None
    ) -> None:
        self._raw_json(code, json.dumps(payload).encode(), headers)

    def _raw_json(
        self, code: int, body: bytes, headers: dict | None = None
    ) -> None:
        """Send pre-serialized JSON bytes — the result-cache hit path
        writes the cached body verbatim, skipping re-serialization."""
        self._last_status = code
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        rctx = self._rctx
        if rctx is not None:
            if rctx.remote:
                # downstream hop: piggyback this hop's spans back to
                # the caller that owns the trace
                payload = _tracing.encode_spans(rctx.take_spans())
                if payload is not None:
                    self.send_header(_tracing.SPANS_HEADER, payload)
            else:
                # root: echo the trace id so clients/benches can join
                # the response to the exported trace
                self.send_header(_tracing.TRACE_HEADER, rctx.trace_id)
        self.end_headers()
        self.wfile.write(body)

    def _stale(self, exc: StaleReadError) -> None:
        _STALE.inc()
        _metrics.FLIGHT.record(
            "serving_stale_503",
            port=self.server.server_port,
            error=str(exc),
        )
        self._wide["refusal"] = "stale"
        self._json(
            503,
            {"error": str(exc), "stale": True},
            headers={"Retry-After": "1"},
        )

    def _server_error(self, exc: BaseException) -> None:
        _ERRORS.inc()
        _metrics.FLIGHT.record(
            "serving_error", port=self.server.server_port, error=repr(exc)
        )
        self._wide["refusal"] = "error"
        try:
            self._json(500, {"error": repr(exc)})
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b"{}"
        return json.loads(raw or b"{}")

    # -- endpoints -----------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 — http.server contract
        t0 = _time.perf_counter()
        try:
            if self.path.startswith("/serving/health"):
                _REQS["health"].inc()
                self._json(200, dict(self.server.store.stats(), ok=True))
            elif self.path.startswith("/serving/stats"):
                _REQS["stats"].inc()
                self._json(200, self.server.serving_stats())
            else:
                _REQS["other"].inc()
                self._json(404, {"error": f"unknown path {self.path}"})
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            _LATENCY.observe(_time.perf_counter() - t0)

    def do_POST(self) -> None:  # noqa: N802 — http.server contract
        t0 = _time.perf_counter()
        self._wide = {}
        if self.path.startswith("/serving/query"):
            endpoint = "query"
        elif self.path.startswith("/serving/lookup"):
            endpoint = "lookup"
        else:
            endpoint = "other"
        tracer = _tracing.TRACER
        # a sampled upstream header wins (the root owns the sampling
        # decision); otherwise this hop is its own root candidate
        rctx = tracer.adopt_request(
            self.headers.get(_tracing.TRACE_HEADER), endpoint
        )
        if rctx is None and endpoint != "other":
            rctx = tracer.begin_request(endpoint)
        self._rctx = rctx
        if rctx is not None:
            admit = getattr(self.server, "_admit_local", None)
            enq = getattr(admit, "enq", None)
            deq = getattr(admit, "deq", None)
            if enq is not None and deq is not None and deq > enq:
                rctx.span("admission-queue", "wait", enq, deq)
        try:
            if endpoint == "query":
                _REQS["query"].inc()
                self._query(t0)
            elif endpoint == "lookup":
                _REQS["lookup"].inc()
                self._lookup(t0)
            else:
                _REQS["other"].inc()
                self._json(404, {"error": f"unknown path {self.path}"})
        except (BrokenPipeError, ConnectionResetError):
            pass
        except StaleReadError as exc:
            # a replica past its staleness bound: refuse loudly rather
            # than answer wrong — 503 + Retry-After, never a 5xx crash
            try:
                self._stale(exc)
            except (BrokenPipeError, ConnectionResetError):
                pass
        except (ValueError, KeyError, TypeError) as exc:
            # malformed request — a client error, not a serving failure
            try:
                self._json(400, {"error": repr(exc)})
            except (BrokenPipeError, ConnectionResetError):
                pass
        except Exception as exc:  # noqa: BLE001 — a failed search is answered, never dropped
            # the search itself failed (a CUDA error, a view read after
            # reclamation): the client gets a 500 naming it, never an
            # empty hit list or a closed socket
            self._server_error(exc)
        finally:
            dt = _time.perf_counter() - t0
            _LATENCY.observe(dt)
            if rctx is not None:
                _LATENCY.exemplar(dt, rctx.trace_id)
                # wide event BEFORE the context is torn down, so the
                # trace-id provider still sees it
                _metrics.REQUESTS.record(
                    endpoint=endpoint,
                    status=self._last_status,
                    port=self.server.server_port,
                    ns=int(dt * 1e9),
                    **self._wide,
                )
                tracer.end_request(
                    rctx, status=self._last_status, **self._wide
                )
            tracer.drop_request()

    def _query(self, t0: float) -> None:
        req = self._body()
        if "vectors" in req:
            vecs = np.asarray(req["vectors"], np.float32)
        else:
            vecs = np.asarray([req["vector"]], np.float32)
        if vecs.ndim != 2:
            raise ValueError("vector(s) must be rank-1 / rank-2")
        k = int(req.get("k", 10))
        key = self._cache_key(
            "query",
            vecs.tobytes() + b"|" + repr((vecs.shape, k)).encode(),
        )
        if key is not None:
            tc0 = _time.perf_counter()
            cached = _result_cache.CACHE.get(key)
            self._note_cache(
                "hit" if cached is not None else "miss", key[1], tc0
            )
            if cached is not None:
                # hot path: cached answers never touch the batcher or
                # pin a snapshot — serialized bytes straight back out
                self._raw_json(
                    200,
                    cached,
                    {
                        "X-Pathway-Cache": "hit",
                        "X-Pathway-Stamp": stamp_header_value(key[1]),
                    },
                )
                _result_cache.CACHE.observe_hit_latency(
                    _time.perf_counter() - t0
                )
                return
        hits, meta = self.server.batcher.submit(vecs, k)
        self._replay_batch_spans(meta)
        if hits is None:
            # admitted before the first commit: answer empty-but-valid
            # (stale by definition), never a 5xx
            _EMPTY.inc()
            self._json(
                200,
                {"hits": [[] for _ in range(len(vecs))], "snapshot": None},
                headers={"X-Pathway-Cache": "miss"},
            )
            return
        answered = meta.pop("cache_stamp", None)
        body = json.dumps(
            {
                "hits": [
                    [[repr(key_), score] for key_, score in row]
                    for row in hits
                ],
                "snapshot": meta,
            }
        ).encode()
        self._maybe_insert(key, answered, body)
        self._wide["commit_time"] = meta.get("commit_time")
        headers = {"X-Pathway-Cache": "miss"}
        if answered is not None:
            headers["X-Pathway-Stamp"] = stamp_header_value(answered)
        self._raw_json(200, body, headers)

    def _note_cache(self, disposition: str, stamp, t0: float) -> None:
        """Cache-disposition span + wide-event fields for one lookup."""
        self._wide["cache"] = disposition
        self._wide["stamp"] = repr(stamp[:2])
        rctx = self._rctx
        if rctx is not None:
            rctx.span(
                "result-cache",
                "serving",
                t0,
                _time.perf_counter(),
                disposition=disposition,
            )

    def _replay_batch_spans(self, meta: dict | None) -> None:
        """Pull the batcher's span tuples out of this waiter's meta copy
        and replay them into the request trace (the batcher thread has
        no request context; the handler thread does)."""
        spans = meta.pop("_req_spans", None) if meta else None
        rctx = self._rctx
        if rctx is not None and spans:
            for name, cat, s0, s1, sargs in spans:
                rctx.span(name, cat, s0, s1, **sargs)

    def _cache_key(self, endpoint: str, material: bytes):
        """Commit-stamped cache key, or None when caching is off or no
        snapshot exists yet.  The stamp embeds commit time, seq, and
        the rewrite fingerprint — invalidation by publication."""
        if not _result_cache.enabled():
            return None
        stamp = self.server.store.stamp()
        if stamp is None:
            return None
        # the port disambiguates servers sharing one process-wide cache
        # (in-process meshes/tests run several stores side by side)
        return (
            endpoint,
            stamp,
            _result_cache.query_digest(endpoint, material),
            self.server.server_port,
        )

    def _maybe_insert(self, key, answered_stamp, body: bytes) -> None:
        """Insert only when the snapshot that actually answered is the
        one the key was stamped with — a publication racing between the
        stamp peek and the dispatch must not be cached under the old
        stamp (its recompute would differ bit-for-bit)."""
        if key is None or answered_stamp is None:
            return
        if answered_stamp != key[1]:
            return
        _result_cache.CACHE.put(
            key, body, len(body), commit_time=answered_stamp[0]
        )

    def _lookup(self, t0: float | None = None) -> None:
        if t0 is None:
            t0 = _time.perf_counter()
        req = self._body()
        keys = [str(key) for key in req.get("keys", [])]
        node = req.get("node")
        key = self._cache_key(
            "lookup",
            json.dumps({"keys": keys, "node": node}, sort_keys=True).encode(),
        )
        if key is not None:
            tc0 = _time.perf_counter()
            cached = _result_cache.CACHE.get(key)
            self._note_cache(
                "hit" if cached is not None else "miss", key[1], tc0
            )
            if cached is not None:
                self._raw_json(
                    200,
                    cached,
                    {
                        "X-Pathway-Cache": "hit",
                        "X-Pathway-Stamp": stamp_header_value(key[1]),
                    },
                )
                _result_cache.CACHE.observe_hit_latency(
                    _time.perf_counter() - t0
                )
                return
        t_pin0 = _time.perf_counter()
        snap = self.server.store.acquire_latest()
        if snap is None:
            _EMPTY.inc()
            self._json(
                200,
                {"rows": {}, "snapshot": None},
                headers={"X-Pathway-Cache": "miss"},
            )
            return
        rctx = self._rctx
        if rctx is not None:
            rctx.span(
                (
                    "cut-wait"
                    if hasattr(self.server.store, "lag_s")
                    else "snapshot-pin"
                ),
                "wait",
                t_pin0,
                _time.perf_counter(),
                seq=snap.seq,
                commit_time=snap.commit_time,
            )
        try:
            t1 = _time.perf_counter()
            table = {repr(key_): row for key_, row in snap.table(node).items()}
            rows = (
                {key_: table.get(key_) for key_ in keys} if keys else table
            )
            meta = {
                "seq": snap.seq,
                "commit_time": snap.commit_time,
                "staleness_s": round(snap.staleness_s(), 6),
            }
            answered = snap.cache_stamp()
            t2 = _time.perf_counter()
            _tracing.TRACER.record_query(
                "table-lookup",
                t1,
                t2,
                commit_time=snap.commit_time,
                keys=len(keys),
            )
            if rctx is not None:
                rctx.span(
                    "table-lookup", "serving", t1, t2, keys=len(keys)
                )
        finally:
            snap.release()
        body = json.dumps({"rows": rows, "snapshot": meta}).encode()
        self._maybe_insert(key, answered, body)
        self._wide["commit_time"] = meta.get("commit_time")
        headers = {"X-Pathway-Cache": "miss"}
        if answered is not None:
            headers["X-Pathway-Stamp"] = stamp_header_value(answered)
        self._raw_json(200, body, headers)


class _BoundedHTTPServer(HTTPServer):
    """HTTP server with bounded-queue admission and a fixed worker pool.

    ``process_request`` (the accept-loop side) either enqueues the
    connection or sheds it with a raw 503 — it never blocks and never
    spawns a thread per connection, so a query flood degrades into fast
    503s instead of an unbounded thread pile-up."""

    allow_reuse_address = True
    daemon_threads = True
    # shedding is OUR bounded queue's job: a deep listen backlog keeps
    # the kernel from dropping SYNs under bursts (a dropped SYN costs
    # the client a ~1s retransmit, which would read as serving latency)
    request_queue_size = 512

    def __init__(
        self, addr, handler, store, batcher, queue_size: int, threads: int
    ) -> None:
        super().__init__(addr, handler)
        self.store = store
        self.batcher = batcher
        self.started_wall = _time.time()
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, queue_size))
        #: per-worker-thread admission timestamps (enq/deq perf stamps
        #: of the request the thread is currently handling) — read by
        #: the handler, which runs on the same pool thread
        self._admit_local = threading.local()
        self._pool_stop = False
        self._pool = [
            threading.Thread(
                target=self._worker, name=f"pw-serving-{i}", daemon=True
            )
            for i in range(max(1, threads))
        ]
        for t in self._pool:
            t.start()

    def process_request(self, request, client_address) -> None:
        try:
            self._queue.put_nowait(
                (request, client_address, _time.perf_counter())
            )
        except queue.Full:
            _SHED.inc()
            # shed before the headers are ever read, so no trace id can
            # exist for this connection — the wide event records the
            # refusal without one
            _metrics.FLIGHT.record(
                "serving_shed", port=self.server_port
            )
            _metrics.REQUESTS.record(
                endpoint="admission",
                status=503,
                port=self.server_port,
                refusal="shed",
            )
            try:
                request.sendall(
                    b"HTTP/1.1 503 Service Unavailable\r\n"
                    b"Retry-After: 1\r\n"
                    b"Content-Length: 0\r\n"
                    b"Connection: close\r\n\r\n"
                )
            except OSError:
                pass
            self.shutdown_request(request)

    def _worker(self) -> None:
        # bounded get: a sentinel can be lost to a full queue during
        # shutdown, so the stop flag — not the sentinel — is what
        # guarantees this daemon exits
        while True:
            try:
                item = self._queue.get(timeout=0.25)
            except queue.Empty:
                if self._pool_stop:
                    return
                continue
            if item is None:
                return
            request, client_address, t_enq = item
            self._admit_local.enq = t_enq
            self._admit_local.deq = _time.perf_counter()
            try:
                self.finish_request(request, client_address)
            except Exception:  # noqa: BLE001 — one bad socket, not the pool
                pass
            finally:
                self.shutdown_request(request)

    def stop_pool(self) -> None:
        self._pool_stop = True
        for _ in self._pool:
            try:
                self._queue.put_nowait(None)
            except queue.Full:
                break  # workers still exit via the stop flag
        for t in self._pool:
            t.join(timeout=2.0)

    def serving_stats(self) -> dict:
        uptime = max(1e-9, _time.time() - self.started_wall)
        requests = sum(c.value for c in _REQS.values())
        return {
            "uptime_s": round(uptime, 3),
            "requests": requests,
            "qps": round(requests / uptime, 2),
            "shed": _SHED.value,
            "no_snapshot": _EMPTY.value,
            "latency_ms": {
                "p50": round(_LATENCY.quantile(0.50) * 1000.0, 3),
                "p95": round(_LATENCY.quantile(0.95) * 1000.0, 3),
                "p99": round(_LATENCY.quantile(0.99) * 1000.0, 3),
                "count": _LATENCY.count,
            },
            "batch": {
                "dispatches": self.batcher.dispatches,
                "queries": _BATCHED.sum,
            },
            "stale_503": _STALE.value,
            "cache": _result_cache.CACHE.stats(),
            "snapshot": self.store.stats(),
        }


class QueryServer:
    """Lifecycle wrapper: bind, pump, stop.  One per process, started by
    ``pw.run`` when ``PATHWAY_TPU_SERVING=1`` (mirrors
    ``MonitoringHttpServer``)."""

    def __init__(
        self,
        store: "_snapshot.SnapshotStore" | None = None,
        port: int | None = None,
        queue_size: int | None = None,
        threads: int | None = None,
        batch_window_ms: float | None = None,
    ) -> None:
        self.store = store if store is not None else _snapshot.STORE
        self.port = port if port is not None else serving_port()
        if queue_size is None:
            queue_size = int(
                os.environ.get("PATHWAY_TPU_SERVING_QUEUE", "256")
            )
        if threads is None:
            threads = int(os.environ.get("PATHWAY_TPU_SERVING_THREADS", "8"))
        if batch_window_ms is None:
            batch_window_ms = float(
                os.environ.get("PATHWAY_TPU_SERVING_BATCH_WINDOW_MS", "2")
            )
        self.batcher = _MicroBatcher(self.store, batch_window_ms / 1000.0)
        self.httpd = _BoundedHTTPServer(
            ("127.0.0.1", self.port),
            _Handler,
            self.store,
            self.batcher,
            queue_size,
            threads,
        )
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "QueryServer":
        if not _started_wall:
            _started_wall.append(self.httpd.started_wall)
        self.batcher.start()
        self._thread = threading.Thread(
            target=self.httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="pw-serving-http",
            daemon=True,
        )
        self._thread.start()
        _metrics.FLIGHT.record("serving_start", port=self.port)
        return self

    def stop(self) -> None:
        try:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd.stop_pool()
        finally:
            self.batcher.stop()
            if self._thread is not None:
                self._thread.join(timeout=5.0)
        _metrics.FLIGHT.record("serving_stop", port=self.port)
