"""Leader-side federation front: one read endpoint for the whole mesh.

Counterpart of ``pathway_tpu/serving/federation.py``: the same routes, merge and
port (``PATHWAY_TPU_FEDERATION_PORT``, 23000). A request that fails inside the front
itself is answered 500 naming the error, as the worker's query server does.

Clients of the per-worker query plane (:mod:`pathway_tpu_torch.serving.server`)
must know the mesh width, fan a query out to every worker's port, and
merge shard answers themselves.  The federation front — started on the
leader when ``PATHWAY_TPU_SERVING_FEDERATION=1`` — does that once for
everyone, on ``PATHWAY_TPU_FEDERATION_PORT`` (default 23000):

- ``POST /serving/query`` is scattered concurrently to every worker's
  QueryServer; per-query top-k lists are merged with **exactly** the
  stable-sort contract :meth:`ReadSnapshot.search` applies across its
  own shards (concatenate in worker order, stable-sort on descending
  score, truncate to k) — so a federated answer is bit-identical to a
  client-side fan-out merge at the same commits.
- ``POST /serving/lookup`` unions shard rows (workers partition the key
  space).
- Answers are stamped with the **minimum common commit** across the
  shard answers — the commit the merged view is consistent at.
- When read replicas are configured (``PATHWAY_TPU_REPLICAS``: a count,
  or a ``host:port`` list), queries round-robin across them first —
  each replica already holds the whole mesh's consistent cut, so a
  replica route costs one hop instead of a width-wide scatter, and
  query capacity scales with the replica pool instead of ingest width.
  A failing or stale replica falls back to the next, then to the
  worker scatter, so replica churn degrades latency, not availability.
- Scatter answers are cached in the shared commit-stamped
  :mod:`result cache <pathway_tpu_torch.serving.result_cache>` under the full
  per-worker stamp vector; a background poller tracks the backends'
  current stamps so hot federated queries short-circuit without any
  fan-out at all.  Rollback invalidation rides the same store-truncate
  hook as the worker-level cache (the front lives in the leader
  process).

A partial scatter is never served: if any worker cannot answer, the
front degrades to replicas or a 503 + Retry-After — merged-but-missing-
a-shard rows would violate the bit-identical contract.
"""

from __future__ import annotations

import json
import os
import threading
import time as _time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Any

from pathway_tpu_torch.internals import metrics as _metrics
from pathway_tpu_torch.internals import tracing as _tracing
from pathway_tpu_torch.serving import result_cache as _result_cache
from pathway_tpu_torch.serving import server as _server
from pathway_tpu_torch.serving.replica import parse_sources, replica_port

__all__ = [
    "FederationFront",
    "enabled",
    "federation_port",
    "replica_endpoints",
    "BASE_PORT",
]

BASE_PORT = 23000

_FED_REQS = {
    ep: _metrics.REGISTRY.counter(
        "pathway_serving_federation_requests_total",
        "federated read requests by endpoint",
        endpoint=ep,
    )
    for ep in ("query", "lookup", "health", "stats", "other")
}
_FED_ROUTE = {
    route: _metrics.REGISTRY.counter(
        "pathway_serving_federation_routes_total",
        "how federated queries were answered "
        "(cache/replica/scatter/unavailable)",
        route=route,
    )
    for route in ("cache", "replica", "scatter", "unavailable")
}
_FED_FANOUT = _metrics.REGISTRY.histogram(
    "pathway_serving_federation_fanout",
    "backend requests issued per federated query",
    buckets=(0, 1, 2, 4, 8, 16, 32, 64),
)
_FED_LATENCY = _metrics.REGISTRY.histogram(
    "pathway_serving_federation_latency_seconds",
    "federated request latency (admission to response flush)",
    buckets=_server._LAT_BUCKETS,
)


def enabled() -> bool:
    return os.environ.get(
        "PATHWAY_TPU_SERVING_FEDERATION", "0"
    ).lower() in ("1", "true", "yes")


def federation_port() -> int:
    return int(os.environ.get("PATHWAY_TPU_FEDERATION_PORT", BASE_PORT))


def replica_endpoints() -> list[tuple[str, int]]:
    """``PATHWAY_TPU_REPLICAS``: a bare count N (replicas at the port
    scheme ``24000+i``) or an explicit ``host:port,host:port`` list."""
    spec = os.environ.get("PATHWAY_TPU_REPLICAS", "").strip()
    if not spec:
        return []
    try:
        count = int(spec)
    except ValueError:
        return parse_sources(spec)
    return [("127.0.0.1", replica_port(i)) for i in range(max(0, count))]


def _post_json(
    url: str,
    payload: dict,
    timeout: float,
    headers: dict | None = None,
) -> tuple[int, dict, Any]:
    """POST JSON; returns ``(status, body, response_headers)`` — the
    headers carry the trace-span piggyback on instrumented backends."""
    all_headers = {"Content-Type": "application/json"}
    if headers:
        all_headers.update(headers)
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode(),
        headers=all_headers,
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as exc:
        try:
            body = json.loads(exc.read() or b"{}")
        except ValueError:
            body = {}
        return exc.code, body, exc.headers


def _stamp_header(answered: tuple | None, meta: dict | None) -> str | None:
    """``X-Pathway-Stamp`` value for a federated answer: the full
    per-worker stamp vector when the scatter produced one (compact
    JSON, so a cache hit and a recompute at the same vector carry
    byte-identical headers), else the replica answer's commit
    identity."""
    if answered is not None:
        try:
            return json.dumps(
                list(answered), separators=(",", ":"), default=repr
            )
        except (TypeError, ValueError):
            return repr(answered)
    if meta and meta.get("commit_time") is not None:
        return json.dumps(
            [meta["commit_time"], meta.get("seq", 0)],
            separators=(",", ":"),
        )
    return None


def _get_json(url: str, timeout: float) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, {}


class FederationUnavailable(RuntimeError):
    """No route could produce a full-mesh answer right now (a worker is
    mid-restart and no replica has a fresh cut).  Mapped to 503 +
    Retry-After — the front never serves a partial merge."""


class _FederationHTTPServer(_server._BoundedHTTPServer):
    """Same bounded-queue admission as the worker servers; the handler
    talks to ``self.front`` instead of a local store."""

    front: "FederationFront" = None  # set right after construction

    def serving_stats(self) -> dict:
        return self.front.stats()


class _FedHandler(_server._Handler):
    # inherits _json/_raw_json/_body/_stale and the logging suppression

    def do_GET(self) -> None:  # noqa: N802 — http.server contract
        t0 = _time.perf_counter()
        try:
            path = self.path
            if "/health" in path:
                _FED_REQS["health"].inc()
                self._json(200, self.server.front.health())
            elif "/stats" in path:
                _FED_REQS["stats"].inc()
                self._json(200, self.server.front.stats())
            else:
                _FED_REQS["other"].inc()
                self._json(404, {"error": f"unknown path {path}"})
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            _FED_LATENCY.observe(_time.perf_counter() - t0)

    def do_POST(self) -> None:  # noqa: N802 — http.server contract
        t0 = _time.perf_counter()
        self._wide = {}
        path = self.path
        if "/query" in path:
            endpoint = "fed-query"
        elif "/lookup" in path:
            endpoint = "fed-lookup"
        else:
            endpoint = "other"
        tracer = _tracing.TRACER
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
            if endpoint == "fed-query":
                _FED_REQS["query"].inc()
                self._fed_query(t0)
            elif endpoint == "fed-lookup":
                _FED_REQS["lookup"].inc()
                self._fed_lookup()
            else:
                _FED_REQS["other"].inc()
                self._json(404, {"error": f"unknown path {path}"})
        except (BrokenPipeError, ConnectionResetError):
            pass
        except FederationUnavailable as exc:
            _FED_ROUTE["unavailable"].inc()
            self._wide["refusal"] = "partial-scatter"
            try:
                self._json(
                    503,
                    {"error": str(exc), "stale": True},
                    headers={"Retry-After": "1"},
                )
            except (BrokenPipeError, ConnectionResetError):
                pass
        except (ValueError, KeyError, TypeError) as exc:
            try:
                self._json(400, {"error": repr(exc)})
            except (BrokenPipeError, ConnectionResetError):
                pass
        except Exception as exc:  # noqa: BLE001 — answered, never dropped
            self._server_error(exc)
        finally:
            dt = _time.perf_counter() - t0
            _FED_LATENCY.observe(dt)
            if rctx is not None:
                _FED_LATENCY.exemplar(dt, rctx.trace_id)
                # wide event BEFORE teardown so the trace-id provider
                # still sees the context
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

    def _fed_query(self, t0: float) -> None:
        req = self._body()
        if "vectors" in req:
            vectors = [list(map(float, v)) for v in req["vectors"]]
        else:
            vectors = [list(map(float, req["vector"]))]
        k = int(req.get("k", 10))
        front = self.server.front
        rctx = self._rctx
        key = front.cache_key(
            "fed-query",
            json.dumps({"vectors": vectors, "k": k}, sort_keys=True).encode(),
        )
        if key is not None:
            tc0 = _time.perf_counter()
            cached = _result_cache.CACHE.get(key)
            disposition = "hit" if cached is not None else "miss"
            self._wide["cache"] = disposition
            self._wide["stamp"] = repr(key[1])
            if rctx is not None:
                rctx.span(
                    "result-cache",
                    "serving",
                    tc0,
                    _time.perf_counter(),
                    disposition=disposition,
                )
            if cached is not None:
                _FED_ROUTE["cache"].inc()
                _FED_FANOUT.observe(0.0)
                self._wide["fan_out"] = 0
                self._raw_json(
                    200,
                    cached,
                    {
                        "X-Pathway-Cache": "hit",
                        "X-Pathway-Stamp": _stamp_header(key[1], None),
                    },
                )
                _result_cache.CACHE.observe_hit_latency(
                    _time.perf_counter() - t0
                )
                return
        else:
            self._wide["cache"] = "miss"
        body, answered = front.query(vectors, k, rctx=rctx)
        raw = json.dumps(body).encode()
        if key is not None and answered is not None and answered == key[1]:
            _result_cache.CACHE.put(
                key,
                raw,
                len(raw),
                # stamped at the merge's min common commit, so rollback
                # invalidation drops it with the worker-level entries
                commit_time=min(part[1] for part in answered),
            )
        meta = body.get("snapshot") or {}
        self._wide["route"] = meta.get("route")
        self._wide["fan_out"] = meta.get("fan_out", 0)
        self._wide["commit_time"] = meta.get("commit_time")
        headers = {"X-Pathway-Cache": "miss"}
        stamp_value = _stamp_header(answered, meta)
        if stamp_value is not None:
            headers["X-Pathway-Stamp"] = stamp_value
        self._raw_json(200, raw, headers)

    def _fed_lookup(self) -> None:
        req = self._body()
        keys = [str(key) for key in req.get("keys", [])]
        node = req.get("node")
        body = self.server.front.lookup(keys, node, rctx=self._rctx)
        meta = body.get("snapshot") or {}
        self._wide["fan_out"] = meta.get("fan_out", 0)
        self._wide["commit_time"] = meta.get("commit_time")
        self._json(200, body)


class FederationFront:
    """Lifecycle wrapper + routing/merging logic.  One per mesh, on the
    leader (mirrors the leader-only aggregated ``/metrics``)."""

    def __init__(
        self,
        port: int | None = None,
        worker_ports: list[int] | None = None,
        replicas: list[tuple[str, int]] | None = None,
        queue_size: int | None = None,
        threads: int | None = None,
    ) -> None:
        self.port = port if port is not None else federation_port()
        self._explicit_workers = worker_ports
        self.replicas = (
            replicas if replicas is not None else replica_endpoints()
        )
        if queue_size is None:
            queue_size = int(
                os.environ.get("PATHWAY_TPU_SERVING_QUEUE", "256")
            )
        if threads is None:
            threads = int(os.environ.get("PATHWAY_TPU_SERVING_THREADS", "8"))
        self._lock = threading.Lock()
        self._rr = 0  # guarded-by: self._lock
        self._stamp_vector: tuple | None = None  # guarded-by: self._lock
        self._pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="pw-fed-scatter"
        )
        self.httpd = _FederationHTTPServer(
            ("127.0.0.1", self.port),
            _FedHandler,
            None,  # no local store: reads go through self.front
            None,
            queue_size,
            threads,
        )
        self.httpd.front = self
        self._thread: threading.Thread | None = None
        self._poller: threading.Thread | None = None
        self._stop = threading.Event()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FederationFront":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="pw-federation-http",
            daemon=True,
        )
        self._thread.start()
        self._poller = threading.Thread(
            target=self._stamp_poll_loop, name="pw-federation-stamp",
            daemon=True,
        )
        self._poller.start()
        _metrics.FLIGHT.record(
            "federation_start",
            port=self.port,
            replicas=len(self.replicas),
        )
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd.stop_pool()
        finally:
            if self._thread is not None:
                self._thread.join(timeout=5.0)
            if self._poller is not None:
                self._poller.join(timeout=2.0)
            self._pool.shutdown(wait=False)
        _metrics.FLIGHT.record("federation_stop", port=self.port)

    # -- topology ------------------------------------------------------------

    def worker_ports(self) -> list[int]:
        """Live per request so a rescale's new width is picked up at the
        next query, not the next process."""
        if self._explicit_workers is not None:
            return list(self._explicit_workers)
        width = int(os.environ.get("PATHWAY_PROCESSES", "1"))
        return [_server.serving_port(pid) for pid in range(width)]

    def _next_replica(self) -> list[tuple[str, int]]:
        """Replica pool rotated to start at the round-robin cursor, so
        a dead first choice falls through to the others in order."""
        if not self.replicas:
            return []
        with self._lock:
            start = self._rr % len(self.replicas)
            self._rr += 1
        return self.replicas[start:] + self.replicas[:start]

    # -- stamp poller (federated cache keying) -------------------------------

    def _stamp_poll_loop(self) -> None:
        while not self._stop.wait(0.25):
            vector = self._poll_stamps()
            with self._lock:
                self._stamp_vector = vector

    def _poll_stamps(self) -> tuple | None:
        parts = []
        for port in self.worker_ports():
            try:
                status, health = _get_json(
                    f"http://127.0.0.1:{port}/serving/health", timeout=0.5
                )
            except (OSError, ValueError):
                return None
            if status != 200 or health.get("commit_time") is None:
                return None
            parts.append((port, health["commit_time"], health.get("seq", 0)))
        return tuple(parts) or None

    def cache_key(self, endpoint: str, material: bytes):
        """Key on the poller's latest full per-worker stamp vector; None
        (no caching) while any backend is unreachable or pre-commit."""
        if not _result_cache.enabled():
            return None
        with self._lock:
            vector = self._stamp_vector
        if vector is None:
            return None
        return (
            endpoint,
            vector,
            _result_cache.query_digest(endpoint, material),
        )

    # -- routing -------------------------------------------------------------

    def query(
        self, vectors: list, k: int, rctx=None
    ) -> tuple[dict, tuple | None]:
        """Answer one federated KNN request.  Returns ``(body,
        answered_stamp_vector)``; the stamp vector is None on replica
        routes (replica answers are cached in the replica process).
        ``rctx`` is the handler's request-trace context, passed
        explicitly because the scatter pool threads don't share the
        handler's thread-local slot."""
        payload = {"vectors": vectors, "k": k}
        for host, port in self._next_replica():
            sid = rctx.alloc_sid() if rctx is not None else None
            hdrs = (
                {_tracing.TRACE_HEADER: rctx.header(sid)}
                if rctx is not None
                else None
            )
            t_leg = _time.perf_counter()
            try:
                status, body, rhdrs = _post_json(
                    f"http://{host}:{port}/serving/query",
                    payload,
                    timeout=5.0,
                    headers=hdrs,
                )
            except (OSError, ValueError) as exc:
                if rctx is not None:
                    # the dead leg stays visible in the assembled trace
                    # as the reason the request fell through to scatter
                    rctx.span(
                        f"replica {host}:{port}",
                        "exchange",
                        t_leg,
                        _time.perf_counter(),
                        sid=sid,
                        port=port,
                        error=repr(exc),
                    )
                continue
            if rctx is not None:
                rctx.span(
                    f"replica {host}:{port}",
                    "exchange",
                    t_leg,
                    _time.perf_counter(),
                    sid=sid,
                    port=port,
                    status=status,
                )
                remote = _tracing.decode_spans(
                    rhdrs.get(_tracing.SPANS_HEADER)
                    if rhdrs is not None
                    else None
                )
                if remote:
                    rctx.add_remote_spans(remote, sid)
            if status == 200 and body.get("snapshot") is not None:
                _FED_ROUTE["replica"].inc()
                _FED_FANOUT.observe(1.0)
                meta = body["snapshot"]
                meta["route"] = "replica"
                meta["fan_out"] = 1
                return body, None
        return self._scatter_query(payload, k, rctx)

    def _scatter_query(
        self, payload: dict, k: int, rctx=None
    ) -> tuple[dict, tuple | None]:
        ports = self.worker_ports()
        shard_bodies = self._scatter("/serving/query", payload, ports, rctx)
        _FED_ROUTE["scatter"].inc()
        _FED_FANOUT.observe(float(len(ports)))
        answered = []
        live = []
        for port, body in zip(ports, shard_bodies):
            meta = body.get("snapshot")
            if meta is None:
                continue  # pre-commit worker: empty contribution
            answered.append((port, meta["commit_time"], meta.get("seq", 0)))
            live.append(body)
        if not live:
            n = len(payload["vectors"])
            return {"hits": [[] for _ in range(n)], "snapshot": None}, None
        n = len(payload["vectors"])
        merged_hits = []
        for qi in range(n):
            merged: list = []
            for body in live:
                merged.extend(body["hits"][qi])
            # the ReadSnapshot.search contract verbatim: stable sort on
            # descending score, ties resolve by worker then shard order
            merged.sort(key=lambda hit: -hit[1])
            merged_hits.append(merged[:k])
        metas = [body["snapshot"] for body in live]
        meta = {
            "commit_time": min(m["commit_time"] for m in metas),
            "seq": max(m.get("seq", 0) for m in metas),
            "staleness_s": max(m.get("staleness_s", 0.0) for m in metas),
            "route": "scatter",
            "fan_out": len(ports),
        }
        return {"hits": merged_hits, "snapshot": meta}, tuple(answered)

    def lookup(self, keys: list[str], node, rctx=None) -> dict:
        payload = {"keys": keys}
        if node is not None:
            payload["node"] = node
        ports = self.worker_ports()
        shard_bodies = self._scatter("/serving/lookup", payload, ports, rctx)
        _FED_FANOUT.observe(float(len(ports)))
        rows: dict = {}
        metas = []
        for body in shard_bodies:
            meta = body.get("snapshot")
            if meta is None:
                continue
            metas.append(meta)
            for key, row in body.get("rows", {}).items():
                if row is not None or key not in rows:
                    rows[key] = row
        if not metas:
            return {"rows": {}, "snapshot": None}
        return {
            "rows": rows,
            "snapshot": {
                "commit_time": min(m["commit_time"] for m in metas),
                "seq": max(m.get("seq", 0) for m in metas),
                "staleness_s": max(m.get("staleness_s", 0.0) for m in metas),
                "route": "scatter",
                "fan_out": len(ports),
            },
        }

    def _scatter(
        self, path: str, payload: dict, ports: list[int], rctx=None
    ) -> list[dict]:
        """POST to every worker concurrently; ALL must answer 200 or the
        whole request degrades (partial merges are never served).  One
        child span per leg when the request is traced; each leg's
        outbound header carries its pre-allocated span id so the
        worker's piggybacked spans parent under it."""
        legs = []
        for port in ports:
            sid = rctx.alloc_sid() if rctx is not None else None
            hdrs = (
                {_tracing.TRACE_HEADER: rctx.header(sid)}
                if rctx is not None
                else None
            )
            legs.append(
                (
                    port,
                    sid,
                    _time.perf_counter(),
                    self._pool.submit(
                        _post_json,
                        f"http://127.0.0.1:{port}{path}",
                        payload,
                        5.0,
                        hdrs,
                    ),
                )
            )
        bodies = []
        for port, sid, t_leg, future in legs:
            try:
                status, body, rhdrs = future.result(timeout=6.0)
            except Exception as exc:  # noqa: BLE001 — degrade, never partial-merge
                if rctx is not None:
                    rctx.span(
                        f"scatter :{port}",
                        "exchange",
                        t_leg,
                        _time.perf_counter(),
                        sid=sid,
                        port=port,
                        error=repr(exc),
                    )
                # recorded on the handler thread, so the FLIGHT event
                # carries the request's trace id via the provider
                _metrics.FLIGHT.record(
                    "federation_partial_scatter",
                    port=port,
                    error=repr(exc),
                )
                raise FederationUnavailable(
                    f"worker :{port} unreachable during scatter: {exc!r}"
                ) from exc
            if rctx is not None:
                rctx.span(
                    f"scatter :{port}",
                    "exchange",
                    t_leg,
                    _time.perf_counter(),
                    sid=sid,
                    port=port,
                    status=status,
                )
                remote = _tracing.decode_spans(
                    rhdrs.get(_tracing.SPANS_HEADER)
                    if rhdrs is not None
                    else None
                )
                if remote:
                    rctx.add_remote_spans(remote, sid)
            if status != 200:
                _metrics.FLIGHT.record(
                    "federation_partial_scatter",
                    port=port,
                    status=status,
                )
                raise FederationUnavailable(
                    f"worker :{port} answered {status} during scatter"
                )
            bodies.append(body)
        return bodies

    # -- observability -------------------------------------------------------

    def health(self) -> dict:
        backends = {}
        commits = []
        for port in self.worker_ports():
            try:
                status, health = _get_json(
                    f"http://127.0.0.1:{port}/serving/health", timeout=1.0
                )
            except (OSError, ValueError):
                status, health = 0, {}
            backends[str(port)] = {
                "status": status,
                "commit_time": health.get("commit_time"),
            }
            commits.append(health.get("commit_time"))
        ok = all(b["status"] == 200 for b in backends.values())
        return {
            "ok": ok,
            "commit_time": (
                min(commits) if commits and None not in commits else None
            ),
            "workers": backends,
            "replicas": [f"{h}:{p}" for h, p in self.replicas],
        }

    def stats(self) -> dict:
        uptime = max(1e-9, _time.time() - self.httpd.started_wall)
        requests = sum(c.value for c in _FED_REQS.values())
        with self._lock:
            vector = self._stamp_vector
        return {
            "uptime_s": round(uptime, 3),
            "requests": requests,
            "qps": round(requests / uptime, 2),
            "routes": {name: c.value for name, c in _FED_ROUTE.items()},
            "fan_out": {
                "mean": round(
                    _FED_FANOUT.sum / _FED_FANOUT.count, 2
                )
                if _FED_FANOUT.count
                else None,
                "count": _FED_FANOUT.count,
            },
            "latency_ms": {
                "p50": round(_FED_LATENCY.quantile(0.50) * 1000.0, 3),
                "p95": round(_FED_LATENCY.quantile(0.95) * 1000.0, 3),
                "p99": round(_FED_LATENCY.quantile(0.99) * 1000.0, 3),
                "count": _FED_LATENCY.count,
            },
            "workers": self.worker_ports(),
            "replicas": [f"{h}:{p}" for h, p in self.replicas],
            "stamp_vector": list(vector) if vector else None,
            "cache": _result_cache.CACHE.stats(),
        }


def main(argv=None) -> int:
    """``pathway federation`` entry point: run one front until killed."""
    import argparse
    import signal

    parser = argparse.ArgumentParser(
        prog="pathway federation",
        description="federated read front over worker query servers "
        "and replica pools",
    )
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument(
        "--workers", default="",
        help="comma list of worker query ports (default: derive from "
        "PATHWAY_PROCESSES and the serving port scheme)",
    )
    parser.add_argument(
        "--replicas", default=os.environ.get("PATHWAY_TPU_REPLICAS", ""),
        help="replica count or host:port list (default: none)",
    )
    args = parser.parse_args(list(argv) if argv is not None else None)

    worker_ports = (
        [int(p) for p in args.workers.split(",") if p.strip()]
        if args.workers
        else None
    )
    if args.replicas:
        spec = args.replicas.strip()
        if spec.isdigit():
            replicas = [
                ("127.0.0.1", replica_port(rid)) for rid in range(int(spec))
            ]
        else:
            replicas = parse_sources(spec)
    else:
        replicas = []
    front = FederationFront(
        port=args.port, worker_ports=worker_ports, replicas=replicas
    ).start()
    print(
        json.dumps(
            {
                "event": "federation-ready",
                "port": front.port,
                "workers": front.worker_ports(),
                "replicas": [f"{h}:{p}" for h, p in front.replicas],
            }
        ),
        flush=True,
    )
    stop = threading.Event()

    def _on_signal(_signum, _frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    try:
        while not stop.wait(0.5):
            pass
    finally:
        front.stop()
    return 0
