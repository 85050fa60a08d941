"""The serving tier's request traces in the port against the JAX package's: a query's
trace through the port's query server, federation front and replica (the tracer's
request half, ``internals/tracing.py``), the read tier's pressure events in the flight
recorder, and the read-tier families of the history ring (``internals/timeseries.py``).

Each case runs in both packages on the same seeded host index and compares what the
traces hold: the span names of a request, the fields of its wide event, the kinds of
the flight events and the trace id they carry, and the derived families' points.
Every HTTP call has its own timeout.
"""

from __future__ import annotations

import importlib
import json
import socket
import threading
import time

import numpy as np
import pytest

PKGS = ("pathway_tpu_torch", "pathway_tpu")
HTTP_TIMEOUT = 10.0


def _m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _vec(i: int, dim: int = 6) -> np.ndarray:
    rng = np.random.RandomState(1000 + i)
    v = rng.rand(dim).astype(np.float32)
    return v / np.linalg.norm(v)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _post(port: int, path: str, payload: dict, timeout: float = HTTP_TIMEOUT):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


class _Pipeline:
    """One worker's KNN pipeline and private snapshot store, in package ``pkg``."""

    def __init__(self, pkg: str, keys, dim: int = 6, k: int = 3, depth: int = 4):
        graph, ei = _m(pkg, "engine.graph"), _m(pkg, "engine.external_index")
        self.ref = _m(pkg, "engine.value").ref_scalar
        self.sc = graph.Scope()
        self.index_in = self.sc.input_session(arity=1)
        self.query_in = self.sc.input_session(arity=1)
        ei.ExternalIndexNode(self.sc, self.index_in, self.query_in,
                             ei.HostKnnIndex(dim=dim, capacity=64),
                             index_col=0, query_col=0, k=k)
        self.sched = graph.Scheduler(self.sc)
        self.store = _m(pkg, "serving.snapshot").SnapshotStore(depth=depth)
        for i in keys:
            self.index_in.insert(self.ref(i), (tuple(_vec(i).tolist()),))
        self.store.publish([self.sc], self.sched.commit())


def _reset(pkg: str) -> None:
    _m(pkg, "internals.tracing").TRACER.configure(
        enabled=False, sample=1, request_enabled=False, request_sample=1, clear=True)
    metrics = _m(pkg, "internals.metrics")
    metrics.REQUESTS.clear()
    metrics.FLIGHT.clear()
    _m(pkg, "serving.result_cache").CACHE.clear()


@pytest.fixture(autouse=True)
def _clean_observability():
    for pkg in PKGS:
        _reset(pkg)
    yield
    for pkg in PKGS:
        _reset(pkg)


def _traced(pkg: str):
    tracing = _m(pkg, "internals.tracing")
    tracing.TRACER.configure(enabled=False, request_enabled=True, request_sample=1, clear=True)
    return tracing


def _request_traces(pkg: str, trace_id: str | None = None) -> list[dict]:
    return [t for t in _m(pkg, "internals.tracing").TRACER.traces()
            if t.get("kind") == "request" and (trace_id is None or t.get("trace_id") == trace_id)]


def _assert_span_closure(trace: dict) -> None:
    """No orphaned spans: every span's parent is the root (None) or a span of the
    same trace."""
    sids = {(s.get("args") or {}).get("sid") for s in trace.get("spans", [])}
    for s in trace.get("spans", []):
        parent = (s.get("args") or {}).get("parent")
        assert parent is None or parent in sids, f"orphaned span {s.get('name')!r}"


def _wide_events(pkg: str, match, n: int = 1, timeout: float = 10.0) -> list[dict]:
    """The wide events ``match`` accepts, once there are ``n`` of them: a handler records
    its event after the response is on the wire, so a client can read the answer first."""
    ring = _m(pkg, "internals.metrics").REQUESTS
    deadline = time.monotonic() + timeout
    while True:
        found = [e for e in ring.snapshot() if match(e)]
        if len(found) >= n or time.monotonic() > deadline:
            return found
        time.sleep(0.01)


def _server(pkg: str, store):
    return _m(pkg, "serving.server").QueryServer(store=store, port=_free_port(),
                                                 batch_window_ms=0.5).start()


class TestSingleWorkerRequestTrace:
    def test_query_trace_echo_and_wide_event(self, monkeypatch):
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "1")
        seen = []
        for pkg in PKGS:
            tracing = _traced(pkg)
            srv = _server(pkg, _Pipeline(pkg, range(16)).store)
            try:
                status, headers, _ = _post(srv.port, "/serving/query",
                                           {"vector": _vec(2).tolist(), "k": 3})
                assert status == 200
                tid = headers.get(tracing.TRACE_HEADER)
                assert tid, "the root response echoes its trace id"
                deadline = time.monotonic() + 10.0
                while not (entries := _request_traces(pkg, tid)) and time.monotonic() < deadline:
                    time.sleep(0.01)  # assembled as the handler ends, after the response
                assert len(entries) == 1
                names = [s["name"] for s in entries[0]["spans"]]
                assert {"admission-queue", "result-cache", "snapshot-pin", "search"} <= set(names)
                _assert_span_closure(entries[0])
                tracing.validate_chrome_trace(tracing.chrome_trace(entries))
                wides = _wide_events(pkg, lambda e, tid=tid: e.get("trace_id") == tid)
                assert len(wides) == 1
                wide = wides[0]
                assert (wide["endpoint"], wide["status"], wide["cache"]) == ("query", 200, "miss")
                assert wide["ns"] > 0 and "stamp" in wide
                seen.append((sorted(names), sorted(wide)))
            finally:
                srv.stop()
        assert seen[0] == seen[1]


class TestPressureFlightEvents:
    def test_partial_scatter_event_carries_trace_id(self, monkeypatch):
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "0")
        seen = []
        for pkg in PKGS:
            tracing = _traced(pkg)
            metrics = _m(pkg, "internals.metrics")
            srv = _server(pkg, _Pipeline(pkg, range(12)).store)
            front = _m(pkg, "serving.federation").FederationFront(
                port=_free_port(), worker_ports=[srv.port, _free_port()], replicas=[]).start()
            try:
                status, headers, _ = _post(front.port, "/serving/query",
                                           {"vector": _vec(5).tolist(), "k": 3})
                assert status == 503
                tid = headers.get(tracing.TRACE_HEADER)
                assert tid
                events = [e for e in metrics.FLIGHT.snapshot() if e["kind"] == "federation_partial_scatter"]
                assert events and events[-1].get("trace_id") == tid
                wides = _wide_events(pkg, lambda e, tid=tid: e.get("trace_id") == tid
                                     and e.get("endpoint") == "fed-query")
                assert len(wides) == 1
                assert (wides[0]["status"], wides[0]["refusal"]) == (503, "partial-scatter")
                seen.append((wides[0]["status"], wides[0]["refusal"], sorted(wides[0])))
            finally:
                front.stop()
                srv.stop()
        assert seen[0] == seen[1]

    def test_stale_cut_refusal_events(self, monkeypatch):
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "0")
        seen = []
        for pkg in PKGS:
            tracing = _traced(pkg)
            metrics = _m(pkg, "internals.metrics")
            pipe = _Pipeline(pkg, range(8))
            sport = _free_port()
            stream = _m(pkg, "serving.stream").SnapshotStreamServer(store=pipe.store, port=sport).start()
            # the bound is read live: loose until the replica holds its first cut (a
            # frame may take longer than the bound to arrive on a loaded box), then 0.1 s
            monkeypatch.setenv("PATHWAY_TPU_REPLICA_MAX_STALENESS_S", "60")
            rep = _m(pkg, "serving.replica").Replica(
                sources=[("127.0.0.1", sport)], port=_free_port(), replica_id=9).start()
            try:
                assert rep.wait_ready(10.0)
                monkeypatch.setenv("PATHWAY_TPU_REPLICA_MAX_STALENESS_S", "0.1")
                time.sleep(0.3)  # the cut ages past the bound
                status, headers, _ = _post(rep.port, "/serving/query",
                                           {"vector": _vec(1).tolist(), "k": 3})
                assert status == 503
                tid = headers.get(tracing.TRACE_HEADER)
                assert tid
                kinds = {e["kind"] for e in metrics.FLIGHT.snapshot()}
                assert "replica_stale_cut" in kinds
                stales = [e for e in metrics.FLIGHT.snapshot() if e["kind"] == "serving_stale_503"]
                assert stales and stales[-1].get("trace_id") == tid
                wides = _wide_events(pkg, lambda e, tid=tid: e.get("trace_id") == tid)
                assert wides and wides[-1]["refusal"] == "stale"
                seen.append(({"replica_stale_cut", "serving_stale_503"} & kinds, wides[-1]["refusal"]))
            finally:
                rep.stop()
                stream.stop()
        assert seen[0] == seen[1]

    def test_cache_eviction_event_carries_trace_id(self, monkeypatch):
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "1")
        seen = []
        for pkg in PKGS:
            rec = _traced(pkg).TRACER
            ctx = rec.begin_request("query")
            assert ctx is not None
            try:
                cache = _m(pkg, "serving.result_cache").ResultCache(max_bytes=100)
                cache.put(("a",), "x" * 60, 60, commit_time=1)
                cache.put(("b",), "y" * 60, 60, commit_time=1)  # evicts a
                events = [e for e in _m(pkg, "internals.metrics").FLIGHT.snapshot()
                          if e["kind"] == "cache_evict"]
                assert events and events[-1]["evicted"] == 1
                assert events[-1].get("trace_id") == ctx.trace_id
                seen.append(sorted(events[-1]))
            finally:
                rec.end_request(ctx)
                rec.drop_request()
        assert seen[0] == seen[1]


class TestRequestTraceChaos:
    def test_dead_leg_falls_through_to_scatter(self, monkeypatch):
        """Load through a front whose one replica dies mid-run: the assembled trace
        of a later request shows the dead replica leg and the scatter that answered;
        every answer is 200 or 503, and no span is orphaned."""
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "0")
        tracing = _traced(PKGS[0])
        rec = tracing.TRACER
        pipe = _Pipeline(PKGS[0], range(16))
        srv = _server(PKGS[0], pipe.store)
        sport = _free_port()
        stream = _m(PKGS[0], "serving.stream").SnapshotStreamServer(store=pipe.store, port=sport).start()
        rep = _m(PKGS[0], "serving.replica").Replica(
            sources=[("127.0.0.1", sport)], port=_free_port(), replica_id=5).start()
        front = _m(PKGS[0], "serving.federation").FederationFront(
            port=_free_port(), worker_ports=[srv.port], replicas=[("127.0.0.1", rep.port)]).start()
        statuses: list = []
        stop = threading.Event()

        def load() -> None:
            i = 0
            while not stop.is_set():
                try:
                    statuses.append(_post(front.port, "/serving/query",
                                          {"vector": _vec(i % 32).tolist(), "k": 3}, timeout=5.0)[0])
                except OSError:
                    pass
                i += 1
                stop.wait(0.01)

        loader = threading.Thread(target=load, daemon=True)
        try:
            assert rep.wait_ready(10.0)
            loader.start()
            time.sleep(0.3)
            rep.stop()  # the replica leg goes dark mid-run
            time.sleep(0.5)
            fall_through = None
            for i in range(200):
                status, headers, _ = _post(front.port, "/serving/query",
                                           {"vector": _vec(32 + i % 16).tolist(), "k": 3})
                statuses.append(status)
                tid = headers.get(tracing.TRACE_HEADER)
                if status != 200 or not tid:
                    continue
                entries = _request_traces(PKGS[0], tid)
                if entries and any(s["name"].startswith("replica ") and "error" in (s.get("args") or {})
                                   for s in entries[0]["spans"]):
                    fall_through = entries[0]
                    break
            stop.set()
            loader.join(timeout=10.0)
            assert fall_through is not None, "no assembled trace recorded the dead replica leg"
            names = [s["name"] for s in fall_through["spans"]]
            assert any(n.startswith("scatter :") for n in names)
            assert fall_through["status"] == 200
            assert statuses and set(statuses) <= {200, 503} and statuses.count(200) > 0
            for trace in _request_traces(PKGS[0]):
                _assert_span_closure(trace)
                assert trace["status"] in (200, 503)
            assert rec.current_request() is None
        finally:
            stop.set()
            front.stop()
            rep.stop()
            stream.stop()
            srv.stop()


class TestReadTierTimeseries:
    SNAP = {
        "pathway_serving_cache_events_total": {
            "kind": "counter",
            "series": [{"labels": {"kind": "hit"}, "value": 3.0},
                       {"labels": {"kind": "miss"}, "value": 1.0}],
        },
        "pathway_serving_federation_fanout": {
            "kind": "histogram",
            "buckets": [1, 2, 4],
            "series": [{"labels": {}, "counts": [0, 4, 0, 0], "count": 4, "sum": 8.0}],
        },
        "pathway_serving_replica_lag_seconds": {
            "kind": "gauge",
            "series": [{"labels": {"replica": "1"}, "value": 0.25}],
        },
    }
    FAMILIES = ("pathway_read_cache_hit_rate", "pathway_read_federation_fanout_mean",
                "pathway_read_replica_lag_seconds")

    def test_derived_families_record_and_prune(self):
        seen = []
        for pkg in PKGS:
            store = _m(pkg, "internals.timeseries").TimeSeriesStore()
            store.ingest_read_tier(self.SNAP, "r1", t=100.0)
            got = {f: store.query(f, 1e9, now=101.0)["series"] for f in self.FAMILIES}
            assert got["pathway_read_cache_hit_rate"][0]["points"][-1][1] == 0.75
            assert got["pathway_read_federation_fanout_mean"][0]["points"][-1][1] == 2.0
            assert got["pathway_read_replica_lag_seconds"][0]["labels"] == {"replica": "1", "worker": "r1"}
            store.prune_workers(dead=("r1",))  # a replica disconnect drops every r<id> set
            for family in self.FAMILIES:
                assert store.query(family, 1e9, now=101.0)["series"] == []
            seen.append(got)
        assert seen[0] == seen[1]

    def test_telemetry_tick_derives_local_families(self):
        for pkg in PKGS:
            ts = _m(pkg, "internals.timeseries")
            _m(pkg, "serving.result_cache")._EVENTS["hit"].inc()  # a non-empty hit/miss total
            store = ts.TimeSeriesStore()
            loop = ts.TelemetryLoop(store, ts.SloSentinel())
            loop.tick(now=100.0)
            rate = store.query("pathway_read_cache_hit_rate", 1e9, now=101.0)
            assert rate["series"], "the tick derives the read-tier families"
            assert str(loop.worker_id) in {s["labels"]["worker"] for s in rate["series"]}
