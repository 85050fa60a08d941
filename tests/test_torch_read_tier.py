"""The port's read tier (``serving/result_cache.py``, ``serving/stream.py``,
``serving/replica.py``, ``serving/federation.py`` and the ``cli replica`` and ``cli
federation`` subcommands) against the JAX package's.

Each case builds the same seeded KNN pipelines in both packages (a host index over
``_vec(i)``, one private snapshot store a worker) and compares what the two read
tiers answer: the result cache's contents and counts, a replica's answers and its
cut, a federated scatter's merged hits and stamp, the status codes and the
``Retry-After`` of a refusal. The host index is NumPy in both packages, so hits and
scores are compared bit for bit, with the wall-clock fields (staleness, publication
wall) left out. Every HTTP call has its own timeout, and the two subprocess cases run
the command line under a deadline that kills it.
"""

from __future__ import annotations

import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("pathway_tpu_torch", "pathway_tpu")
HTTP_TIMEOUT = 10.0
#: one command-line process's wall-clock budget in these tests (seconds)
CLI_DEADLINE = 60.0


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


def _get(port: int, path: str, timeout: float = HTTP_TIMEOUT):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _sans_wall(body: bytes) -> dict:
    answer = json.loads(body)
    snap = answer.get("snapshot")
    if isinstance(snap, dict):
        for field in ("staleness_s", "published", "lag_s"):
            snap.pop(field, None)
    return answer


def _wait_for(cond, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


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
        self.insert_commit(keys)

    def insert_commit(self, keys) -> int:
        for i in keys:
            self.index_in.insert(self.ref(i), (tuple(_vec(i).tolist()),))
        t = self.sched.commit()
        self.store.publish([self.sc], t)
        return t

    def publish_to(self, stream) -> None:
        snap = self.store.acquire_latest()
        if snap is not None:
            stream.publish(snap)
            snap.release()


@pytest.fixture(autouse=True)
def _clean_cache():
    for pkg in PKGS:
        _m(pkg, "serving.result_cache").CACHE.clear()
    yield
    for pkg in PKGS:
        _m(pkg, "serving.result_cache").CACHE.clear()


# -- the result cache ---------------------------------------------------------------


def _rc(pkg: str):
    return _m(pkg, "serving.result_cache")


class TestResultCache:
    @pytest.mark.parametrize("pkg", PKGS)
    def test_lru_bounded_by_bytes(self, monkeypatch, pkg):
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "1")
        cache = _rc(pkg).ResultCache(max_bytes=100)
        for i in range(5):
            cache.put(("q", i), f"v{i}", 30, commit_time=i)
        stats = cache.stats()
        assert stats["bytes"] <= 100 and stats["entries"] == 3
        assert cache.get(("q", 0)) is None and cache.get(("q", 1)) is None
        assert cache.get(("q", 4)) == "v4"

    def test_get_refreshes_lru_position(self, monkeypatch):
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "1")
        seen = []
        for pkg in PKGS:
            cache = _rc(pkg).ResultCache(max_bytes=90)
            for i in range(3):
                cache.put(("q", i), f"v{i}", 30, commit_time=i)
            assert cache.get(("q", 0)) == "v0"  # refresh
            cache.put(("q", 3), "v3", 30, commit_time=3)
            seen.append([cache.get(("q", i)) for i in range(4)])
        assert seen[0] == seen[1] == ["v0", None, "v2", "v3"]

    def test_oversized_insert_refused(self, monkeypatch):
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "1")
        for pkg in PKGS:
            cache = _rc(pkg).ResultCache(max_bytes=100)
            cache.put(("q", "small"), "v", 10, commit_time=1)
            cache.put(("q", "huge"), "x" * 200, 200, commit_time=1)
            assert cache.get(("q", "huge")) is None
            assert cache.get(("q", "small")) == "v"  # not wiped

    def test_invalidate_above_drops_rolled_back_stamps(self, monkeypatch):
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "1")
        seen = []
        for pkg in PKGS:
            cache = _rc(pkg).ResultCache(max_bytes=1 << 20)
            for t in (1, 2, 3, 4):
                cache.put(("q", t), f"v{t}", 10, commit_time=t)
            dropped = cache.invalidate_above(2)
            seen.append((dropped, [cache.get(("q", t)) for t in (1, 2, 3, 4)],
                         cache.stats()["invalidations"]))
        assert seen[0] == seen[1] == (2, ["v1", "v2", None, None], 2)

    def test_disabled_knob_blocks_inserts(self, monkeypatch):
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "0")
        for pkg in PKGS:
            cache = _rc(pkg).ResultCache(max_bytes=100)
            cache.put(("q", 1), "v", 10, commit_time=1)
            assert cache.stats()["entries"] == 0 and not cache.stats()["enabled"]

    def test_byte_budget_env_knob(self, monkeypatch):
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "1")
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE_BYTES", "50")
        stats = []
        for pkg in PKGS:
            cache = _rc(pkg).ResultCache()  # the live env budget
            cache.put(("q", 1), "a", 30, commit_time=1)
            cache.put(("q", 2), "b", 30, commit_time=2)
            stats.append((cache.stats()["entries"], cache.stats()["max_bytes"]))
        assert stats[0] == stats[1] == (1, 50)


# -- cache correctness over the HTTP front --------------------------------------------


class TestCacheCorrectness:
    def test_hit_bit_identical_across_publication(self, monkeypatch):
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "1")
        runs = []
        for pkg in PKGS:
            pipe = _Pipeline(pkg, range(16))
            srv = _m(pkg, "serving.server").QueryServer(
                store=pipe.store, port=_free_port(), batch_window_ms=0.5).start()
            try:
                payload = {"vector": _vec(2).tolist(), "k": 3}
                s1, h1, b1 = _post(srv.port, "/serving/query", payload)
                s2, h2, b2 = _post(srv.port, "/serving/query", payload)
                assert (s1, s2) == (200, 200)
                assert (h1.get("X-Pathway-Cache"), h2.get("X-Pathway-Cache")) == ("miss", "hit")
                assert b2 == b1  # a hit is the miss it memoised, bit for bit
                assert "X-Pathway-Stamp" in h1 and h2["X-Pathway-Stamp"] == h1["X-Pathway-Stamp"]
                pipe.insert_commit(range(16, 24))  # a publication moves the stamp
                s3, h3, b3 = _post(srv.port, "/serving/query", payload)
                assert h3.get("X-Pathway-Cache") == "miss"
                assert h3["X-Pathway-Stamp"] != h1["X-Pathway-Stamp"]
                assert json.loads(b3)["snapshot"]["commit_time"] > json.loads(b1)["snapshot"]["commit_time"]
                _, h4, b4 = _post(srv.port, "/serving/query", payload)
                assert h4.get("X-Pathway-Cache") == "hit" and b4 == b3
                monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "0")
                _, h5, b5 = _post(srv.port, "/serving/query", payload)
                monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "1")
                assert h5.get("X-Pathway-Cache") == "miss"
                assert _sans_wall(b5) == _sans_wall(b3)
                runs.append((_sans_wall(b1), _sans_wall(b3), h1["X-Pathway-Stamp"].split(":")[0]))
            finally:
                srv.stop()
        assert runs[0][:2] == runs[1][:2]

    @pytest.mark.parametrize("pkg", PKGS)
    def test_store_truncate_invalidates_cache(self, monkeypatch, pkg):
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "1")
        rc = _rc(pkg)
        pipe = _Pipeline(pkg, range(8))
        # the process-wide STORE registers this hook at import; private stores wire it
        pipe.store.register_truncate_hook(rc.CACHE.invalidate_above)
        t0 = pipe.store.latest().commit_time
        pipe.insert_commit(range(8, 12))
        srv = _m(pkg, "serving.server").QueryServer(
            store=pipe.store, port=_free_port(), batch_window_ms=0.5).start()
        try:
            _post(srv.port, "/serving/query", {"vector": _vec(1).tolist(), "k": 3})
            assert rc.CACHE.stats()["entries"] >= 1
            before = rc.CACHE.stats()["invalidations"]
            pipe.store.truncate(t0)
            assert rc.CACHE.stats()["invalidations"] > before
            assert rc.CACHE.stats()["entries"] == 0
        finally:
            srv.stop()


# -- snapshot replicas -----------------------------------------------------------------


def _replica(pkg: str, **kw):
    return _m(pkg, "serving.replica").Replica(port=_free_port(), **kw).start()


def _stream(pkg: str, store, **kw):
    return _m(pkg, "serving.stream").SnapshotStreamServer(store=store, **kw).start()


class TestReplica:
    def test_parse_sources(self):
        for pkg in PKGS:
            replica = _m(pkg, "serving.replica")
            assert replica.parse_sources("9001, host2:9002") == [("127.0.0.1", 9001), ("host2", 9002)]
            assert replica.replica_port(3) == _m(PKGS[1], "serving.replica").replica_port(3)

    def test_replica_bit_identical_and_converges(self, monkeypatch):
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "0")
        answers = []
        for pkg in PKGS:
            pipe = _Pipeline(pkg, range(16))
            sport = _free_port()
            stream = _stream(pkg, pipe.store, port=sport)
            rep = _replica(pkg, sources=[("127.0.0.1", sport)], replica_id=0)
            try:
                assert rep.wait_ready(10.0)
                payload = {"vector": _vec(3).tolist(), "k": 3}
                status, _, rep_body = _post(rep.port, "/serving/query", payload)
                assert status == 200
                with pipe.store.acquire_latest() as snap:
                    direct = snap.search(np.asarray([payload["vector"]], np.float32), 3)[0]
                    commit = snap.commit_time
                answer = json.loads(rep_body)
                assert answer["snapshot"]["commit_time"] == commit
                assert answer["hits"][0] == [[repr(key), score] for key, score in direct]
                t2 = pipe.insert_commit(range(16, 24))
                pipe.publish_to(stream)
                assert _wait_for(lambda: _get(rep.port, "/serving/health")[1].get("cut_commit_time") == t2)
                _, _, after = _post(rep.port, "/serving/query", payload)
                answers.append((_sans_wall(rep_body), _sans_wall(after)))
            finally:
                rep.stop()
                stream.stop()
        assert answers[0] == answers[1]

    def test_replica_follows_stream_truncation(self, monkeypatch):
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "0")
        for pkg in PKGS:
            pipe = _Pipeline(pkg, range(8))
            t1 = pipe.insert_commit(range(8, 12))
            t2 = pipe.insert_commit(range(12, 16))
            sport = _free_port()
            stream = _stream(pkg, pipe.store, port=sport)
            rep = _replica(pkg, sources=[("127.0.0.1", sport)], replica_id=1)
            try:
                assert rep.wait_ready(10.0)
                assert _get(rep.port, "/serving/health")[1]["cut_commit_time"] == t2
                stream.on_truncate(t1)

                def rolled_back() -> bool:
                    cut = _get(rep.port, "/serving/health")[1].get("cut_commit_time")
                    return cut is None or cut <= t1

                assert _wait_for(rolled_back)  # readers never see past t1 again
                t3 = pipe.insert_commit(range(16, 20))
                pipe.publish_to(stream)
                assert _wait_for(lambda: _get(rep.port, "/serving/health")[1].get("cut_commit_time") == t3)
                status, _, _ = _post(rep.port, "/serving/query", {"vector": _vec(1).tolist(), "k": 3})
                assert status == 200
            finally:
                rep.stop()
                stream.stop()

    def test_replica_staleness_refusal_503(self, monkeypatch):
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "0")
        refusals = []
        for pkg in PKGS:
            pipe = _Pipeline(pkg, range(8))
            sport = _free_port()
            stream = _stream(pkg, pipe.store, port=sport)
            # the bound is read live: loose until the replica holds its first cut (a
            # frame may take longer than the bound to arrive on a loaded box), then 1 s
            monkeypatch.setenv("PATHWAY_TPU_REPLICA_MAX_STALENESS_S", "60")
            rep = _replica(pkg, sources=[("127.0.0.1", sport)], replica_id=2)
            try:
                assert rep.wait_ready(10.0)
                monkeypatch.setenv("PATHWAY_TPU_REPLICA_MAX_STALENESS_S", "1.0")
                time.sleep(1.2)  # the cut ages past the bound
                status, headers, body = _post(rep.port, "/serving/query",
                                              {"vector": _vec(1).tolist(), "k": 3})
                assert status == 503 and "Retry-After" in headers
                refusals.append((status, headers["Retry-After"], sorted(json.loads(body))))
                rounds = [0]

                def healed() -> bool:  # a fresh publication heals it
                    rounds[0] += 1
                    pipe.insert_commit([8 + rounds[0] % 56])
                    pipe.publish_to(stream)
                    time.sleep(0.05)
                    return _post(rep.port, "/serving/query",
                                 {"vector": _vec(1).tolist(), "k": 3})[0] == 200

                assert _wait_for(healed)
            finally:
                rep.stop()
                stream.stop()
        assert refusals[0] == refusals[1]


# -- federation ---------------------------------------------------------------------


def _client_side_merge(ports: list, payload: dict, k: int):
    """The client-side fan-out merge the front must match bit for bit: per-worker hits
    concatenated in port order, stably sorted on descending score, cut to k."""
    rows: list = []
    commits: list = []
    for port in ports:
        status, _, body = _post(port, "/serving/query", payload)
        assert status == 200
        answer = json.loads(body)
        rows.extend(answer["hits"][0])
        commits.append(answer["snapshot"]["commit_time"])
    rows.sort(key=lambda hit: -hit[1])
    return rows[:k], min(commits)


def _query_server(pkg: str, store):
    return _m(pkg, "serving.server").QueryServer(store=store, port=_free_port(),
                                                 batch_window_ms=0.5).start()


def _front(pkg: str, **kw):
    return _m(pkg, "serving.federation").FederationFront(port=_free_port(), **kw).start()


class TestFederation:
    def test_scatter_parity_bit_identical(self, monkeypatch):
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "0")
        answers = []
        for pkg in PKGS:
            srv_a = _query_server(pkg, _Pipeline(pkg, range(0, 12)).store)
            srv_b = _query_server(pkg, _Pipeline(pkg, range(12, 24)).store)
            front = _front(pkg, worker_ports=[srv_a.port, srv_b.port], replicas=[])
            try:
                payload = {"vector": _vec(5).tolist(), "k": 3}
                status, _, body = _post(front.port, "/serving/query", payload)
                assert status == 200
                fed = json.loads(body)
                merged, min_commit = _client_side_merge([srv_a.port, srv_b.port], payload, 3)
                assert fed["hits"][0] == merged
                assert fed["snapshot"]["commit_time"] == min_commit
                assert (fed["snapshot"]["route"], fed["snapshot"]["fan_out"]) == ("scatter", 2)
                answers.append(_sans_wall(body))
            finally:
                front.stop()
                srv_a.stop()
                srv_b.stop()
        assert answers[0] == answers[1]

    def test_partial_scatter_never_served(self, monkeypatch):
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "0")
        refusals = []
        for pkg in PKGS:
            srv = _query_server(pkg, _Pipeline(pkg, range(12)).store)
            front = _front(pkg, worker_ports=[srv.port, _free_port()], replicas=[])
            try:
                status, headers, _ = _post(front.port, "/serving/query",
                                           {"vector": _vec(5).tolist(), "k": 3})
                assert status == 503 and "Retry-After" in headers
                refusals.append((status, headers["Retry-After"]))
            finally:
                front.stop()
                srv.stop()
        assert refusals[0] == refusals[1]

    def test_replica_route_then_scatter_fallback(self, monkeypatch):
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "0")
        answers = []
        for pkg in PKGS:
            pipe = _Pipeline(pkg, range(16))
            srv = _query_server(pkg, pipe.store)
            sport = _free_port()
            stream = _stream(pkg, pipe.store, port=sport)
            rep = _replica(pkg, sources=[("127.0.0.1", sport)], replica_id=3)
            front = _front(pkg, worker_ports=[srv.port], replicas=[("127.0.0.1", rep.port)])
            try:
                assert rep.wait_ready(10.0)
                payload = {"vector": _vec(7).tolist(), "k": 3}
                status, _, body = _post(front.port, "/serving/query", payload)
                assert status == 200
                via_replica = json.loads(body)
                assert via_replica["snapshot"]["route"] == "replica"
                assert front.stats()["routes"]["replica"] >= 1
                _, _, direct = _post(srv.port, "/serving/query", payload)
                assert via_replica["hits"] == json.loads(direct)["hits"]
                rep.stop()  # a dead replica degrades to the scatter, never to a 5xx
                status, _, fallback = _post(front.port, "/serving/query", payload)
                assert status == 200
                assert json.loads(fallback)["snapshot"]["route"] == "scatter"
                answers.append((via_replica["hits"], _sans_wall(fallback)))
            finally:
                front.stop()
                rep.stop()
                stream.stop()
                srv.stop()
        assert answers[0] == answers[1]


# -- chaos: failover and rescale under paced load ----------------------------------------


class TestReadTierChaos:
    def test_bounded_staleness_through_failover_and_rescale(self, monkeypatch):
        """Paced query load against a port replica while the publisher (a) dies and is
        replaced on its port at a higher epoch and (b) the stream's width rescales
        1 -> 2: every answer is 200 or 503, the served staleness stays inside the
        bound, the replica's piggybacked metrics render under ``worker="r0"`` in the
        worker's exposition and history ring while it is subscribed, and leave both
        when it disconnects."""
        from pathway_tpu_torch import serving
        from pathway_tpu_torch.internals import monitoring, timeseries
        from pathway_tpu_torch.serving.stream import SnapshotStreamServer

        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "0")
        monkeypatch.setenv("PATHWAY_PROCESSES", "1")
        base = _free_port()
        for _ in range(64):  # two adjacent ports for the 1 -> 2 port scheme
            probe = socket.socket()
            try:
                probe.bind(("127.0.0.1", base + 1))
                break
            except OSError:
                base = _free_port()
            finally:
                probe.close()
        monkeypatch.setenv("PATHWAY_TPU_SERVING_STREAM_PORT_BASE", str(base))
        bound = 30.0
        streams: list = []
        pipe0 = _Pipeline(PKGS[0], range(12))
        stream0 = SnapshotStreamServer(store=pipe0.store, port=base, process_id=0).start()
        streams.append(stream0)
        rep = _replica(PKGS[0], width=1, replica_id=0, max_staleness=bound)
        statuses: list = []
        staleness: list = []
        stop = threading.Event()

        def load() -> None:
            while not stop.is_set():
                try:
                    status, _, body = _post(rep.port, "/serving/query",
                                            {"vector": _vec(2).tolist(), "k": 3}, timeout=5.0)
                except OSError:
                    stop.wait(0.05)
                    continue
                statuses.append(status)
                if status == 200 and json.loads(body).get("snapshot"):
                    staleness.append(json.loads(body)["snapshot"]["staleness_s"])
                stop.wait(0.02)

        loader = threading.Thread(target=load, daemon=True)
        next_key = [24]

        def publish(pipe, stream) -> int:
            t = pipe.insert_commit([next_key[0] % 60, next_key[0] % 60 + 1])
            next_key[0] += 2
            pipe.publish_to(stream)
            return t

        try:
            assert rep.wait_ready(10.0)
            loader.start()
            for _ in range(5):
                publish(pipe0, stream0)
                time.sleep(0.05)
            # the replica piggybacks its registry upstream on its receive timeouts
            assert _wait_for(lambda: 0 in stream0.replica_metrics_snapshot(), 8.0)
            # (a) publisher failover: a new incarnation on the same port, epoch bumped
            epoch0 = stream0.epoch()
            stream0.stop()
            time.sleep(0.3)
            stream0b = SnapshotStreamServer(store=pipe0.store, port=base, process_id=0).start()
            streams.append(stream0b)
            stream0b.set_epoch(epoch0 + 1)
            target = publish(pipe0, stream0b)

            def converged() -> bool:
                cut = _get(rep.port, "/serving/health")[1].get("cut_commit_time")
                if cut is not None and cut >= target:
                    return True
                publish(pipe0, stream0b)
                return False

            assert _wait_for(converged, 15.0), "the replica never re-converged after failover"
            # (b) rescale 1 -> 2: a second worker joins at the incumbent's clock
            pipe1 = _Pipeline(PKGS[0], range(30, 42))
            while pipe1.insert_commit([]) < pipe0.store.latest().commit_time:
                pass
            stream1 = SnapshotStreamServer(store=pipe1.store, port=base + 1, process_id=1).start()
            streams.append(stream1)
            monkeypatch.setenv("PATHWAY_PROCESSES", "2")
            rep.on_width(2)

            def widened() -> bool:
                publish(pipe0, stream0b)
                publish(pipe1, stream1)
                health = _get(rep.port, "/serving/health")[1]
                return health.get("sources") == 2 and health.get("cut_commit_time") is not None

            assert _wait_for(widened, 15.0), "the replica never served the 2-source cut"
            stop.set()
            loader.join(timeout=10.0)
            assert statuses and set(statuses) <= {200, 503} and statuses.count(200) > 0
            assert all(s <= bound for s in staleness)
            # the watch plane reads the piggybacked registry: the exposition and the
            # history ring, under worker="r0"
            assert _wait_for(lambda: 0 in stream0b.replica_metrics_snapshot(), 8.0)
            monkeypatch.setattr(serving, "_stream", stream0b)
            monitor = monitoring.StatsMonitor(monitoring.MonitoringLevel.IN_OUT)
            assert 'worker="r0"' in monitor.prometheus_text()
            loop = timeseries.TelemetryLoop(timeseries.STORE, timeseries.SloSentinel())
            loop.tick(now=time.time())
            assert "r0" in _ring_workers("pathway_read_replica_lag_seconds")
            # a replica disconnect prunes its piggybacked metrics and its ring series
            rep.stop()
            assert _wait_for(lambda: stream0b.replica_metrics_snapshot() == {}, 10.0)
            monkeypatch.setattr(serving, "_stream", stream0b)
            assert 'worker="r0"' not in monitor.prometheus_text()
            # the ring's series go once the subscriber's sender thread has stopped
            assert _wait_for(lambda: "r0" not in _ring_workers("pathway_read_replica_lag_seconds"))
        finally:
            stop.set()
            rep.stop()
            for stream in streams:
                stream.stop()


def _ring_workers(family: str) -> set:
    from pathway_tpu_torch.internals import timeseries

    series = timeseries.STORE.query(family, 1e9, now=time.time())["series"]
    return {s["labels"]["worker"] for s in series}


# -- the command line: cli replica and cli federation --------------------------------------


def _cli(args: list[str], env: dict) -> subprocess.Popen:
    full = dict(os.environ)
    full["PYTHONPATH"] = REPO + os.pathsep + full.get("PYTHONPATH", "")
    full.update(env)
    return subprocess.Popen([sys.executable, "-m", "pathway_tpu_torch.cli", *args], env=full,
                            cwd=REPO, start_new_session=True, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)


def _stop_cli(proc: subprocess.Popen) -> int:
    """SIGTERM, then the exit code; a process past its deadline is killed."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=CLI_DEADLINE)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        pytest.fail(f"the command line passed its {CLI_DEADLINE:g} s deadline and was killed")


def _ready(port: int, deadline: float) -> bool:
    while time.monotonic() < deadline:
        try:
            status, health = _get(port, "/serving/health", timeout=2.0)
            if status == 200 and health.get("cut_commit_time") is not None:
                return True
        except OSError:
            pass
        time.sleep(0.1)
    return False


def test_cli_replica_and_federation_answer_as_the_worker(monkeypatch):
    """``cli replica`` subscribes to a worker's stream and answers its queries as the
    worker does; ``cli federation`` fronts the worker and that replica, routes to the
    replica, and scatters once the replica is gone; both exit 0 on SIGTERM. The JAX
    package's front answers the same payload with the same hits."""
    monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "0")
    pipe = _Pipeline(PKGS[0], range(16))
    srv = _query_server(PKGS[0], pipe.store)
    sport = _free_port()
    stream = _stream(PKGS[0], pipe.store, port=sport)
    rport, fport = _free_port(), _free_port()
    replica = _cli(["replica", "--port", str(rport), "--replica-id", "4",
                    "--sources", f"127.0.0.1:{sport}", "--max-staleness-s", "120"], {})
    front = None
    try:
        assert _ready(rport, time.monotonic() + CLI_DEADLINE), \
            replica.stderr.read().decode()[-2000:] if replica.poll() is not None else "not ready"
        payload = {"vector": _vec(4).tolist(), "k": 3}
        _, _, direct = _post(srv.port, "/serving/query", payload)
        status, _, via_replica = _post(rport, "/serving/query", payload)
        assert status == 200
        assert json.loads(via_replica)["hits"] == json.loads(direct)["hits"]
        front = _cli(["federation", "--port", str(fport), "--workers", str(srv.port),
                      "--replicas", f"127.0.0.1:{rport}"], {})
        deadline = time.monotonic() + CLI_DEADLINE
        while time.monotonic() < deadline:
            try:
                status, _, fed = _post(fport, "/serving/query", payload, timeout=2.0)
                break
            except OSError:
                time.sleep(0.1)
        assert status == 200 and json.loads(fed)["snapshot"]["route"] == "replica"
        assert json.loads(fed)["hits"] == json.loads(direct)["hits"]
        assert _stop_cli(replica) == 0
        status, _, fed = _post(fport, "/serving/query", payload)
        assert status == 200 and json.loads(fed)["snapshot"]["route"] == "scatter"
        assert json.loads(fed)["hits"] == json.loads(direct)["hits"]
        jpipe = _Pipeline(PKGS[1], range(16))
        jsrv = _query_server(PKGS[1], jpipe.store)
        jfront = _front(PKGS[1], worker_ports=[jsrv.port], replicas=[])
        try:
            _, _, jfed = _post(jfront.port, "/serving/query", payload)
        finally:
            jfront.stop()
            jsrv.stop()
        assert json.loads(jfed)["hits"] == json.loads(fed)["hits"]
        assert _stop_cli(front) == 0
    finally:
        for proc in (replica, front):
            if proc is not None and proc.poll() is None:
                _stop_cli(proc)
        stream.stop()
        srv.stop()
