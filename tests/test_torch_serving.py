"""The port's snapshot read plane (``pathway_tpu_torch/serving``) against the JAX
package's: per-commit immutable views, copy-on-write KNN read views, refcounted
reclamation, the HTTP query front's admission control and micro-batching, the
runners' publication at 1 worker, ``threads=N`` and N processes, and the mesh's
rollback.

Each case runs the same seeded inputs through both packages on the CPU and compares
what they answer: tables by ``repr`` of their keys and rows, KNN hits by ``repr`` of
their keys and their scores, HTTP answers by status and body. The host index is
NumPy in both packages, so its hits and scores are equal bit for bit; a view of the
port's ``DeviceKnnIndex`` (CPU tensors here) is held to the JAX device view within
``KNN_SCORE_TOL``, a matmul in f32 that torch and XLA sum in another order.

The mesh cases spawn the port's streaming word count over 3 processes of one thread
with ``python -m pathway_tpu_torch.cli spawn`` in a session of its own, under a
deadline that kills the process group (``MESH_DEADLINE``). Every HTTP call has its
own timeout.
"""

from __future__ import annotations

import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("pathway_tpu_torch", "pathway_tpu")
#: one cosine in f32, rounded apart by the order of its sums (torch against XLA)
KNN_SCORE_TOL = 1e-6
#: one mesh's wall-clock budget in these tests (seconds)
MESH_DEADLINE = 150.0
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


def _free_port_base(n: int) -> int:
    """A base port such that base..base+n-1 are currently bindable."""
    for _ in range(64):
        base = _free_port()
        if base + n >= 65535:
            continue
        ok = True
        for i in range(n):
            s = socket.socket()
            try:
                s.bind(("127.0.0.1", base + i))
            except OSError:
                ok = False
                break
            finally:
                s.close()
        if ok:
            return base
    raise RuntimeError("no free port range found")


def _serving_env(monkeypatch, n: int = 1) -> None:
    """Serving on, with free ports for every listener a run may start: each package's
    run gets its own query, stream, federation and replica bases."""
    monkeypatch.setenv("PATHWAY_TPU_SERVING", "1")
    monkeypatch.setenv("PATHWAY_TPU_SERVING_PORT_BASE", str(_free_port_base(n)))
    monkeypatch.setenv("PATHWAY_TPU_SERVING_STREAM_PORT_BASE", str(_free_port_base(n)))
    monkeypatch.setenv("PATHWAY_TPU_FEDERATION_PORT", str(_free_port()))
    monkeypatch.setenv("PATHWAY_TPU_REPLICA_PORT_BASE", str(_free_port_base(1)))


def _hits(rows) -> list:
    """KNN hits as plain values: ``[[(repr(key), score), ...], ...]``."""
    return [[(repr(k), float(s)) for k, s in row] for row in rows]


def _table(rows: dict) -> dict:
    return {repr(k): tuple(repr(x) for x in row) for k, row in rows.items()}


def _assert_close_hits(ours, theirs, tol=KNN_SCORE_TOL):
    assert [[k for k, _ in row] for row in ours] == [[k for k, _ in row] for row in theirs]
    np.testing.assert_allclose([s for row in ours for _, s in row],
                               [s for row in theirs for _, s in row], rtol=0, atol=tol)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    from pathway_tpu_torch.engine import device_ops

    device_ops.configure(device="cpu")
    for pkg in PKGS:
        _m(pkg, "serving").STORE.clear()
        _m(pkg, "serving.result_cache").CACHE.clear()
    yield
    for pkg in PKGS:
        serving = _m(pkg, "serving")
        serving.stop_server()
        serving.STORE.clear()
        _m(pkg, "serving.result_cache").CACHE.clear()
        _m(pkg, "internals.parse_graph").G.clear()
    device_ops.configure()


# -- KNN read views -----------------------------------------------------------------


def _host_view_scenario(pkg: str) -> list:
    ei, ref = _m(pkg, "engine.external_index"), _m(pkg, "engine.value").ref_scalar
    index = ei.HostKnnIndex(dim=6, capacity=8)
    index.add([ref(i) for i in range(4)], [_vec(i) for i in range(4)])
    view = index.read_view()
    before = view.search([_vec(0)], 3)
    # the view first shares the live arrays (no copy at publication)
    assert view.state.vectors is index.state.vectors
    index.add([ref(0)], [_vec(99)])
    index.remove([ref(1)])
    index.add([ref(9)], [_vec(9)])
    # the scatter cloned first: the view answers as of its publication
    assert view.search([_vec(0)], 3) == before
    assert view.state.vectors is not index.state.vectors
    live = index.search([_vec(99)], 1)[0]
    assert live[0][0] == ref(0)
    return _hits(before) + _hits(index.search([_vec(0), _vec(9)], 3))


class TestKnnReadViews:
    def test_host_view_is_frozen_while_live_index_moves(self):
        ours, theirs = (_host_view_scenario(pkg) for pkg in PKGS)
        assert ours == theirs

    def test_host_view_growth_leaves_view_intact(self):
        answers = []
        for pkg in PKGS:
            ei, ref = _m(pkg, "engine.external_index"), _m(pkg, "engine.value").ref_scalar
            index = ei.HostKnnIndex(dim=6, capacity=2)
            index.add([ref(0)], [_vec(0)])
            view = index.read_view()
            before = view.search([_vec(0)], 2)
            index.add([ref(i) for i in range(1, 6)], [_vec(i) for i in range(1, 6)])  # grows
            assert view.search([_vec(0)], 2) == before
            assert index.capacity > view.capacity
            answers.append(_hits(before) + _hits(index.search([_vec(0)], 4)))
        assert answers[0] == answers[1]

    def test_two_views_from_successive_commits_differ(self):
        for pkg in PKGS:
            ei, ref = _m(pkg, "engine.external_index"), _m(pkg, "engine.value").ref_scalar
            index = ei.HostKnnIndex(dim=6, capacity=8)
            index.add([ref(0)], [_vec(0)])
            v1 = index.read_view()
            index.add([ref(1)], [_vec(1)])
            v2 = index.read_view()
            assert (len(v1.key_to_slot), len(v2.key_to_slot)) == (1, 2)
            assert _hits(v1.search([_vec(1)], 2)) != _hits(v2.search([_vec(1)], 2))

    def test_device_view_copies_donated_buffers(self):
        """``knn_update`` writes the live tensors in place (the JAX package donates
        them): the view holds its own copy, and answers as the JAX view does."""
        answers = []
        for pkg in PKGS:
            ei, ref = _m(pkg, "engine.external_index"), _m(pkg, "engine.value").ref_scalar
            extra = {"device": "cpu"} if pkg == PKGS[0] else {}
            index = ei.DeviceKnnIndex(dim=6, capacity=8, **extra)
            index.add([ref(i) for i in range(3)], [_vec(i) for i in range(3)])
            view = index.read_view()
            before = view.search([_vec(1)], 2)
            index.add([ref(1)], [_vec(42)])
            index.remove([ref(0)])
            assert view.search([_vec(1)], 2) == before
            if pkg == PKGS[0]:
                for mine, live in zip(view.state, index.state):
                    assert mine.data_ptr() != live.data_ptr()
            answers.append(_hits(before))
        _assert_close_hits(*answers)

    def test_host_device_view_parity(self):
        answers = []
        for pkg in PKGS:
            ei, ref = _m(pkg, "engine.external_index"), _m(pkg, "engine.value").ref_scalar
            extra = {"device": "cpu"} if pkg == PKGS[0] else {}
            keys, vecs = [ref(i) for i in range(5)], [_vec(i) for i in range(5)]
            host, dev = ei.HostKnnIndex(dim=6, capacity=8), ei.DeviceKnnIndex(dim=6, capacity=8, **extra)
            host.add(keys, vecs)
            dev.add(keys, vecs)
            q = [_vec(2), _vec(4)]
            hv, dv = _hits(host.read_view().search(q, 3)), _hits(dev.read_view().search(q, 3))
            _assert_close_hits(hv, dv)
            answers += [hv, dv]
        assert answers[0] == answers[2]  # the host views, bit for bit
        _assert_close_hits(answers[1], answers[3])


# -- the snapshot store --------------------------------------------------------------


def _groupby_scope(pkg: str, rows: list[tuple[int, int]]):
    """A tiny engine scope: input -> count-groupby on column 0."""
    graph, ref = _m(pkg, "engine.graph"), _m(pkg, "engine.value").ref_scalar
    sc = graph.Scope()
    session = sc.input_session(arity=2)
    node = graph.GroupbyNode(sc, session, [0], [(_m(pkg, "engine.reducers").CountReducer(), [])])
    sched = graph.Scheduler(sc)
    for i, row in enumerate(rows):
        session.insert(ref(i), row)
    return sc, session, node, sched, ref


def _store(pkg: str, **kw):
    return _m(pkg, "serving.snapshot").SnapshotStore(**kw)


class TestSnapshotStore:
    @pytest.mark.parametrize("pkg", PKGS)
    def test_published_view_matches_sync_read_and_stays_frozen(self, pkg):
        sc, session, node, sched, ref = _groupby_scope(pkg, [(1, 10), (2, 20), (1, 30)])
        store = _store(pkg, depth=4)
        store.publish([sc], sched.commit())
        snap1 = store.acquire_latest()
        sync1 = dict(node.current)
        assert snap1.table(node.index) == sync1
        session.insert(ref(10), (1, 40))
        session.remove(ref(1), (2, 20))
        store.publish([sc], sched.commit())
        assert snap1.table(node.index) == sync1
        snap2 = store.acquire_latest()
        assert snap2.table(node.index) == dict(node.current) != sync1
        assert snap2.seq > snap1.seq
        tables = (_table(snap1.table(node.index)), _table(snap2.table(node.index)))
        snap1.release()
        snap2.release()
        if pkg == PKGS[0]:
            theirs = TestSnapshotStore._jax_tables
            assert tables == theirs

    # the JAX package's answer to the case above, computed once for the comparison
    _jax_tables: tuple = ()

    @pytest.fixture(autouse=True, scope="class")
    def _jax_reference(self):
        sc, session, node, sched, ref = _groupby_scope(PKGS[1], [(1, 10), (2, 20), (1, 30)])
        store = _store(PKGS[1], depth=4)
        store.publish([sc], sched.commit())
        first = _table(store.latest().table(node.index))
        session.insert(ref(10), (1, 40))
        session.remove(ref(1), (2, 20))
        store.publish([sc], sched.commit())
        TestSnapshotStore._jax_tables = (first, _table(store.latest().table(node.index)))

    @pytest.mark.parametrize("pkg", PKGS)
    def test_refcount_never_frees_mid_query(self, pkg):
        sc, session, node, sched, ref = _groupby_scope(pkg, [(1, 1)])
        store = _store(pkg, depth=2)
        store.publish([sc], sched.commit())
        held = store.acquire_latest()
        expected = held.table(node.index)
        for i in range(5):  # evict the held snapshot from the ring
            session.insert(ref(100 + i), (i, i))
            store.publish([sc], sched.commit())
        assert held.commit_time not in [s.commit_time for s in store.snapshots()]
        assert not held.closed  # the reader's pin keeps it alive
        assert held.table(node.index) == expected
        held.release()
        assert held.closed and held.acquire() is False
        with pytest.raises(RuntimeError, match="after reclamation"):
            held.table(node.index)

    def test_truncate_drops_rolled_back_commits(self):
        retained = []
        for pkg in PKGS:
            sc, session, node, sched, ref = _groupby_scope(pkg, [(1, 1)])
            store = _store(pkg, depth=8)
            times = []
            for i in range(4):
                session.insert(ref(50 + i), (i, i))
                times.append(sched.commit())
                store.publish([sc], times[-1])
            store.truncate(times[1])
            assert [s.commit_time for s in store.snapshots()] == times[:2]
            assert store.acquire_latest().commit_time == times[1]
            retained.append([(s.commit_time, s.seq, _table(s.table())) for s in store.snapshots()])
        assert retained[0] == retained[1]

    def test_publish_at_same_time_replaces_not_duplicates(self):
        for pkg in PKGS:
            sc, _session, _node, sched, _ref = _groupby_scope(pkg, [(1, 1)])
            store = _store(pkg, depth=8)
            t = sched.commit()
            first = store.publish([sc], t)
            second = store.publish([sc], t)  # a commit re-driven after a rollback
            assert [s.commit_time for s in store.snapshots()] == [t]
            assert first.closed and not second.closed

    def test_acquire_at(self):
        for pkg in PKGS:
            sc, session, _node, sched, ref = _groupby_scope(pkg, [(1, 1)])
            store = _store(pkg, depth=8)
            times = []
            for i in range(3):
                session.insert(ref(60 + i), (i, i))
                times.append(sched.commit())
                store.publish([sc], times[-1])
            snap = store.acquire_at(times[1])
            assert snap.commit_time == times[1]
            snap.release()
            assert store.acquire_at(times[0] - 1) is None

    @pytest.mark.parametrize("device_index", [False, True])
    def test_restore_roundtrip_preserves_search_and_table(self, device_index):
        """A payload restores as a host index in both packages (a replica searches
        on the host), with the JAX package's hits and table; a view of the port's
        ``DeviceKnnIndex`` is fetched whole to the host by ``payload()``."""
        answers = []
        for pkg in PKGS:
            graph, ei = _m(pkg, "engine.graph"), _m(pkg, "engine.external_index")
            ref = _m(pkg, "engine.value").ref_scalar
            sc = graph.Scope()
            index_in, query_in = sc.input_session(arity=1), sc.input_session(arity=1)
            extra = {"device": "cpu"} if pkg == PKGS[0] else {}
            index = ei.DeviceKnnIndex(dim=6, capacity=8, **extra) if device_index else \
                ei.HostKnnIndex(dim=6, capacity=8)
            node = ei.ExternalIndexNode(sc, index_in, query_in, index, index_col=0, query_col=0, k=3)
            sched = graph.Scheduler(sc)
            for i in range(5):
                index_in.insert(ref(i), (tuple(_vec(i).tolist()),))
            src = _store(pkg, depth=2)
            src.publish([sc], sched.commit())
            payload = src.latest().payload()
            knn = payload["workers"][0][node.index]["knn"]
            assert knn["vectors"].dtype == np.float32 and knn["vectors"].shape == (8, 6)
            restored = _store(pkg, depth=2).restore(payload)
            assert isinstance(restored.views[0][node.index]["knn"], ei.HostKnnIndex)
            orig = src.acquire_latest()
            q = [_vec(2)]
            if device_index:
                _assert_close_hits(_hits(restored.search(q, 3)), _hits(orig.search(q, 3)))
            else:
                assert restored.search(q, 3) == orig.search(q, 3)
            assert restored.table(node.index) == orig.table(node.index)
            assert restored.commit_time == orig.commit_time
            orig.release()
            answers.append((_hits(restored.search(q, 3)), _table(restored.table(node.index))))
        if device_index:
            _assert_close_hits(answers[0][0], answers[1][0])
            assert answers[0][1] == answers[1][1]
        else:
            assert answers[0] == answers[1]

    def test_restore_refuses_format_mismatch(self):
        for pkg in PKGS:
            fmt = _m(pkg, "engine.persistence").STATE_FORMAT
            with pytest.raises(ValueError, match="state format"):
                _store(pkg).restore({"format": fmt + 1, "workers": []})

    def test_restore_refuses_fingerprint_mismatch(self):
        for pkg in PKGS:
            fmt = _m(pkg, "engine.persistence").STATE_FORMAT
            with pytest.raises(ValueError, match="graph-optimizer plan"):
                _store(pkg).restore({"format": fmt, "optimize": ["fuse_select"], "workers": []},
                                    expected_fingerprint=["fuse_select", "dedup_columns"])


# -- publication by the runners -----------------------------------------------------


def _run_wordcount(pkg: str, monkeypatch, threads: int, pace_s: float = 0.0) -> tuple[set, set]:
    """A streaming word count under serving: (the published view's groupby rows, the
    sink subscription's rows), as ``repr`` strings. ``pace_s`` sleeps after every
    eighth word, so the stream spans several commits."""
    pw = importlib.import_module(pkg)
    G = _m(pkg, "internals.parse_graph").G
    STORE = _m(pkg, "serving").STORE
    _serving_env(monkeypatch)
    G.clear()
    STORE.clear()
    words = [f"w{i % 5}" for i in range(23)]

    class Feed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for i, w in enumerate(words):
                self.next(word=w)
                if pace_s and i % 8 == 7:
                    time.sleep(pace_s)

    table = pw.io.python.read(Feed(), schema=pw.schema_from_types(word=str),
                              autocommit_duration_ms=20)
    counts = table.groupby(table.word).reduce(word=table.word, cnt=pw.reducers.count())
    sync_rows: dict = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            sync_rows[repr(key)] = (repr(row["word"]), repr(row["cnt"]))
        else:
            sync_rows.pop(repr(key), None)

    pw.io.subscribe(counts, on_change=on_change)
    try:
        pw.run(monitoring_level=None, threads=threads)
    finally:
        G.clear()
    assert _m(pkg, "serving").query_server() is None  # the run stopped its server
    snap = STORE.acquire_latest()
    assert snap is not None, "no snapshot published"
    try:
        positions = [pos for pos, entry in snap._entries() if entry["node"] == "GroupbyNode"]
        assert positions, "no groupby state in the snapshot"
        snap_rows = set(_table(snap.table(positions[0])).items())
    finally:
        snap.release()
    expected = {}
    for w in words:
        expected[w] = expected.get(w, 0) + 1
    assert {(eval(w), eval(c)) for _, (w, c) in snap_rows} == set(expected.items())
    return snap_rows, set(sync_rows.items())


def test_single_worker_snapshot_bit_identical_to_sync_read(monkeypatch):
    ours = _run_wordcount(PKGS[0], monkeypatch, threads=1)
    theirs = _run_wordcount(PKGS[1], monkeypatch, threads=1)
    assert ours[0] == ours[1] == theirs[0] == theirs[1]


def test_sharded_snapshot_merges_to_sync_read(monkeypatch):
    ours = _run_wordcount(PKGS[0], monkeypatch, threads=3)
    theirs = _run_wordcount(PKGS[1], monkeypatch, threads=3)
    assert ours[0] == ours[1] == theirs[0] == theirs[1]


def test_every_commit_publishes_at_one_and_n_threads(monkeypatch):
    """One snapshot a commit, stamped with that commit's time, at 1 and 3 workers, over
    a stream paced across several commits, as in the JAX package."""
    counts = {}
    for pkg in PKGS:
        for threads in (1, 3):
            serving = _m(pkg, "serving")
            published: list[int] = []
            real = serving.STORE.publish

            def spy(scopes, time, _real=real, _out=published):
                _out.append(int(time))
                return _real(scopes, time)

            monkeypatch.setattr(serving.STORE, "publish", spy)
            _run_wordcount(pkg, monkeypatch, threads=threads, pace_s=0.2)
            monkeypatch.undo()
            assert published and published == sorted(set(published))
            counts[(pkg, threads)] = len(published)
    assert all(n >= 3 for n in counts.values()), counts


def test_mid_stream_snapshot_survives_later_commits(monkeypatch):
    """A snapshot acquired mid-stream keeps answering as of its acquisition while
    ingest and the store's eviction go on behind it."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals.parse_graph import G
    from pathway_tpu_torch.serving.snapshot import STORE

    _serving_env(monkeypatch)
    monkeypatch.setenv("PATHWAY_TPU_SNAPSHOT_DEPTH", "2")
    held: list = []
    frozen: list = []
    gate = threading.Event()

    class Feed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for i in range(40):
                self.next(word=f"w{i % 4}")
                if i == 20:
                    gate.wait(10.0)

    table = pw.io.python.read(Feed(), schema=pw.schema_from_types(word=str),
                              autocommit_duration_ms=10)
    counts = table.groupby(table.word).reduce(word=table.word, cnt=pw.reducers.count())

    def on_change(key, row, time, is_addition):
        if not held:
            snap = STORE.acquire_latest()
            if snap is not None:
                held.append(snap)
                frozen.append(dict(snap.table()))
        gate.set()

    pw.io.subscribe(counts, on_change=on_change)
    try:
        pw.run(monitoring_level=None)
    finally:
        G.clear()
    assert held, "the subscriber never saw a published snapshot"
    snap = held[0]
    final = STORE.latest()
    assert final is not None and final.seq > snap.seq
    assert not snap.closed, "the held snapshot was reclaimed mid-read"
    assert dict(snap.table()) == frozen[0]
    STORE.clear()  # the store's own pins go: the reader's is the last
    assert not snap.closed
    snap.release()
    assert snap.closed


def _knn_run(pkg: str, monkeypatch) -> tuple[tuple, list]:
    """The dataflow's as-of-now KNN answer to one query, and the published view's."""
    pw = importlib.import_module(pkg)
    G = _m(pkg, "internals.parse_graph").G
    STORE = _m(pkg, "serving").STORE
    indexing = _m(pkg, "stdlib.indexing")
    _serving_env(monkeypatch)
    G.clear()
    dim, n = 8, 24
    vecs = [_vec(i, dim) for i in range(n)]
    ingest_done = threading.Event()

    class Docs(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for i in range(n):
                self.next(doc_id=i, emb_id=i)

    class Queries(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            ingest_done.wait(15.0)
            self.next(query_id=0, emb_id=3)

    def emb_of(i: int) -> np.ndarray:
        return vecs[i]

    docs = pw.io.python.read(Docs(), schema=pw.schema_from_types(doc_id=int, emb_id=int),
                             autocommit_duration_ms=20)
    docs = docs.select(doc_id=pw.this.doc_id, emb=pw.apply(emb_of, pw.this.emb_id))
    queries = pw.io.python.read(Queries(), schema=pw.schema_from_types(query_id=int, emb_id=int),
                                autocommit_duration_ms=None)
    queries = queries.select(query_id=pw.this.query_id, qemb=pw.apply(emb_of, pw.this.emb_id))
    index = indexing.DataIndex(docs, indexing.HostKnnFactory(dimensions=dim, capacity=32), docs.emb)
    res = index.query_as_of_now(queries, queries.qemb, number_of_matches=3)
    seen = [0]
    answers: dict = {}

    def on_doc(key, row, time, is_addition):
        if is_addition:
            seen[0] += 1
            if seen[0] == n:
                ingest_done.set()

    def on_answer(key, row, time, is_addition):
        if is_addition:
            answers[row["query_id"]] = tuple(repr(k) for k in row["_pw_index_reply_ids"])

    pw.io.subscribe(docs, on_change=on_doc)
    pw.io.subscribe(res, on_change=on_answer)
    try:
        pw.run(monitoring_level=None)
    finally:
        G.clear()
    assert answers, "the dataflow's query never answered"
    snap = STORE.acquire_latest()
    try:
        hits = _hits(snap.search([vecs[3]], 3))
    finally:
        snap.release()
    return answers[0], hits


def test_knn_snapshot_search_matches_dataflow_answer(monkeypatch):
    """The published KNN view answers with the hit set the dataflow's own as-of-now
    index produced at that commit, and with the JAX package's hits and scores."""
    ours, theirs = _knn_run(PKGS[0], monkeypatch), _knn_run(PKGS[1], monkeypatch)
    assert tuple(k for k, _ in ours[1][0]) == ours[0]
    assert ours == theirs


# -- the HTTP query front -------------------------------------------------------------


def _knn_store(pkg: str, n: int = 16):
    """A store holding one published snapshot of an ``n``-vector host index."""
    graph, ei = _m(pkg, "engine.graph"), _m(pkg, "engine.external_index")
    ref = _m(pkg, "engine.value").ref_scalar
    sc = graph.Scope()
    index_in, query_in = sc.input_session(arity=1), sc.input_session(arity=1)
    ei.ExternalIndexNode(sc, index_in, query_in, ei.HostKnnIndex(dim=6, capacity=32),
                         index_col=0, query_col=0, k=3)
    sched = graph.Scheduler(sc)
    for i in range(n):
        index_in.insert(ref(i), (tuple(_vec(i).tolist()),))
    store = _store(pkg, depth=3)
    store.publish([sc], sched.commit())
    return store


def _post(port: int, path: str, payload, timeout: float = HTTP_TIMEOUT):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        body = payload if isinstance(payload, bytes) else json.dumps(payload)
        conn.request("POST", path, body=body, headers={"Content-Type": "application/json"})
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
    """An answer without its wall-clock fields (staleness, publication wall)."""
    answer = json.loads(body)
    snap = answer.get("snapshot")
    if isinstance(snap, dict):
        for field in ("staleness_s", "published"):
            snap.pop(field, None)
    return answer


def _servers(**kw):
    """The same store and query server in both packages: [(store, server), ...]."""
    out = []
    for pkg in PKGS:
        store = _knn_store(pkg)
        out.append((store, _m(pkg, "serving.server").QueryServer(
            store=store, port=_free_port(), **kw).start()))
    return out


class TestQueryServer:
    def test_query_health_stats_endpoints(self, monkeypatch):
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "0")
        pair = _servers(batch_window_ms=1.0)
        try:
            bodies = []
            for store, srv in pair:
                status, _, body = _post(srv.port, "/serving/query",
                                        {"vector": _vec(2).tolist(), "k": 3})
                assert status == 200
                out = json.loads(body)
                assert len(out["hits"][0]) == 3 and out["snapshot"]["commit_time"] >= 0
                with store.acquire_latest() as expect:
                    want = [[repr(k), s] for k, s in expect.search([_vec(2)], 3)[0]]
                assert out["hits"][0] == want
                status, lookup_body = _post(srv.port, "/serving/lookup", {"keys": []})[0::2]
                assert status == 200
                health = _get(srv.port, "/serving/health")[1]
                assert health["ok"] and health["depth"] == 1
                stats = _get(srv.port, "/serving/stats")[1]
                assert stats["requests"] >= 1 and "latency_ms" in stats
                bodies.append((_sans_wall(body), _sans_wall(lookup_body)))
            assert bodies[0] == bodies[1]
        finally:
            for _, srv in pair:
                srv.stop()

    def test_no_snapshot_answers_200_empty_never_5xx(self):
        answers = []
        for pkg in PKGS:
            srv = _m(pkg, "serving.server").QueryServer(
                store=_store(pkg), port=_free_port(), batch_window_ms=0.5).start()
            try:
                status, _, body = _post(srv.port, "/serving/query", {"vector": [0.0] * 6})
                assert status == 200
                assert json.loads(body) == {"hits": [[]], "snapshot": None}
                answers.append((status, body))
            finally:
                srv.stop()
        assert answers[0] == answers[1]

    def test_malformed_request_is_400_not_500(self):
        pair = _servers()
        try:
            statuses = []
            for _, srv in pair:
                got = [_post(srv.port, "/serving/query", {"k": 3})[0],
                       _post(srv.port, "/serving/query", {"vector": [[1.0]], "k": 3})[0],
                       _post(srv.port, "/serving/query", b"{not json")[0],
                       _post(srv.port, "/serving/nowhere", {})[0]]
                assert got[0] == 400 and got[1] in (200, 400) and got[2] == 400
                assert all(s < 500 for s in got)
                statuses.append(got)
            assert statuses[0] == statuses[1]
        finally:
            for _, srv in pair:
                srv.stop()

    def test_admission_shed_503_with_retry_after(self):
        """Stall the one pool worker and fill the admission queue: the next
        connection gets an immediate 503 with ``Retry-After``."""
        from pathway_tpu_torch.serving import server as srv_mod

        srv = srv_mod.QueryServer(store=_knn_store(PKGS[0]), port=_free_port(),
                                  queue_size=1, threads=1).start()
        stalled: list[socket.socket] = []
        try:
            for _ in range(2):
                stalled.append(socket.create_connection(("127.0.0.1", srv.port), timeout=5))
            time.sleep(0.3)  # the accept loop queues them
            shed_before = srv_mod._SHED.value
            deadline = time.monotonic() + 10
            saw_503 = False
            while time.monotonic() < deadline and not saw_503:
                try:
                    status, headers, _ = _post(srv.port, "/serving/query",
                                               {"vector": _vec(0).tolist()}, timeout=2.0)
                except OSError:
                    continue  # admitted behind the stalled worker: the next one sheds
                if status == 503:
                    saw_503 = True
                    assert headers.get("Retry-After") == "1"
            assert saw_503, "a full queue never shed a 503"
            assert srv_mod._SHED.value > shed_before
        finally:
            for s in stalled:
                s.close()
            srv.stop()

    def test_micro_batching_packs_concurrent_queries(self):
        """24 concurrent queries take fewer searches than 24, and each answer is the
        snapshot's own search of that one query, bit for bit (the host index)."""
        for pkg in PKGS:
            store = _knn_store(pkg)
            batcher = _m(pkg, "serving.server")._MicroBatcher(store, window_s=0.05)
            batcher.start()
            try:
                results: list = [None] * 24

                def go(i: int) -> None:
                    results[i] = batcher.submit(np.asarray([_vec(i % 16)]), 3)

                threads = [threading.Thread(target=go, args=(i,)) for i in range(24)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(15.0)
                assert all(r is not None for r in results)
                assert batcher.dispatches < 24
                with store.acquire_latest() as expect:
                    for i, (hits, meta) in enumerate(results):
                        assert hits[0] == expect.search([_vec(i % 16)], 3)[0]
                        assert meta["seq"] == expect.seq
            finally:
                batcher.stop()


def test_a_failed_search_reaches_every_waiter_and_the_client_as_500(monkeypatch):
    """Deliberate difference: a search that raises (a CUDA error on the card) is
    handed to every waiter of its batch and answered 500 naming it, never an empty
    hit list; the reference's handler lets the connection drop."""
    from pathway_tpu_torch.serving import server as srv_mod
    from pathway_tpu_torch.serving import snapshot as snap_mod

    monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "0")
    store = _knn_store(PKGS[0])

    def broken(self, queries, k, node=None):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(snap_mod.ReadSnapshot, "search", broken)
    batcher = srv_mod._MicroBatcher(store, window_s=0.01)
    batcher.start()
    try:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            batcher.submit(np.asarray([_vec(1)]), 3)
    finally:
        batcher.stop()
    srv = srv_mod.QueryServer(store=store, port=_free_port(), batch_window_ms=0.5).start()
    try:
        errors_before = srv_mod._ERRORS.value
        status, _, body = _post(srv.port, "/serving/query", {"vector": _vec(1).tolist(), "k": 3})
        assert status == 500
        assert "illegal memory access" in json.loads(body)["error"]
        assert srv_mod._ERRORS.value == errors_before + 1
        assert _get(srv.port, "/serving/health")[0] == 200  # the server answers on
    finally:
        srv.stop()


def test_suggested_batch_reads_the_pipeline_controller(monkeypatch):
    """Deliberate difference: the batch bound is the device pipeline's controller,
    read with no ``try`` around it (the reference falls back to 1024 on any error)."""
    from pathway_tpu_torch.engine import device_pipeline
    from pathway_tpu_torch.serving import server as srv_mod

    monkeypatch.setattr(device_pipeline.PIPELINE.controller, "batch_size", 37)
    assert srv_mod._suggested_batch() == 37
    monkeypatch.setattr(device_pipeline.PIPELINE.controller, "batch_size", 0)
    assert srv_mod._suggested_batch() == 1


def test_a_bind_failure_raises_and_leaves_nothing_listening(monkeypatch):
    """Deliberate difference: ``start_server`` (so ``pw.run``) raises the bind's
    ``OSError`` on the caller's thread and stops what it had started; the reference
    records ``serving_bind_failed`` and runs on with no server."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch import serving

    _serving_env(monkeypatch)
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen(1)
    try:
        monkeypatch.setenv("PATHWAY_TPU_SERVING_STREAM_PORT_BASE", str(taken.getsockname()[1]))
        query_port = int(os.environ["PATHWAY_TPU_SERVING_PORT_BASE"])
        with pytest.raises(OSError):
            serving.start_server()
        assert serving.query_server() is None and serving.stream_server() is None
        with pytest.raises(OSError):  # the query server it had started is closed
            socket.create_connection(("127.0.0.1", query_port), timeout=2).close()
        t = pw.debug.table_from_rows(pw.schema_from_types(a=int), [(1,)])
        pw.io.subscribe(t, on_change=lambda *a, **k: None)
        with pytest.raises(OSError):
            pw.run(monitoring_level=None)
    finally:
        taken.close()


# -- the mesh (3 processes of one thread) ----------------------------------------------


MESH_PROGRAM = """
    import json
    import os
    import pathway_tpu_torch as pw
    import pathway_tpu_torch.engine.connectors as _conn
    from pathway_tpu_torch.engine import device_ops
    from pathway_tpu_torch.persistence import Backend, Config, PersistenceMode
    from pathway_tpu_torch.serving.snapshot import STORE

    device_ops.configure(device="cpu")
    _orig_poll = _conn.FsReader.poll
    def _poll(self):
        entries, done = _orig_poll(self)
        if not entries and os.path.exists({stop!r}):
            done = True
        return entries, done
    _conn.FsReader.poll = _poll

    published = []
    _orig_publish = STORE.publish
    def _publish(scopes, time):
        published.append(int(time))
        return _orig_publish(scopes, time)
    STORE.publish = _publish

    words = pw.io.plaintext.read({indir!r}, mode="streaming", persistent_id="w")
    counts = words.groupby(words.data).reduce(word=words.data, cnt=pw.reducers.count())
    pw.io.csv.write(counts, {out!r})
    pw.run(persistence_config=Config(
        Backend.filesystem({store!r}),
        persistence_mode=PersistenceMode.OPERATOR_PERSISTING,
    ))

    pid = os.environ.get("PATHWAY_PROCESS_ID", "0")
    snap = STORE.acquire_latest()
    dump = {{"pid": pid, "tables": {{}}, "published": published}}
    if snap is not None:
        try:
            for pos, entry in snap._entries():
                if entry["node"] != "GroupbyNode":
                    continue
                rows = dump["tables"].setdefault(str(pos), {{}})
                for key, row in entry["table"].items():
                    rows[repr(key)] = list(map(repr, row))
        finally:
            snap.release()
    with open({dump_dir!r} + "/snap-" + pid + ".json", "w") as fh:
        json.dump(dump, fh)
"""


class _Mesh:
    """``python -m pathway_tpu_torch.cli spawn`` in a session of its own, so the
    deadline can kill the CLI, the supervisor and every worker at once."""

    def __init__(self, prog, processes: int, env: dict):
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "pathway_tpu_torch.cli", "spawn", "-n", str(processes),
             "-t", "1", "--first-port", str(_free_port_base(processes)),
             sys.executable, str(prog)],
            env=env, cwd=REPO, start_new_session=True,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        )

    def remaining(self) -> float:
        return MESH_DEADLINE - (time.monotonic() - self.t0)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()

    def wait(self) -> int:
        try:
            return self.proc.wait(timeout=max(0.1, self.remaining()))
        except subprocess.TimeoutExpired:
            self.kill()
            pytest.fail(f"mesh passed its {MESH_DEADLINE:g} s deadline and was killed")


def _mesh_words(n_files: int) -> list[list[str]]:
    return [[f"w{k}_{i}" for i in range(3)] + ["common"] for k in range(n_files)]


def _run_serving_mesh(tmp_path, tag: str, *, processes: int, n_files: int = 5,
                      extra_env: dict | None = None, during=None):
    """Spawn the mesh program with serving on, feed one file a commit, call
    ``during(ports, k)`` once file k reached the sink, and return (sink bytes,
    [each process's snapshot dump])."""
    indir = tmp_path / f"in-{tag}"
    indir.mkdir()
    out = tmp_path / f"out-{tag}.csv"
    stop = tmp_path / f"stop-{tag}"
    dump_dir = tmp_path / f"dumps-{tag}"
    dump_dir.mkdir()
    prog = tmp_path / f"prog-{tag}.py"
    prog.write_text(textwrap.dedent(MESH_PROGRAM.format(
        indir=str(indir), out=str(out), stop=str(stop),
        store=str(tmp_path / f"store-{tag}"), dump_dir=str(dump_dir),
    )))
    serving_base = _free_port_base(processes)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for name in ("PATHWAY_PERSISTENT_STORAGE", "PATHWAY_TPU_FAULT_PLAN", "PATHWAY_TPU_RECOVER",
                 "PATHWAY_TPU_SUPERVISOR_DIR", "PATHWAY_PROCESSES", "PATHWAY_THREADS",
                 "PATHWAY_TPU_DEVICE_OPS", "PATHWAY_TPU_SERVING_FEDERATION"):
        env.pop(name, None)
    env.update({
        "PATHWAY_TPU_MESH_TIMEOUT": "30",
        "PATHWAY_TPU_RECOVER_DEADLINE": "45",
        "PATHWAY_TPU_SERVING": "1",
        "PATHWAY_TPU_SERVING_PORT_BASE": str(serving_base),
        "PATHWAY_TPU_SERVING_STREAM_PORT_BASE": str(_free_port_base(processes)),
    })
    env.update(extra_env or {})
    ports = [serving_base + i for i in range(processes)]
    mesh = _Mesh(prog, processes, env)
    try:
        for k, lines in enumerate(_mesh_words(n_files)):
            (indir / f"f{k}.txt").write_text("\n".join(lines) + "\n")
            while not (out.exists() and f"w{k}_0" in out.read_text()):
                if not mesh.alive():
                    pytest.fail(f"mesh exited (rc={mesh.proc.returncode}) before file {k} "
                                f"committed: {mesh.proc.stderr.read().decode()[-2000:]}")
                if mesh.remaining() <= 0:
                    mesh.kill()
                    pytest.fail(f"file {k} never reached the sink within the deadline")
                time.sleep(0.05)
            if during is not None:
                during(ports, k)
        stop.write_text("")
        rc = mesh.wait()
    finally:
        stop.write_text("")
        if mesh.alive():
            mesh.kill()
    assert rc == 0, f"mesh exited rc={rc}: {mesh.proc.stderr.read().decode()[-3000:]}"
    dumps = [json.loads(p.read_text()) for p in sorted(dump_dir.glob("*.json"))]
    return out.read_bytes(), dumps


def _merged_snapshot_rows(dumps: list) -> set:
    merged: dict = {}
    for dump in dumps:
        for rows in dump["tables"].values():
            merged.update(rows)
    return {(k, tuple(v)) for k, v in merged.items()}


def _jax_snapshot_rows(n_files: int, monkeypatch) -> set:
    """The JAX package's published groupby view of the same words, in one process."""
    import pathway_tpu as jpw
    from pathway_tpu.internals.parse_graph import G as JG
    from pathway_tpu.serving.snapshot import STORE as JSTORE

    _serving_env(monkeypatch)
    JG.clear()
    JSTORE.clear()
    rows = [(w,) for lines in _mesh_words(n_files) for w in lines]
    t = jpw.debug.table_from_rows(jpw.schema_from_types(data=str), rows)
    counts = t.groupby(t.data).reduce(word=t.data, cnt=jpw.reducers.count())
    jpw.io.subscribe(counts, on_change=lambda *a, **k: None)
    try:
        jpw.run(monitoring_level=None)
    finally:
        JG.clear()
    with JSTORE.acquire_latest() as snap:
        (pos,) = [p for p, e in snap._entries() if e["node"] == "GroupbyNode"]
        return {(repr(k), tuple(map(repr, row))) for k, row in snap.table(pos).items()}


def test_mesh_snapshot_parity_across_processes(tmp_path, monkeypatch):
    """3 processes: the union of the per-process published views equals the
    one-process view of the same stream and the JAX package's view of the same words;
    every process published one snapshot a commit, up to the same last commit."""
    _, single = _run_serving_mesh(tmp_path, "single", processes=1)
    _, mesh = _run_serving_mesh(tmp_path, "mesh", processes=3)
    assert len(mesh) == 3, "a mesh process failed to dump its snapshot"
    assert _merged_snapshot_rows(single) == _merged_snapshot_rows(mesh) == \
        _jax_snapshot_rows(5, monkeypatch)
    assert len([d for d in mesh if any(d["tables"].values())]) >= 2
    published = [d["published"] for d in mesh]
    assert all(p and p == sorted(set(p)) for p in published)
    # the followers publish every commit they are told of, the static commit 0 too;
    # the leader publishes each streamed commit (as in the JAX package's runner)
    assert published[1] == published[2] and published[0][-1] == published[1][-1]
    assert set(published[0]) <= set(published[1]) and len(published[0]) >= 5


def test_chaos_worker_kill_query_load_never_5xx(tmp_path):
    """Query load through a worker kill and its recovery: every answer the serving
    plane gives is 200 or 503 (a refused connection while a process is down is not an
    answer), the snapshot's staleness stays bounded, and the rollback truncated each
    process's store: no published commit time repeats out of order after it."""
    plan = json.dumps({"seed": 7, "faults": [{"type": "kill", "process": 1, "at_commit": 3}]})
    statuses: list[int] = []
    staleness: list[float] = []

    def during(ports, k):
        for port in ports:
            try:
                status, body = _get(port, "/serving/health", timeout=5)
                statuses.append(status)
                if body.get("staleness_s") is not None:
                    staleness.append(body["staleness_s"])
                status, _, _ = _post(port, "/serving/lookup", {"key": 0}, timeout=5)
                statuses.append(status)
            except OSError:
                pass  # the process is down or not up yet: not a 5xx

    sink, dumps = _run_serving_mesh(
        tmp_path, "chaos", processes=3, n_files=6,
        extra_env={"PATHWAY_TPU_RECOVER": "1", "PATHWAY_TPU_FAULT_PLAN": plan},
        during=during,
    )
    assert statuses, "no serving answer was observed during the chaos run"
    assert set(statuses) <= {200, 404, 503}, f"unexpected statuses {statuses}"
    assert all(s < 120.0 for s in staleness), f"unbounded staleness: {max(staleness)}"
    assert sorted(sink.splitlines()), "the chaos run produced no sink output"
    assert len(dumps) == 3


def test_mesh_rollback_truncates_store_cache_and_replicas(monkeypatch):
    """``DistributedScheduler.rollback`` under serving truncates the read store, the
    result cache above the rollback time and the replicas' rings (a ``snap-rollback``
    fanned out on the stream), and ``resync`` raises the stream's epoch, as the JAX
    package's scheduler does. Both run on a stand-in for a mesh member with no peers."""
    import types

    calls = {}
    for pkg in PKGS:
        serving = _m(pkg, "serving")
        dist = _m(pkg, "engine.distributed")
        for plane in (_m(pkg, "internals.tracing").TRACER, _m(pkg, "internals.profiling").PROFILER):
            monkeypatch.setattr(plane, "epoch", plane.epoch)  # restored after the case
        _serving_env(monkeypatch)
        monkeypatch.setenv("PATHWAY_TPU_RESULT_CACHE", "1")
        log: list = []

        class _Stream:
            def set_epoch(self, epoch, _log=log):
                _log.append(("epoch", epoch))

            def on_truncate(self, to_time, _log=log):
                _log.append(("snap-rollback", to_time))

        sc, session, _node, sched, ref = _groupby_scope(pkg, [(1, 1)])
        times = []
        for i in range(4):
            session.insert(ref(70 + i), (i, i))
            times.append(sched.commit())
            serving.STORE.publish([sc], times[-1])
        cache = _m(pkg, "serving.result_cache").CACHE
        for t in times:
            cache.put(("q", t), f"v{t}", 10, commit_time=t)
        monkeypatch.setattr(serving, "_stream", _Stream())
        member = types.SimpleNamespace(
            process_id=0, time=times[-1] + 1, scopes=[sc], _outbox={},
            discard_inflight=lambda: None,
        )
        restorer = types.SimpleNamespace(restore=lambda scopes, drivers, at_time: at_time)
        dist.DistributedScheduler.rollback(member, times[1], restorer, [])
        dist.DistributedScheduler.resync(member, 5)
        assert member.time == times[1] + 1
        calls[pkg] = (
            [s.commit_time for s in serving.STORE.snapshots()],
            [cache.get(("q", t)) for t in times],
            log,
        )
        monkeypatch.setattr(serving, "_stream", None)
    ours, theirs = calls.values()
    assert ours == theirs
    (kept,) = ours[0]  # the ring held the last 3 commits; the rollback kept one
    assert ours[1][:2] == ["v%d" % (kept - 1), "v%d" % kept] and ours[1][2:] == [None, None]
    assert ours[2] == [("snap-rollback", kept), ("epoch", 5)]
