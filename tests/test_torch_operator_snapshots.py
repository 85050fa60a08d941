"""Operator persistence (``PersistenceMode.OPERATOR_PERSISTING``) in the port against
the JAX package: state snapshots at commit boundaries, a resume with no event replay,
one overwritten snapshot object, the object-store backend; every stateful node's
``op_state`` equal to the JAX node's on the same graph and commits, and round-tripped
(pickled, restored into a fresh graph, driven on) to the uninterrupted run's state; the
KNN, buffer and BM25 states; and the refusals: another operator signature, another
state format, another optimizer plan, an index without ``op_state``. The cases of
``tests/test_operator_snapshots.py`` :58-300.

Tolerances: states bit for bit (floats through their int64 views), but the KNN
index's norms and scores within 1e-6 (f32 square sums by numpy in one package and by
torch in the other)."""

from __future__ import annotations

import importlib
import json
import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch.engine import device_ops as dops
from pathway_tpu_torch.internals.parse_graph import G as TG

REPO = str(pathlib.Path(__file__).resolve().parent.parent)
PACKAGES = {"torch": tpw, "jax": jpw}


@pytest.fixture(autouse=True)
def _clean():
    """The CPU's device operators, an empty graph in both packages, and both packages'
    UDF cache roots as they were (a persistent run routes them under its store)."""
    from pathway_tpu.internals.udfs import caches as jcaches
    from pathway_tpu_torch.internals.udfs import caches as tcaches

    roots = (jcaches._udf_cache_root, tcaches._udf_cache_root)
    dops.configure(device="cpu")
    TG.clear()
    JG.clear()
    yield
    TG.clear()
    JG.clear()
    dops.configure()
    jcaches.set_udf_cache_root(roots[0])
    tcaches.set_udf_cache_root(roots[1])


def _mod(pw, name: str):
    return importlib.import_module(f"{pw.__name__}.{name}")


def _write(dirpath, name, lines):
    (pathlib.Path(dirpath) / name).write_text("\n".join(lines) + "\n")


def _build(pw, data_dir, backend):
    pers = _mod(pw, "persistence")
    words = pw.io.plaintext.read(data_dir, mode="streaming", persistent_id="w")
    counts = words.groupby(words.data).reduce(word=words.data, cnt=pw.reducers.count())
    runner = _mod(pw, "internals.runner").GraphRunner(
        persistence_config=pers.Config(
            backend, persistence_mode=pers.PersistenceMode.OPERATOR_PERSISTING
        )
    )
    return runner, runner.build(counts)


def _drive(pw, runner, iterations):
    """``GraphRunner.run``'s snapshot wiring for a bounded number of poll and commit
    rounds: restore first, a snapshot every commit, no clean end."""
    sched = _mod(pw, "engine.graph").Scheduler(runner.scope)
    mgr = runner._operator_snapshot_manager()
    restored = mgr.restore(runner.scope, runner.drivers)
    if restored is not None:
        sched.time = restored + 1
    for _ in range(iterations):
        produced = False
        for d in runner.drivers:
            if d.poll() == "data":
                produced = True
        if produced:
            t = sched.commit()
            mgr.on_commit(runner.scope, runner.drivers, t)
        else:
            time.sleep(0.01)
    return sched


def _counts(node) -> dict:
    return {row[0]: row[1] for row in node.current.values()}


class DictObjectStore:
    """An in-memory S3-shaped client: ``get_object``, ``put_object``,
    ``list_objects(prefix) -> [(key, signature)]``."""

    def __init__(self) -> None:
        self.objects: dict[str, bytes] = {}

    def get_object(self, key: str) -> bytes:
        return self.objects[key]

    def put_object(self, key: str, payload: bytes) -> None:
        self.objects[key] = payload

    def list_objects(self, prefix: str):
        return [(k, len(v)) for k, v in sorted(self.objects.items()) if k.startswith(prefix)]


# -- resume ------------------------------------------------------------------------


def test_crash_resume_no_double_counting(tmp_path):
    states = []
    for name, pw in PACKAGES.items():
        data = tmp_path / name / "data"
        data.mkdir(parents=True)
        _write(data, "a.txt", ["apple", "banana", "apple"])
        backend = _mod(pw, "persistence").Backend.filesystem(str(tmp_path / name / "store"))
        runner1, node1 = _build(pw, data, backend)
        _drive(pw, runner1, 3)
        assert _counts(node1) == {"apple": 2, "banana": 1}
        del runner1  # crash
        _write(data, "b.txt", ["banana", "cherry"])
        runner2, node2 = _build(pw, data, backend)
        _drive(pw, runner2, 3)
        assert _counts(node2) == {"apple": 2, "banana": 2, "cherry": 1}
        states.append({int(k): r for k, r in node2.current.items()})
    assert states[0] == states[1]


def test_resume_does_not_replay_history(tmp_path):
    """Restored state is not emitted downstream again: only b.txt's words flow."""
    seen_by = {}
    for name, pw in PACKAGES.items():
        data = tmp_path / name / "data"
        data.mkdir(parents=True)
        _write(data, "a.txt", ["apple", "banana", "apple"])
        backend = _mod(pw, "persistence").Backend.filesystem(str(tmp_path / name / "store"))

        def build_with_subscriber(sink):
            runner, node = _build(pw, data, backend)
            runner.scope.subscribe_table(
                node, on_change=lambda key, values, time, diff: sink.append((values[0], diff))
            )
            return runner

        _drive(pw, build_with_subscriber([]), 3)
        _write(data, "b.txt", ["banana", "cherry"])
        seen = []
        _drive(pw, build_with_subscriber(seen), 3)
        assert "apple" not in {w for w, _d in seen}
        assert ("cherry", 1) in seen and ("banana", 1) in seen
        seen_by[name] = sorted(seen)
    assert seen_by["torch"] == seen_by["jax"]


def test_snapshot_is_one_object_that_does_not_grow_with_commits(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    store = tmp_path / "store"
    runner, _node = _build(tpw, data, tpw.persistence.Backend.filesystem(str(store)))
    sched = _mod(tpw, "engine.graph").Scheduler(runner.scope)
    mgr = runner._operator_snapshot_manager()

    def drive_once():
        deadline = time.time() + 2.0
        while time.time() < deadline:
            if any(d.poll() == "data" for d in runner.drivers):
                mgr.on_commit(runner.scope, runner.drivers, sched.commit())
                return
            time.sleep(0.01)

    sizes = []
    for i in range(4):
        _write(data, f"f{i}.txt", [f"word{i}"])
        drive_once()
        sizes.append((store / "operator-snapshot").stat().st_size)
    assert os.listdir(store) == ["operator-snapshot"]  # one overwritten object, no journal
    for _ in range(3):  # rewriting the same content must not grow it
        later = time.time() + 5
        os.utime(data / "f0.txt", (later, later))
        drive_once()
    assert (store / "operator-snapshot").stat().st_size <= max(sizes) * 1.5
    assert len(mgr.write_seconds) == 7 and mgr.write_bytes[-1] > 0


def test_object_store_backend_drop_in(tmp_path):
    states = []
    for name, pw in PACKAGES.items():
        backend = _mod(pw, "persistence").Backend.s3(client=DictObjectStore())
        data = tmp_path / name / "data"
        data.mkdir(parents=True)
        _write(data, "a.txt", ["x", "y", "x"])
        runner1, _node1 = _build(pw, data, backend)
        _drive(pw, runner1, 3)
        del runner1
        _write(data, "b.txt", ["y"])
        runner2, node2 = _build(pw, data, backend)
        _drive(pw, runner2, 3)
        assert _counts(node2) == {"x": 2, "y": 2}
        states.append({int(k): r for k, r in node2.current.items()})
    assert states[0] == states[1]


_WORKER = r"""
import importlib, sys
sys.path.insert(0, {repo!r})
pkg, data_dir, store, out = sys.argv[1:5]
pw = importlib.import_module(pkg)
pers = importlib.import_module(pkg + ".persistence")
words = pw.io.plaintext.read(data_dir, mode="static", persistent_id="w")
counts = words.groupby(words.data).reduce(word=words.data, cnt=pw.reducers.count())
pw.io.jsonlines.write(counts, out)
pw.run(persistence_config=pers.Config(
    pers.Backend.filesystem(store),
    persistence_mode=pers.PersistenceMode.OPERATOR_PERSISTING,
))
"""


def test_bounded_resume_across_processes(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=REPO))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PATHWAY_TPU_DEVICE_OPS="0")
    outs = {}
    for name, pkg in (("torch", "pathway_tpu_torch"), ("jax", "pathway_tpu")):
        data = tmp_path / name / "data"
        data.mkdir(parents=True)
        _write(data, "a.txt", ["apple", "banana", "apple"])
        store = tmp_path / name / "store"
        args = [sys.executable, str(script), pkg, str(data), str(store)]
        assert subprocess.run(args + [str(tmp_path / name / "o1.jsonl")], env=env, timeout=120).returncode == 0
        _write(data, "b.txt", ["banana", "cherry"])
        out2 = tmp_path / name / "o2.jsonl"
        assert subprocess.run(args + [str(out2)], env=env, timeout=120).returncode == 0
        rows = [json.loads(ln) for ln in out2.read_text().splitlines() if ln.strip()]
        # only the delta: apple's state was restored, not replayed
        assert {r["word"]: r["cnt"] for r in rows if r["diff"] > 0} == {"banana": 2, "cherry": 1}
        assert all(r["word"] != "apple" for r in rows)
        outs[name] = sorted((r["word"], r["cnt"], r["diff"]) for r in rows)
    assert outs["torch"] == outs["jax"]


# -- every stateful node's op_state against the JAX node's ---------------------------


class _Engine:
    def __init__(self, pw) -> None:
        self.g = _mod(pw, "engine.graph")
        self.ex = _mod(pw, "engine.expression")
        self.red = _mod(pw, "engine.reducers")
        self.tmp = _mod(pw, "engine.temporal")
        self.it = _mod(pw, "engine.iterate")
        self.ext = _mod(pw, "engine.external_index")
        self.ref = _mod(pw, "engine.value").ref_scalar
        self.is_port = pw is tpw

    def reducer(self, kind: str):
        return self.red.make_reducer(self.red.ReducerKind[kind])

    def knn(self):
        if self.is_port:
            return self.ext.DeviceKnnIndex(dim=4, capacity=8, device="cpu")
        return self.ext.DeviceKnnIndex(dim=4, capacity=8)


SESSIONS = {"A": 2, "B": 2, "C": 1, "U": 2, "T": 2, "T2": 2, "TH": 3, "D": 1, "Q": 1}


def _graph(E: _Engine):
    """One engine graph holding every stateful node type of the port: -> (scope,
    sessions, {name: node})."""
    g, ex, tmp = E.g, E.ex, E.tmp
    scope = g.Scope()
    s = {name: scope.input_session(arity) for name, arity in SESSIONS.items()}
    nodes = {
        "StaticSource": scope.static_table([(E.ref(100 + i), (i, f"s{i}")) for i in range(3)], 2),
        "GroupbyNode": scope.group_by_table(
            s["A"], [0], [(E.reducer("COUNT"), []), (E.reducer("SUM"), [1])]
        ),
        "GroupbyNode/rows": scope.group_by_table(s["A"], [0], [(E.reducer("MAX"), [1])]),
        "JoinNode": scope.join_tables(s["A"], s["B"], [0], [0]),
        "JoinNode/left": scope.join_tables(s["A"], s["B"], [0], [0], kind="left"),
        "DeduplicateNode": scope.deduplicate(s["A"], 1, [0], lambda new, old: new > old),
        "SortNode": scope.sort_table(s["A"], 1, None),
        "IxNode": scope.ix_table(s["C"], s["A"], 0, optional=True),
        "UpdateRowsNode": scope.update_rows_table(s["A"], s["U"]),
        "UpdateCellsNode": scope.update_cells_table(s["A"], s["U"], [1]),
        "ZipNode": scope.zip_tables([s["A"], scope.expression_table(s["A"], [ex.ColumnRef(1)])]),
        "BufferNode": tmp.BufferNode(scope, s["T"], 0, 1, True),
        "ForgetNode": tmp.ForgetNode(scope, s["T"], 0, 1, False),
        "FreezeNode": tmp.FreezeNode(scope, s["T"], 0, 1),
        "SessionAssignNode": tmp.SessionAssignNode(scope, s["T"], 1, None, 2),
        "IntervalJoinNode": tmp.IntervalJoinNode(scope, s["T"], s["T2"], 1, 1, -2, 2, None, None, "inner"),
        "AsofJoinNode": tmp.AsofJoinNode(scope, s["T"], s["T2"], 1, 1, None, None, "backward", "inner"),
        "AsofNowJoinNode": tmp.AsofNowJoinNode(scope, s["T"], s["T2"], [0], [0], "inner"),
        "GradualBroadcastNode": tmp.GradualBroadcastNode(scope, s["T"], s["TH"]),
        "IterateNode": E.it.IterateNode(
            scope, [s["A"]], 2,
            lambda states: {k: (r[0], r[1] % 3) for k, r in states[0].items()},
        ),
        "ExternalIndexNode": E.ext.ExternalIndexNode(scope, s["D"], s["Q"], E.knn(), 0, 0, 2),
    }
    for node in nodes.values():
        node._pw_observed = True
    return scope, s, nodes


def _feed(E: _Engine, s: dict, commit: int) -> None:
    r = E.ref
    eye = np.eye(4, dtype=np.float32)
    if commit == 0:
        for i in range(6):
            s["A"].insert(r(i), (i % 3, 10 * i))
            s["B"].insert(r(50 + i), (i % 4, f"b{i}"))
            s["T"].insert(r(200 + i), (2 * i, i))
            s["T2"].insert(r(300 + i), (i % 2, i + 1))
        s["C"].insert(r(400), (r(1),))
        s["C"].insert(r(401), (r(99),))  # points at nothing (optional ix)
        s["U"].insert(r(2), (7, 77))
        s["TH"].insert(r(500), (1, 2, 3))
        for i in range(3):
            s["D"].insert(r(600 + i), (eye[i],))
    elif commit == 1:
        s["A"].remove(r(1), (1, 10))
        s["A"].insert(r(6), (0, 60))
        s["B"].remove(r(51), (1, "b1"))
        s["T"].insert(r(206), (3, 9))
        s["Q"].insert(r(700), (eye[1],))
        s["D"].insert(r(603), (eye[3],))
    else:
        s["A"].insert(r(7), (1, 5))
        s["U"].remove(r(2), (7, 77))
        s["C"].insert(r(402), (r(7),))
        s["T2"].insert(r(306), (0, 8))
        s["TH"].remove(r(500), (1, 2, 3))
        s["D"].remove(r(600), (eye[0],))
        s["Q"].insert(r(701), (eye[3],))


def _canon(v, tol_floats: bool = False):
    if v is None or isinstance(v, (bool, str, bytes)):
        return v
    if isinstance(v, float):
        return round(v, 6) if tol_floats else ("f", np.float64(v).view(np.int64).item())
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, np.floating):
        return _canon(float(v), tol_floats)
    if isinstance(v, np.ndarray):
        if tol_floats and v.dtype.kind == "f":
            return ("nd", str(v.dtype), tuple(np.round(v.astype(np.float64), 6).ravel().tolist()))
        return ("nd", str(v.dtype), v.shape, _canon(v.tolist(), tol_floats))
    if isinstance(v, dict):
        return ("d", tuple(sorted(((_canon(k), _canon(x, tol_floats)) for k, x in v.items()), key=repr)))
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x, tol_floats) for x in v)
    if isinstance(v, (set, frozenset)):
        return ("s", tuple(sorted((_canon(x, tol_floats) for x in v), key=repr)))
    if type(v).__name__ == "Json":
        return ("json", json.dumps(v.value, sort_keys=True))
    slots = getattr(type(v), "__slots__", None)
    if slots:
        return (type(v).__name__, tuple(_canon(getattr(v, a, None), tol_floats) for a in slots))
    return (type(v).__name__, _canon(vars(v), tol_floats))


def _state(name: str, node) -> object:
    state = dict(node.op_state())
    for mirrors in ("_mirrors", "_input_states"):
        # the nodes' own copies of their inputs, kept for sharded scopes: empty on one
        # worker in both packages (the port's key filter keeps them too)
        assert not any(state.pop(mirrors, [])), mirrors
    return _canon(state, tol_floats=name == "ExternalIndexNode")


def _run(pw, commits, restore_after: int | None = None):
    """The graph through ``commits`` commits -> {node name: canonical op_state}; with
    ``restore_after``, the port's states after that commit are pickled and restored
    into a fresh graph, which takes the rest of the commits."""
    E = _Engine(pw)
    scope, s, nodes = _graph(E)
    sched = E.g.Scheduler(scope, optimize=False)
    for c in range(commits):
        _feed(E, s, c)
        sched.commit()
        if restore_after == c:
            blob = pickle.dumps([n.op_state() for n in scope.nodes], protocol=4)
            scope, s, nodes = _graph(E)
            for node, state in zip(scope.nodes, pickle.loads(blob)):
                node.restore_op_state(state)
            sched_time = sched.time
            sched = E.g.Scheduler(scope, optimize=False)
            sched.time = sched_time
    return {name: _state(name, node) for name, node in nodes.items()}, nodes


STATEFUL = sorted(_graph(_Engine(tpw))[2])


@pytest.fixture(scope="module")
def states():
    dops.configure(device="cpu")
    try:
        out = {
            "jax": _run(jpw, 3)[0],
            "torch": _run(tpw, 3)[0],
            "jax_mid": _run(jpw, 2)[0],
            "torch_mid": _run(tpw, 2)[0],
        }
        restored, nodes = _run(tpw, 3, restore_after=1)
        out["restored"] = restored
        out["restored_nodes"] = nodes
        return out
    finally:
        dops.configure()
        TG.clear()


@pytest.mark.parametrize("name", STATEFUL)
def test_op_state_equals_the_reference_and_round_trips(states, name):
    assert states["torch_mid"][name] == states["jax_mid"][name]
    assert states["torch"][name] == states["jax"][name]
    assert states["restored"][name] == states["torch"][name]


def test_restored_groupby_keeps_the_array_state(states):
    """A count and sum groupby restores into the columnar state, whose batches the
    device or host-kernel route takes; a max groupby keeps its dict of states."""
    nodes = states["restored_nodes"]
    assert nodes["GroupbyNode"]._cg is not None
    assert nodes["GroupbyNode/rows"]._cg is None
    assert nodes["JoinNode"]._columnar_ok is False  # a restored join runs on dicts


def test_one_snapshot_and_journal_format_with_or_without_the_host_kernels(monkeypatch):
    """Snapshots and journal segments pack their Pointer keys the same way whether the
    host kernels run or ``PATHWAY_TPU_DISABLE_NATIVE=1`` takes the Python branches, and
    either reads back under the other."""
    from pathway_tpu_torch.engine import persistence as tpers

    E = _Engine(tpw)
    scope, s, _nodes = _graph(E)
    sched = E.g.Scheduler(scope, optimize=False)
    _feed(E, s, 0)
    sched.commit()
    events = [(0, E.ref(i), (i, f"r{i}"), "src") for i in range(5)]
    blobs = {}
    for disable in ("0", "1"):
        monkeypatch.setenv("PATHWAY_TPU_DISABLE_NATIVE", disable)
        backend = tpers.MemoryBackend()
        tpers.OperatorSnapshotManager(backend).snapshot(scope, [], sched.time)
        blobs[disable] = (
            backend.read("operator-snapshot"),
            pickle.dumps(tpers._pack_events(events), protocol=4),
        )
    assert blobs["0"] == blobs["1"]
    for disable in ("0", "1"):
        monkeypatch.setenv("PATHWAY_TPU_DISABLE_NATIVE", disable)
        snap, journal = blobs["1" if disable == "0" else "0"]
        assert pickle.loads(journal) == events
        backend = tpers.MemoryBackend()
        backend.write("operator-snapshot", snap)
        scope2, _s2, nodes2 = _graph(E)
        assert tpers.OperatorSnapshotManager(backend).restore(scope2, []) == sched.time
        assert {n: _state(n, node) for n, node in nodes2.items()} == {
            n: _state(n, node) for n, node in _nodes.items()
        }


@pytest.mark.parametrize("before", ["nothing_delivered", "all_retracted"])
def test_restored_empty_groupby_keeps_int_sums(before):
    """A count and sum groupby over an int column snapshotted with no groups (its source
    has not delivered yet, or every row was retracted) emits ints after the restore, as
    the JAX node and the fault-free run do."""
    outs = {}
    for pw in (tpw, jpw):
        E = _Engine(pw)

        def build():
            scope = E.g.Scope()
            sess = scope.input_session(2)
            node = scope.group_by_table(
                sess, [0], [(E.reducer("COUNT"), []), (E.reducer("SUM"), [1])]
            )
            node._pw_observed = True
            return scope, sess, node

        scope, sess, _node = build()
        sched = E.g.Scheduler(scope, optimize=False)
        if before == "all_retracted":
            sess.insert(E.ref(1), (0, 3))
            sched.commit()
            sess.remove(E.ref(1), (0, 3))
        sched.commit()
        blob = pickle.dumps([n.op_state() for n in scope.nodes], protocol=4)
        scope, sess, node = build()
        for n, state in zip(scope.nodes, pickle.loads(blob)):
            n.restore_op_state(state)
        sched2 = E.g.Scheduler(scope, optimize=False)
        sched2.time = sched.time
        sess.insert(E.ref(2), (0, 5))
        sess.insert(E.ref(3), (1, 7))
        sched2.commit()
        outs[pw.__name__] = {
            int(k): tuple((type(v).__name__, v) for v in row) for k, row in node.current.items()
        }
    assert outs["pathway_tpu_torch"] == outs["pathway_tpu"]
    assert sorted(outs["pathway_tpu_torch"].values()) == [
        (("int", 0), ("int", 1), ("int", 5)),
        (("int", 1), ("int", 1), ("int", 7)),
    ]


# -- state round trips (tests/test_operator_snapshots.py::TestStateRoundTrips) -------


def test_knn_index_state():
    eye = np.eye(4, dtype=np.float32)
    keys = [tpw.ref_scalar(i) for i in range(3)]
    states = []
    for E in (_Engine(tpw), _Engine(jpw)):
        idx = E.knn()
        idx.add(keys, [eye[i] for i in range(3)])
        state = idx.op_state()
        states.append(state)
        idx2 = E.knn()
        idx2.restore_op_state(state)
        res = idx2.search([eye[1]], k=1)
        assert res[0][0][0] == keys[1]
    ours, theirs = states
    assert np.array_equal(ours["vectors"], np.asarray(theirs["vectors"]))
    assert np.array_equal(ours["valid"], np.asarray(theirs["valid"]))
    assert np.allclose(ours["norms"], np.asarray(theirs["norms"]), atol=1e-6)
    assert {int(k): s for k, s in ours["key_to_slot"].items()} == \
        {int(k): s for k, s in theirs["key_to_slot"].items()}
    assert ours["free"] == theirs["free"] and ours["capacity"] == theirs["capacity"]


def test_host_knn_index_state_does_not_alias():
    from pathway_tpu_torch.engine.external_index import DeviceKnnIndex, HostKnnIndex

    eye = np.eye(4, dtype=np.float32)
    for idx in (HostKnnIndex(dim=4, capacity=8), DeviceKnnIndex(dim=4, capacity=8, device="cpu")):
        idx.add([tpw.ref_scalar(0)], [eye[0]])
        state = idx.op_state()
        twin = type(idx)(dim=4, capacity=8, **({} if isinstance(idx, HostKnnIndex) else {"device": "cpu"}))
        twin.restore_op_state(state)
        twin.add([tpw.ref_scalar(1)], [eye[1]])  # writes in place: not into ``state``
        assert not state["valid"][1] and twin.search([eye[1]], k=1)[0][0][0] == tpw.ref_scalar(1)


def test_buffer_node_state():
    from pathway_tpu_torch.engine.graph import Scheduler, Scope
    from pathway_tpu_torch.engine.temporal import BufferNode

    def build():
        scope = Scope()
        sess = scope.input_session(2)
        return scope, sess, BufferNode(scope, sess, threshold_col=0, time_col=1)

    scope1, sess1, buf1 = build()
    sess1.insert(tpw.ref_scalar(1), (10, 0))  # held: threshold 10 > watermark 0
    Scheduler(scope1).commit()
    assert buf1.held
    states = pickle.loads(pickle.dumps([n.op_state() for n in scope1.nodes]))
    scope2, sess2, buf2 = build()
    for node, st in zip(scope2.nodes, states):
        node.restore_op_state(st)
    assert buf2.held and buf2.watermark == 0
    sess2.insert(tpw.ref_scalar(2), (0, 11))  # the watermark passes 10
    Scheduler(scope2).commit()
    assert tpw.ref_scalar(1) in buf2.current  # the held row is released after the restore


def test_bm25_state():
    from pathway_tpu_torch.stdlib.indexing.bm25 import BM25Index

    idx = BM25Index()
    idx.add([tpw.ref_scalar(1), tpw.ref_scalar(2)], ["alpha beta", "beta gamma"])
    idx2 = BM25Index()
    idx2.restore_op_state(pickle.loads(pickle.dumps(idx.op_state())))
    (hits,) = idx2.search(["alpha"], k=2)
    assert hits[0][0] == tpw.ref_scalar(1)


def test_external_index_node_refuses_an_index_without_state():
    from pathway_tpu_torch.engine.external_index import ExternalIndexNode
    from pathway_tpu_torch.engine.graph import Scope

    class Stateless:
        def add(self, keys, vectors):
            pass

    scope = Scope()
    node = ExternalIndexNode(scope, scope.input_session(1), scope.input_session(1), Stateless(), 0, 0, 1)
    with pytest.raises(TypeError, match="OPERATOR_PERSISTING"):
        node.op_state()


# -- refusals -------------------------------------------------------------------------


def test_graph_signature_mismatch_raises(tmp_path):
    from pathway_tpu_torch.engine.graph import Scope
    from pathway_tpu_torch.engine.persistence import OperatorSnapshotManager

    mgr = OperatorSnapshotManager(tpw.persistence.Backend.filesystem(str(tmp_path / "s")))
    scope1 = Scope()
    scope1.input_session(1)
    mgr.snapshot(scope1, [], 1)
    scope2 = Scope()
    scope2.input_session(1)
    scope2.static_table([], 1)  # another operator sequence
    with pytest.raises(ValueError, match="operator snapshot"):
        mgr.restore(scope2, [])


def test_stale_state_format_checkpoint_rejected(tmp_path):
    from pathway_tpu_torch.engine.graph import Scope
    from pathway_tpu_torch.engine.persistence import STATE_FORMAT, OperatorSnapshotManager

    backend = tpw.persistence.Backend.filesystem(str(tmp_path / "s"))
    mgr = OperatorSnapshotManager(backend)
    scope1 = Scope()
    scope1.input_session(1)
    mgr.snapshot(scope1, [], 1)
    payload = pickle.loads(backend.read(mgr.name))
    assert payload["format"] == STATE_FORMAT == 2
    del payload["format"]  # format 1 carried no "format" key
    backend.write(mgr.name, pickle.dumps(payload, protocol=4))
    scope2 = Scope()
    scope2.input_session(1)
    with pytest.raises(ValueError, match="state format 1"):
        mgr.restore(scope2, [])
    payload["format"] = STATE_FORMAT  # the guard does not refuse everything
    backend.write(mgr.name, pickle.dumps(payload, protocol=4))
    scope3 = Scope()
    scope3.input_session(1)
    assert mgr.restore(scope3, []) == 1


def test_truncated_snapshot_is_a_cold_start(tmp_path):
    from pathway_tpu_torch.engine.graph import Scope
    from pathway_tpu_torch.engine.persistence import OperatorSnapshotManager

    backend = tpw.persistence.Backend.filesystem(str(tmp_path / "s"))
    mgr = OperatorSnapshotManager(backend)
    scope1 = Scope()
    scope1.input_session(1)
    mgr.snapshot(scope1, [], 4)
    backend.write(mgr.name, backend.read(mgr.name)[:-7])
    scope2 = Scope()
    scope2.input_session(1)
    assert mgr.restore(scope2, []) is None and mgr.latest_time() is None


def test_snapshot_ring_raises_naming_the_multi_process_runner():
    """The ring of snapshots by commit time, which the multi-process rollback reads:
    with ``retain=3`` the last three commits restore by time and an older one raises;
    without a ring only the latest commit restores by time, and one worker's snapshot
    is unaffected."""
    from pathway_tpu_torch.engine.graph import Scope
    from pathway_tpu_torch.engine.persistence import MemoryBackend, OperatorSnapshotManager

    ring = OperatorSnapshotManager(MemoryBackend(), retain=3)
    scope = Scope()
    session = scope.input_session(1)
    for t in range(1, 5):
        session.current[tpw.ref_scalar(t)] = (t,)
        ring.snapshot(scope, [], t)
    for t in (2, 3, 4):
        restored = Scope()
        node = restored.input_session(1)
        assert ring.restore(restored, [], at_time=t) == t
        assert sorted(v for (v,) in node.current.values()) == list(range(1, t + 1))
    with pytest.raises(ValueError, match="no operator snapshot at commit time 1"):
        ring.restore(scope, [], at_time=1)
    mgr = OperatorSnapshotManager(MemoryBackend())
    mgr.snapshot(scope, [], 2)
    with pytest.raises(ValueError, match="no operator snapshot at commit time 1"):
        mgr.restore(scope, [], at_time=1)
    assert mgr.restore(scope, [], at_time=2) == 2
    assert mgr.latest_time() == 2 and mgr.restore(scope, []) == 2


def test_another_optimizer_plan_is_refused(tmp_path, monkeypatch):
    """A snapshot written with the graph optimizer on carries its fingerprint; a run
    of the same program with the optimizer off (or another plan) refuses it, in both
    packages."""
    for name, pw in PACKAGES.items():
        data = tmp_path / name / "data"
        data.mkdir(parents=True)
        _write(data, "a.txt", ["x", "y"])
        store = str(tmp_path / name / "store")
        pers = _mod(pw, "persistence")

        def program():
            t = pw.io.plaintext.read(data, mode="static", persistent_id="w")
            shout = t.select(v=t.data + "!").select(w=pw.this.v + "?")  # a fusable chain
            pw.io.null.write(shout)

        monkeypatch.delenv("PATHWAY_TPU_OPTIMIZE", raising=False)
        program()
        pw.run(persistence_config=pers.Config(
            pers.Backend.filesystem(store),
            persistence_mode=pers.PersistenceMode.OPERATOR_PERSISTING))
        payload = pickle.loads(pathlib.Path(store, "operator-snapshot").read_bytes())
        assert payload["optimize"], "the optimizer's fingerprint is in the snapshot"
        monkeypatch.setenv("PATHWAY_TPU_OPTIMIZE", "0")
        program()
        with pytest.raises(ValueError, match="operator snapshot"):
            pw.run(persistence_config=pers.Config(
                pers.Backend.filesystem(store),
                persistence_mode=pers.PersistenceMode.OPERATOR_PERSISTING))
        (_mod(pw, "internals.parse_graph").G).clear()
        payload["optimize"] = payload["optimize"][:-1]  # the same classes, another plan
        pathlib.Path(store, "operator-snapshot").write_bytes(pickle.dumps(payload, protocol=4))
        monkeypatch.delenv("PATHWAY_TPU_OPTIMIZE")
        program()
        with pytest.raises(ValueError, match="graph-optimizer plan"):
            pw.run(persistence_config=pers.Config(
                pers.Backend.filesystem(store),
                persistence_mode=pers.PersistenceMode.OPERATOR_PERSISTING))
        (_mod(pw, "internals.parse_graph").G).clear()
