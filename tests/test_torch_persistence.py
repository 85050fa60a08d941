"""Input-journal persistence (``PersistenceMode.PERSISTING``) in the port against the
JAX package: the same files and the same crashes give the same states in both, with
no count doubled or lost; a changed file while down retracts its old rows; a torn
journal tail is ignored; a static read resumes past its consumed files; a process
SIGKILLed after its k-th commit reached the sink resumes to the fault-free answer (both
modes, both packages). Then the port's own seams: ``PATHWAY_PERSISTENT_STORAGE`` /
``PATHWAY_PERSISTENCE_MODE``, ``UDF_CACHING``, the backends, the refusals naming
ROADMAP items, and the ``drain_until`` barrier in front of every checkpoint (a gated
stand-in holds a commit's device copy open). The cases of ``tests/test_persistence.py``."""

from __future__ import annotations

import collections
import importlib
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch.engine import device as tdev
from pathway_tpu_torch.engine import device_ops as dops
from pathway_tpu_torch.engine import device_pipeline as dp
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


def _build(pw, data_dir, store, mode="streaming"):
    pers = _mod(pw, "persistence")
    words = pw.io.plaintext.read(data_dir, mode=mode, persistent_id="words")
    counts = words.groupby(words.data).reduce(word=words.data, cnt=pw.reducers.count())
    runner = _mod(pw, "internals.runner").GraphRunner(
        persistence_config=pers.Config(pers.Backend.filesystem(str(store)))
    )
    return runner, runner.build(counts)


def _drive(pw, runner, iterations):
    """``GraphRunner.run``'s journal wiring for a bounded number of poll and commit
    rounds (no clean end: dropping the runner after it is a crash)."""
    sched = _mod(pw, "engine.graph").Scheduler(runner.scope)
    persistent = [d for d in runner.drivers if hasattr(d, "replay")]
    for d in persistent:
        d.replay()
    if persistent:
        sched.commit()
    for _ in range(iterations):
        produced = False
        for d in runner.drivers:
            if d.poll() == "data":
                produced = True
        if produced:
            t = sched.commit()
            for d in persistent:
                d.on_commit(t)
        else:
            time.sleep(0.01)
    return sched


def _counts(node) -> dict:
    return {row[0]: row[1] for row in node.current.values()}


def _keyed(node) -> dict:
    return {int(k): tuple(r) for k, r in node.current.items()}


# -- tests/test_persistence.py --------------------------------------------------


def test_resume_no_double_counting(tmp_path):
    states = []
    for name, pw in PACKAGES.items():
        data, store = tmp_path / name / "data", tmp_path / name / "store"
        data.mkdir(parents=True)
        _write(data, "a.txt", ["apple", "banana", "apple"])
        runner1, node1 = _build(pw, data, store)
        _drive(pw, runner1, 3)
        assert _counts(node1) == {"apple": 2, "banana": 1}
        del runner1  # crash: nothing past the journaled commits
        _write(data, "b.txt", ["banana", "cherry"])
        runner2, node2 = _build(pw, data, store)
        _drive(pw, runner2, 3)
        assert _counts(node2) == {"apple": 2, "banana": 2, "cherry": 1}
        states.append(_keyed(node2))
    assert states[0] == states[1]


def test_resume_handles_file_update(tmp_path):
    states = []
    for name, pw in PACKAGES.items():
        data, store = tmp_path / name / "data", tmp_path / name / "store"
        data.mkdir(parents=True)
        _write(data, "a.txt", ["x", "y"])
        runner1, _node1 = _build(pw, data, store)
        _drive(pw, runner1, 3)
        del runner1
        # replaced while down: its old rows are retracted on resume
        _write(data, "a.txt", ["x"])
        later = time.time() + 5
        os.utime(data / "a.txt", (later, later))
        runner2, node2 = _build(pw, data, store)
        _drive(pw, runner2, 3)
        assert _counts(node2) == {"x": 1}
        states.append(_keyed(node2))
    assert states[0] == states[1]


def test_journal_tail_corruption_ignored(tmp_path):
    states = []
    for name, pw in PACKAGES.items():
        data, store = tmp_path / name / "data", tmp_path / name / "store"
        data.mkdir(parents=True)
        _write(data, "a.txt", ["p", "q"])
        runner1, _node1 = _build(pw, data, store)
        _drive(pw, runner1, 3)
        del runner1
        # a crash in the middle of an append: garbage at the journal's tail
        (journal,) = [p for p in store.iterdir() if "journal" in p.name]
        with open(journal, "ab") as f:
            f.write(b"\x80\x04GARBAGE-TRUNCATED")
        runner2, node2 = _build(pw, data, store)
        _drive(pw, runner2, 2)
        assert _counts(node2) == {"p": 1, "q": 1}
        states.append(_keyed(node2))
    assert states[0] == states[1]


def test_new_file_while_down_static_mode(tmp_path):
    outs = []
    for name, pw in PACKAGES.items():
        data, store = tmp_path / name / "data", tmp_path / name / "store"
        data.mkdir(parents=True)
        _write(data, "a.txt", ["alpha", "beta", "alpha"])
        runner1, node1 = _build(pw, data, store, mode="static")
        runner1.run()
        assert _counts(node1) == {"alpha": 2, "beta": 1}
        _write(data, "b.txt", ["beta", "gamma"])
        runner2, node2 = _build(pw, data, store, mode="static")
        runner2.run()
        assert _counts(node2) == {"alpha": 2, "beta": 2, "gamma": 1}
        outs.append((_keyed(node1), _keyed(node2)))
    assert outs[0] == outs[1]


#: the killed-and-resumed program, for either package: a streamed plaintext read of
#: ``n`` files that it writes itself, one a commit (file k once commit k-1 reached the
#: sink), then a stop file that ends the read; a word count into a JSON-lines sink under
#: ``PATHWAY_RUN_ID``; with ``kill`` > 0 it SIGKILLs itself when its kill-th commit
#: with rows reaches the sink
_WORKER = r"""
import importlib, os, signal, sys, threading, time
sys.path.insert(0, {repo!r})
pkg, data, store, out, mode, kill, n = sys.argv[1:8]
kill, n = int(kill), int(n)
pw = importlib.import_module(pkg)
conn = importlib.import_module(pkg + ".engine.connectors")
pers = importlib.import_module(pkg + ".persistence")
stop = os.path.join(store, "..", "stop-" + os.path.basename(store))
_poll = conn.FsReader.poll
def poll(self):
    entries, done = _poll(self)
    return entries, done or (not entries and os.path.exists(stop))
conn.FsReader.poll = poll

words = pw.io.plaintext.read(data, mode="streaming", persistent_id="w", autocommit_duration_ms=10)
counts = words.groupby(words.data).reduce(word=words.data, cnt=pw.reducers.count())
pw.io.jsonlines.write(counts, out)
commits = [0]
rows_in_commit = [0]
cv = threading.Condition()
def on_change(key, row, time, is_addition):
    rows_in_commit[0] += 1
def on_time_end(t):
    if rows_in_commit[0]:
        rows_in_commit[0] = 0
        with cv:
            commits[0] += 1
            cv.notify_all()
        if commits[0] == kill:
            os.kill(os.getpid(), signal.SIGKILL)
pw.io.subscribe(words, on_change=on_change, on_time_end=on_time_end)
def pacer():
    for k in range(n):
        path = os.path.join(data, "f%03d.txt" % k)
        if os.path.exists(path):
            continue
        with cv:
            seen = commits[0]
        with open(os.path.join(data, "..", "part"), "w") as f:
            f.write("\n".join(["common", "w%d_a" % k, "w%d_b" % k, "w%d_a" % k]) + "\n")
        os.replace(os.path.join(data, "..", "part"), path)
        with cv:
            cv.wait_for(lambda: commits[0] > seen, timeout=60)
    open(stop, "w").close()
threading.Thread(target=pacer, daemon=True).start()
pw.run(persistence_config=pers.Config(
    pers.Backend.filesystem(store), persistence_mode=pers.PersistenceMode[mode]
))
"""


def _fold(text: str) -> dict:
    """The state an update log leaves: a row in on +1, out on -1 of the same row."""
    state: dict = {}
    for line in text.splitlines():
        r = json.loads(line)
        if r["diff"] > 0:
            state[r["word"]] = r["cnt"]
        elif state.get(r["word"]) == r["cnt"]:
            del state[r["word"]]
    return state


@pytest.mark.parametrize("mode", ["PERSISTING", "OPERATOR_PERSISTING"])
def test_sigkill_after_a_commit_then_resume(tmp_path, mode):
    n, kill = 6, 3
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=REPO))
    want = collections.Counter()
    for k in range(n):
        want.update(["common", f"w{k}_a", f"w{k}_b", f"w{k}_a"])
    finals = {}
    for name, pkg in (("torch", "pathway_tpu_torch"), ("jax", "pathway_tpu")):
        root = tmp_path / name
        (root / "data").mkdir(parents=True)
        out = root / "out.jsonl"
        env = dict(os.environ, JAX_PLATFORMS="cpu", PATHWAY_TPU_DEVICE_OPS="0",
                   PATHWAY_RUN_ID=f"run-{name}-{mode}")
        args = [sys.executable, str(script), pkg, str(root / "data"), str(root / "store"),
                str(out), mode]
        killed = subprocess.run(args + [str(kill), str(n)], env=env, timeout=120)
        assert killed.returncode == -9, killed.returncode
        written_before = len(out.read_text().splitlines())
        resumed = subprocess.run(args + ["0", str(n)], env=env, timeout=120)
        assert resumed.returncode == 0
        text = out.read_text()
        finals[name] = _fold(text)
        tail = [json.loads(ln)["word"] for ln in text.splitlines()[written_before:]]
        if mode == "OPERATOR_PERSISTING":
            # no history replayed: the words of the files before the killed commit
            # are not emitted again
            assert not {w for w in tail if w.startswith(("w0_", "w1_"))}, tail
        else:
            assert "w0_a" in tail  # the journal replays the whole history
    assert finals["torch"] == finals["jax"] == dict(want)


# -- the port's seams ------------------------------------------------------------


def test_environment_config_in_all_three_modes(tmp_path, monkeypatch):
    data = tmp_path / "data"
    data.mkdir()
    _write(data, "a.txt", ["k", "l", "k"])
    for mode, artefact in (("persisting", "journal-w"),
                           ("operator_persisting", "operator-snapshot"),
                           ("udf_caching", None)):
        store = tmp_path / f"store-{mode}"
        monkeypatch.setenv("PATHWAY_PERSISTENT_STORAGE", str(store))
        monkeypatch.setenv("PATHWAY_PERSISTENCE_MODE", mode)
        for _ in range(2):  # the second run resumes
            words = tpw.io.plaintext.read(data, mode="static", persistent_id="w")
            seen = {}
            counts = words.groupby(words.data).reduce(word=words.data, cnt=tpw.reducers.count())
            tpw.io.subscribe(counts, on_change=lambda key, row, time, is_addition: seen.update(
                {row["word"]: row["cnt"]} if is_addition else {}))
            tpw.run()
        files = sorted(os.listdir(store))
        if artefact is None:
            assert files == []
        else:
            assert files == [artefact]
        if mode == "persisting":
            assert seen == {"k": 2, "l": 1}  # replayed into the state
        elif mode == "operator_persisting":
            assert seen == {}  # restored, nothing new to emit
        else:
            assert seen == {"k": 2, "l": 1}  # read again: no journal in this mode


def test_udf_caching_mode_routes_the_disk_cache(tmp_path, monkeypatch):
    from pathway_tpu_torch.internals.udfs import caches
    from pathway_tpu_torch.persistence import Backend, Config, PersistenceMode

    monkeypatch.setattr(caches, "_udf_cache_root", None)
    calls = []

    @tpw.udf(cache_strategy=tpw.udfs.DiskCache())
    def shout(s: str) -> str:
        calls.append(s)
        return s.upper()

    data = tmp_path / "data"
    data.mkdir()
    _write(data, "a.txt", ["x", "y"])
    store = tmp_path / "store"
    results = []
    for _ in range(2):
        t = tpw.io.plaintext.read(data, mode="static")
        out = {}
        tpw.io.subscribe(t.select(v=shout(t.data)),
                         on_change=lambda key, row, time, is_addition: out.update({key: row["v"]}))
        tpw.run(persistence_config=Config(Backend.filesystem(store),
                                          persistence_mode=PersistenceMode.UDF_CACHING))
        results.append(sorted(out.values()))
    assert results == [["X", "Y"], ["X", "Y"]]
    assert sorted(calls) == ["x", "y"]  # the second run read the cache
    assert os.listdir(store) == ["udf-cache"]


def test_backends_and_refusals(tmp_path):
    from pathway_tpu_torch.engine import persistence as tp
    from pathway_tpu_torch.persistence import Backend

    mem = Backend.mock()
    mem.append("j", b"ab")
    mem.append("j", b"c")
    assert mem.read("j") == b"abc" and mem.exists("j") and not mem.exists("k")
    fs = Backend.filesystem(tmp_path / "fs")
    fs.write("a/b", b"1")
    fs.write("a_b", b"2")  # distinct names never share a file
    assert fs.read("a/b") == b"1" and fs.read("a_b") == b"2" and fs.read("none") == b""
    # without a client, the reference's errors (tests/test_torch_connectors.py runs
    # both backends over an injected store)
    with pytest.raises(ValueError, match="client= or bucket_settings="):
        Backend.s3("root")
    with pytest.raises(ImportError, match="blob client"):
        Backend.azure("root")
    # workers in one process run; more than one process still raises naming item 14
    tpw.run(threads=2)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 14"):
        tpw.run(processes=2)
    # two workers' source states re-shard onto three: worker 0 holds the whole source,
    # the others their row-key shards
    graph = _mod(tpw, "engine.graph")
    from pathway_tpu_torch.engine.routing import _shard_of

    keys = [_mod(tpw, "engine.value").ref_scalar(i) for i in range(12)]
    old = [[{"current": {}}, {"current": {k: (i,) for i, k in enumerate(keys[:7])}}],
           [{"current": {}}, {"current": {k: (i + 7,) for i, k in enumerate(keys[7:])}}]]
    news = []
    for _ in range(3):
        sc = graph.Scope()
        sc.input_session(1)
        news.append(sc)
    split = tp._reshard_worker_states(old, news)
    assert split[0][1]["current"] == {k: (i,) for i, k in enumerate(keys)}
    for w in (1, 2):
        assert split[w][1]["current"] == {k: (i,) for i, k in enumerate(keys)
                                          if _shard_of(k, 3) == w}
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 14"):
        tp.reshard_process_snapshots(mem, 2, 1, 1, [], n_shared=0)
    # a snapshot of two workers' scopes restores into two
    scope = graph.Scope()
    mgr = tp.OperatorSnapshotManager(mem)
    mgr.snapshot([scope, scope], [], 1)
    assert mgr.restore([graph.Scope(), graph.Scope()], []) == 1
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        tpw.run(strict=True)


def test_journal_segments_equal_the_reference_segments(tmp_path):
    """The journal of one run, decoded segment by segment: the same events (kind,
    int(key), row, source), reader positions and key sequences in both packages."""
    segs = []
    data = tmp_path / "data"  # one path: the keys hash the source's name and path
    data.mkdir()
    for name, pw in PACKAGES.items():
        store = tmp_path / name / "store"
        _write(data, "a.txt", ["u", "v"])
        runner, _node = _build(pw, data, store)
        _drive(pw, runner, 2)
        _write(data, "a.txt", ["u"])
        later = time.time() + 5
        os.utime(data / "a.txt", (later, later))
        _drive(pw, runner, 2)
        raw = (store / "journal-words").read_bytes()
        out = []
        for seg in _mod(pw, "engine.persistence")._segments(raw):
            events = [(k, int(key), row, os.path.basename(src)) for k, key, row, src in seg["events"]]
            out.append((events, sorted(os.path.basename(p) for p in seg["reader"]["seen"]),
                        seg["seq"]))
        segs.append(out)
    assert segs[0] == segs[1]
    assert [len(s[0]) for s in segs[0]] == [2, 3]  # two inserts; two retractions and one insert


def _gated_handle(gate: threading.Event):
    """A live device batch whose host copy waits on ``gate`` (a stand-in for the CUDA
    event the completion thread waits on)."""

    class _Gated:
        def synchronize(self):
            if not gate.wait(timeout=30.0):
                raise TimeoutError("test gate never opened")

    t = torch.ones(2, 2)
    handle = tdev.DeviceBatchHandle(t)
    handle._pinned = t.clone()
    handle._copied = _Gated()
    return handle


@pytest.mark.parametrize("barrier", ["kept", "removed"])
@pytest.mark.parametrize("mode", ["PERSISTING", "OPERATOR_PERSISTING"])
def test_checkpoints_wait_for_the_commits_device_work(tmp_path, monkeypatch, mode, barrier):
    """Each commit stages a device batch whose copy a gate holds open for 0.2 s; with
    the async pipeline on, the journal segment or snapshot of commit N is cut only
    after N's batch completed (``drain_until``). With the barrier taken out, the cut
    sees the commit still in flight: the check has teeth."""
    from pathway_tpu_torch.engine import persistence as tp
    from pathway_tpu_torch.persistence import Backend, Config, PersistenceMode

    monkeypatch.setenv("PATHWAY_TPU_ASYNC_DEVICE", "1")
    dp.PIPELINE.configure()
    if barrier == "removed":
        monkeypatch.setattr(dp, "drain_until", lambda time: None)
    handles, cuts = [], []

    def make_row(s: str) -> str:
        gate = threading.Event()
        handles.append(_gated_handle(gate))
        threading.Timer(0.2, gate.set).start()
        return s

    def record(time):
        cuts.append((time, dp.PIPELINE.inflight(), [h.dev is None for h in handles]))

    if mode == "PERSISTING":
        orig = tp.PersistentDriver.on_commit
        monkeypatch.setattr(tp.PersistentDriver, "on_commit",
                            lambda self, time: (record(time), orig(self, time))[1])
    else:
        orig = tp.OperatorSnapshotManager.on_commit
        monkeypatch.setattr(tp.OperatorSnapshotManager, "on_commit",
                            lambda self, scope, drivers, time: (record(time), orig(self, scope, drivers, time))[1])

    class Feed(tpw.io.python.ConnectorSubject):
        def run(self):
            for i in range(3):
                self.next(data=f"row{i}")
                time.sleep(0.05)

    data = tmp_path / "data"
    data.mkdir()
    _write(data, "a.txt", ["f0", "f1"])
    files = tpw.io.plaintext.read(data, mode="static", persistent_id="files")
    rows = tpw.io.python.read(Feed(), schema=tpw.schema_from_types(data=str), autocommit_duration_ms=0)
    both = files.concat_reindex(rows).select(v=tpw.apply(make_row, tpw.this.data))
    tpw.io.null.write(both)
    try:
        tpw.run(persistence_config=Config(Backend.filesystem(tmp_path / "store"),
                                          persistence_mode=PersistenceMode[mode]))
    finally:
        dp.PIPELINE.drain()
        dp.PIPELINE.stop_worker()
    assert cuts and handles
    if barrier == "kept":
        assert all(inflight == 0 and all(done) for _t, inflight, done in cuts), cuts
    else:
        assert any(inflight > 0 for _t, inflight, _done in cuts), cuts
