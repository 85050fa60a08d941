"""The in-process connectors of the port against the JAX package's, on the same inputs:
SQLite (one database file read by both packages while another connection inserts,
updates and deletes between commits), the object stores (``s3``, ``minio``, ``s3_csv``
over ``DictObjectStore``, ``pyfilesystem`` over an ``FS``-shaped source, ``gdrive`` over
an injected ``http_fn`` with canned folder listings), Delta Lake (written by one package
and read by the other, both ways), the input synchronization groups, and an
``Backend.s3``-persisted program crashed and resumed.

Every comparison is exact: keys, values and diffs of the update streams, commit by
commit, the readers' ``state()`` and what a reader restored from it reads. The programs
are driven by hand (poll every driver, then commit through each package's
``Scheduler``), so both packages see the same commits.
"""

from __future__ import annotations

import importlib
import json
import sqlite3
import types

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch.engine import device_ops as dops
from pathway_tpu_torch.internals.parse_graph import G as TG

PACKAGES = {"torch": tpw, "jax": jpw}


@pytest.fixture(autouse=True)
def _clean():
    dops.configure(device="cpu")
    TG.clear()
    JG.clear()
    yield
    TG.clear()
    JG.clear()
    dops.configure()


def _mod(pw, name: str):
    return importlib.import_module(f"{pw.__name__}.{name}")


def _canon(v):
    """A value both packages print alike: Json by its value."""
    if type(v).__name__ == "Json":
        return ("json", json.dumps(v.value, sort_keys=True))
    if isinstance(v, tuple):
        return tuple(_canon(x) for x in v)
    return v


class _Driven:
    """``table`` of package ``pw`` built by a ``GraphRunner`` (with ``config`` as its
    persistence config), its update stream recorded commit by commit."""

    def __init__(self, pw, table, config=None) -> None:
        self.runner = _mod(pw, "internals.runner").GraphRunner(persistence_config=config)
        self.node = self.runner.build(table)
        self.commits: list[list] = []
        self._open: list = []
        self.runner.scope.subscribe_table(
            self.node,
            on_change=lambda key, row, time, diff: self._open.append((int(key), _canon(tuple(row)), diff)),
        )
        self.sched = _mod(pw, "engine.graph").Scheduler(self.runner.scope)
        self.persistent = [d for d in self.runner.drivers if hasattr(d, "replay")]
        for d in self.persistent:
            d.replay()
        self.sched.commit()
        self._close()

    def _close(self) -> None:
        self.commits.append(sorted(self._open, key=repr))
        self._open = []

    def step(self) -> list:
        """One poll of every driver and a commit -> the commit's updates."""
        for d in self.runner.drivers:
            d.poll()
        t = self.sched.commit()
        for d in self.persistent:
            d.on_commit(t)
        self._close()
        return self.commits[-1]

    def state(self) -> dict:
        return {int(k): _canon(tuple(v)) for k, v in self.node.current.items()}


# -- SQLite -------------------------------------------------------------------------------


def _users_db(path) -> sqlite3.Connection:
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE users (name TEXT, age INTEGER, score REAL)")
    conn.executemany("INSERT INTO users VALUES (?, ?, ?)",
                     [("alice", 30, 1.5), ("bob", 25, None), ("carol", 41, -2.25)])
    conn.commit()
    return conn


def _users_schema(pw):
    class S(pw.Schema):
        name: str
        age: int
        score: float | None

    return S


def test_sqlite_static_snapshot_is_the_same(tmp_path):
    db = tmp_path / "db.sqlite"
    _users_db(db).close()
    got = {}
    for name, pw in PACKAGES.items():
        t = pw.io.sqlite.read(db, "users", _users_schema(pw), mode="static")
        (snap,) = _mod(pw, "internals.runner").GraphRunner().capture(t)
        got[name] = {int(k): tuple(v) for k, v in snap.items()}
    assert got["torch"] == got["jax"]
    assert sorted(got["torch"].values()) == [("alice", 30, 1.5), ("bob", 25, None), ("carol", 41, -2.25)]


def test_sqlite_streams_another_connections_writes_alike(tmp_path):
    """Both packages poll one database file; between commits another connection
    inserts, updates and deletes. The update streams are equal, keys (rowids) included,
    and a reader restored from the other's ``state()`` reads nothing new."""
    db = tmp_path / "db.sqlite"
    writer = _users_db(db)
    driven = {name: _Driven(pw, pw.io.sqlite.read(db, "users", _users_schema(pw)))
              for name, pw in PACKAGES.items()}
    rounds = [
        [],
        ["UPDATE users SET age = 31 WHERE name = 'alice'", "DELETE FROM users WHERE name = 'bob'"],
        ["INSERT INTO users VALUES ('dave', 19, 0.125)", "UPDATE users SET score = NULL WHERE name = 'carol'"],
        [],  # no write: data_version unchanged, nothing read
        ["DELETE FROM users", "INSERT INTO users VALUES ('erin', 50, 3.0)"],
    ]
    for statements in rounds:
        for stmt in statements:
            writer.execute(stmt)
        writer.commit()
        for d in driven.values():
            d.step()
    assert driven["torch"].commits == driven["jax"].commits
    assert [len(c) for c in driven["torch"].commits] == [0, 3, 3, 3, 0, 4]
    assert sorted(driven["torch"].state().values()) == [("erin", 50, 3.0)]
    readers = {name: d.runner.drivers[0].reader for name, d in driven.items()}
    assert readers["torch"].state() == readers["jax"].state()
    for name, pw in PACKAGES.items():
        fresh = _mod(pw, "engine.storage").SqliteReader(str(db), "users", ["name", "age", "score"])
        fresh.restore_state(readers["jax" if name == "torch" else "torch"].state())
        assert fresh.poll() == ([], False)
        assert fresh.state() == readers[name].state()


# -- object stores --------------------------------------------------------------------------


def _store(pw):
    return pw.io.s3.DictObjectStore()


def test_s3_streams_puts_rewrites_and_deletions_alike():
    driven, stores = {}, {}
    for name, pw in PACKAGES.items():
        stores[name] = store = _store(pw)
        t = pw.io.s3.read("p/", format="json", schema=pw.schema_from_types(w=str, n=int),
                          client=store, with_metadata=True)
        driven[name] = _Driven(pw, t)
    steps = [
        lambda s: s.put_object("p/a.jsonl", '{"w": "x", "n": 1}\n{"w": "y", "n": 2}'),
        lambda s: (s.put_object("p/a.jsonl", '{"w": "x2", "n": 1}'),  # a rewrite replaces
                   s.put_object("p/b.jsonl", b'{"w": "z", "n": 3}\n'),
                   s.put_object("q/c.jsonl", '{"w": "outside", "n": 0}')),
        lambda s: None,  # unchanged: nothing read
        lambda s: s.delete_object("p/b.jsonl"),  # a deletion retracts
    ]
    for step in steps:
        for name, d in driven.items():
            step(stores[name])
            d.step()
    assert driven["torch"].commits == driven["jax"].commits
    assert [len(c) for c in driven["torch"].commits] == [0, 2, 4, 0, 1]
    assert sorted(v[:2] for v in driven["torch"].state().values()) == [("x2", 1)]


@pytest.mark.parametrize("alias", ["minio", "s3_csv"])
def test_the_aliases_read_as_s3(alias):
    got = {}
    for name, pw in PACKAGES.items():
        store = _store(pw)
        if alias == "minio":
            store.put_object("b/k/a.jsonl", b'{"v": 7}\n{"v": 8}\n')
            t = pw.io.minio.read("b/k", format="json", schema=pw.schema_from_types(v=int),
                                 mode="static", client=store)
        else:
            store.put_object("b/data/a.csv", b"a,b\n1,x\n2,y\n")
            t = pw.io.s3_csv.read("b/data", schema=pw.schema_from_types(a=int, b=str), mode="static",
                                  client=store)
        (snap,) = _mod(pw, "internals.runner").GraphRunner().capture(t)
        got[name] = {int(k): tuple(v) for k, v in snap.items()}
    assert got["torch"] == got["jax"] and len(got["torch"]) == 2


def test_s3_writers_put_the_same_objects():
    got = {}
    for name, pw in PACKAGES.items():
        store = _store(pw)
        t = pw.debug.table_from_rows(pw.schema_from_types(w=str, n=int), [("a", 1), ("b", 2)])
        pw.io.s3.write(t, "out", client=store)
        pw.run()
        got[name] = {key: store.get_object(key) for key, _sig in store.list_objects("out/")}
    assert got["torch"] == got["jax"]
    (body,) = got["torch"].values()
    assert sorted(json.loads(line)["w"] for line in body.decode().splitlines()) == ["a", "b"]


def test_s3_without_boto3_raises_import_error_in_both():
    for pw in PACKAGES.values():
        settings = pw.io.s3.AwsS3Settings(bucket_name="b", access_key="k", secret_access_key="s")
        with pytest.raises(ImportError, match="boto3"):
            settings.create_client()
        with pytest.raises(ImportError, match="boto3"):
            pw.io.s3.read("p/", schema=pw.schema_from_types(v=int), aws_s3_settings=settings)
        minio = pw.io.minio.MinIOSettings("http://minio:9000", "b", "k", "s")
        with pytest.raises(ImportError, match="boto3"):
            pw.io.minio.read("p/", minio_settings=minio, schema=pw.schema_from_types(v=int))
        with pytest.raises(ValueError, match="client"):
            pw.io.s3.read("p/", schema=pw.schema_from_types(v=int))


class _FakeFS:
    """The PyFilesystem surface the reader uses: ``walk.files``, ``getinfo``,
    ``readbytes``."""

    def __init__(self) -> None:
        self.files: dict[str, tuple[bytes, str]] = {}
        self.walk = types.SimpleNamespace(files=self._walk_files)

    def put(self, path: str, data: bytes, modified: str) -> None:
        self.files[path] = (data, modified)

    def _walk_files(self, path: str):
        return [p for p in sorted(self.files) if p.startswith(path.rstrip("/") + "/") or path == "/"]

    def getinfo(self, path: str, namespaces=None):
        data, modified = self.files[path]
        return types.SimpleNamespace(size=len(data), modified=modified)

    def readbytes(self, path: str) -> bytes:
        return self.files[path][0]


def test_pyfilesystem_reads_and_restores_alike():
    driven, sources = {}, {}
    for name, pw in PACKAGES.items():
        sources[name] = fs = _FakeFS()
        fs.put("/docs/a.txt", b"alpha", "2026-01-01")
        fs.put("/docs/sub/b.txt", b"beta", "2026-01-01")
        driven[name] = _Driven(pw, pw.io.pyfilesystem.read(fs, "/docs", with_metadata=True))
    steps = [
        lambda fs: None,
        lambda fs: (fs.put("/docs/a.txt", b"alpha2", "2026-02-02"), fs.files.pop("/docs/sub/b.txt")),
        lambda fs: fs.put("/docs/c.txt", b"gamma", "2026-03-03"),
    ]
    for step in steps:
        for name, d in driven.items():
            step(sources[name])
            d.step()
    assert driven["torch"].commits == driven["jax"].commits
    assert sorted(v[0] for v in driven["torch"].state().values()) == [b"alpha2", b"gamma"]
    readers = {name: d.runner.drivers[0].reader for name, d in driven.items()}
    assert readers["torch"].state() == readers["jax"].state()
    for name, pw in PACKAGES.items():
        fresh = _mod(pw, "engine.storage").ObjectStoreReader(readers[name].client, "", binary=True)
        fresh.restore_state(readers["torch"].state())
        sources[name].put("/docs/d.txt", b"delta", "2026-04-04")
        entries, done = fresh.poll()
        assert [(e[1], e[0]) for e in entries] == [("/docs/d.txt", b"delta")] and not done


API = "https://drive.test/drive/v3"
FOLDER = "application/vnd.google-apps.folder"


class _Drive:
    """Canned Drive REST v3 answers behind an ``http_fn``: ``files.list`` (two files a
    page, so ``nextPageToken`` is followed), ``alt=media`` and ``export``."""

    def __init__(self) -> None:
        self.files: dict[str, dict] = {}
        self.requests: list = []

    def put(self, fid, parent, content=b"", mime="text/plain", modified="2026-01-01T00:00:00Z"):
        self.files[fid] = {"id": fid, "name": fid, "mimeType": mime, "modifiedTime": modified,
                           "content": content, "parent": parent}

    def http_fn(self, url: str, params: dict, headers: dict) -> bytes:
        self.requests.append((url, dict(params)))
        path = url[len(API):]
        if path == "/files":
            parent = params["q"].split("'")[1]
            kids = [f for _i, f in sorted(self.files.items()) if f["parent"] == parent]
            start = int(params.get("pageToken", 0))
            page = {"files": [{k: f[k] for k in ("id", "name", "mimeType", "modifiedTime")} | {
                "parents": [parent], "trashed": False} for f in kids[start:start + 2]]}
            if start + 2 < len(kids):
                page["nextPageToken"] = str(start + 2)
            return json.dumps(page).encode()
        fid = path.split("/")[2]
        if path.endswith("/export"):
            return b"exported:" + self.files[fid]["content"]
        assert params == {"alt": "media"}
        return self.files[fid]["content"]


def _drive() -> _Drive:
    drive = _Drive()
    drive.put("a", "root", b"alpha")
    drive.put("b", "root", b"beta")
    drive.put("sub", "root", mime=FOLDER)
    drive.put("c", "sub", b"nested")
    drive.put("doc1", "root", b"text", mime="application/vnd.google-apps.document")
    return drive


def test_gdrive_rows_and_state_are_the_same():
    driven, drives = {}, {}
    for name, pw in PACKAGES.items():
        drives[name] = drive = _drive()
        t = pw.io.gdrive.read("root", http_fn=drive.http_fn, api_base=API, refresh_interval=0.0)
        driven[name] = _Driven(pw, t)
    steps = [
        lambda d: None,
        lambda d: None,  # no change: no events
        lambda d: (d.put("a", "root", b"alpha2", modified="2026-02-02T00:00:00Z"), d.files.pop("b")),
    ]
    for step in steps:
        for name, d in driven.items():
            step(drives[name])
            d.step()
    assert driven["torch"].commits == driven["jax"].commits
    assert sorted(v[0] for v in driven["torch"].state().values()) == [b"alpha2", b"exported:text", b"nested"]
    assert drives["torch"].requests == drives["jax"].requests
    readers = {name: d.runner.drivers[0].reader for name, d in driven.items()}
    assert readers["torch"].state() == readers["jax"].state()
    for name, pw in PACKAGES.items():
        gd = _mod(pw, "io.gdrive")
        fresh = gd._GDrivePollReader(gd.GDriveClient(drives[name].http_fn, api_base=API), "root",
                                     "streaming", 0.0)
        fresh.restore_state(readers[name].state())
        drives[name].put("c", "sub", b"nested2", modified="2026-03-03T00:00:00Z")
        events, _done = fresh.poll()
        assert [(p[0], p[1], p[2]) for p, _s, _m in events] == [("upsert", "c", b"nested2")]
        assert fresh.state() == {"known": {"a": "2026-02-02T00:00:00Z", "c": "2026-03-03T00:00:00Z",
                                           "doc1": "2026-01-01T00:00:00Z"}}


def test_gdrive_static_read_through_capture_with_metadata():
    got = {}
    for name, pw in PACKAGES.items():
        t = pw.io.gdrive.read("root", mode="static", http_fn=_drive().http_fn, api_base=API,
                              with_metadata=True)
        (snap,) = _mod(pw, "internals.runner").GraphRunner().capture(t)
        got[name] = {int(k): _canon(tuple(v)) for k, v in snap.items()}
    assert got["torch"] == got["jax"] and len(got["torch"]) == 4
    with pytest.raises(ValueError, match="http_fn"):
        tpw.io.gdrive.read("root")


# -- Delta Lake -------------------------------------------------------------------------------

ROWS = [(1, 0.5, True, "a"), (2, -1.25, False, "b"), (3, 2.0, True, None)]


def _typed_schema(pw):
    class S(pw.Schema):
        i: int
        f: float
        b: bool
        s: str | None

    return S


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_deltalake_written_by_one_package_reads_back_in_the_other(tmp_path, writer, reader):
    lake = tmp_path / "lake"
    wpw, rpw = PACKAGES[writer], PACKAGES[reader]
    wpw.io.deltalake.write(wpw.debug.table_from_rows(_typed_schema(wpw), ROWS), lake)
    wpw.run()
    log = sorted(p.name for p in (lake / "_delta_log").iterdir())
    assert log == ["00000000000000000000.json", "00000000000000000001.json"]
    t = rpw.io.deltalake.read(lake, schema=_typed_schema(rpw), mode="static")
    (snap,) = _mod(rpw, "internals.runner").GraphRunner().capture(t)
    assert sorted(snap.values()) == sorted(ROWS)


def test_deltalake_streaming_readers_see_appends_alike(tmp_path):
    from pathway_tpu.internals import dtype as jdt
    from pathway_tpu.io.deltalake import DeltaWriter as JDeltaWriter

    lake = str(tmp_path / "lake")
    w = JDeltaWriter(lake, ["w"], {"w": jdt.STR})
    w.on_change(None, ("a",), 0, 1)
    w.on_time_end(0)
    readers = {name: _mod(pw, "io.deltalake").DeltaReader(lake, ["w"], mode="streaming")
               for name, pw in PACKAGES.items()}
    got = {name: [] for name in PACKAGES}
    for batch in ([("b",), ("c",)], []):
        for name, r in readers.items():
            entries, done = r.poll()
            assert not done
            got[name].append([(src, e.kind, e.values) for events, src, _m in entries for e in events])
        for i, row in enumerate(batch):
            w.on_change(None, row, 2, 1)
        w.on_time_end(2)
    assert [[v for _s, _k, v in step] for step in got["torch"]] == [[("a",)], [("b",), ("c",)]]
    assert [[(k, v) for _s, k, v in step] for step in got["torch"]] == [
        [(k, v) for _s, k, v in step] for step in got["jax"]]
    assert readers["torch"].state() == readers["jax"].state() == {"next_version": 3}


def test_deltalake_retractions_need_a_primary_key_in_both(tmp_path):
    from pathway_tpu.internals import dtype as jdt
    from pathway_tpu.io.deltalake import DeltaWriter as JDeltaWriter

    lake = str(tmp_path / "lake")
    w = JDeltaWriter(lake, ["k", "v"], {"k": jdt.STR, "v": jdt.INT})
    w.on_change(None, ("a", 1), 0, 1)
    w.on_change(None, ("b", 2), 0, 1)
    w.on_time_end(0)
    w.on_change(None, ("a", 1), 2, -1)
    w.on_time_end(2)
    for pw in PACKAGES.values():
        with pytest.raises(ValueError, match="primary_key"):
            _mod(pw, "io.deltalake").DeltaReader(lake, ["k", "v"], mode="static").poll()

        class S(pw.Schema):
            k: str = pw.column_definition(primary_key=True)
            v: int

        (snap,) = _mod(pw, "internals.runner").GraphRunner().capture(
            pw.io.deltalake.read(lake, schema=S, mode="static"))
        assert sorted(snap.values()) == [("b", 2)]


# -- synchronization groups -----------------------------------------------------------------


def test_sources_advance_together_in_both_packages():
    """``test_sources_advance_together``'s program through ``pw.run``: every row arrives,
    and the fast source's t=50 row never lands before the slow source's t=48."""
    got = {}
    for name, pw in PACKAGES.items():
        class Fast(pw.io.python.ConnectorSubject):
            def run(self):
                for t in (0, 1, 2, 50, 51):
                    self.next(t=t, src="fast")

        class Slow(pw.io.python.ConnectorSubject):
            def run(self):
                for t in (0, 10, 48):
                    self.next(t=t, src="slow")

        schema = pw.schema_from_types(t=int, src=str)
        fast, slow = pw.io.python.read(Fast(), schema=schema), pw.io.python.read(Slow(), schema=schema)
        pw.io.register_input_synchronization_group(fast.t, slow.t, max_difference=10)
        arrivals: list = []
        pw.io.subscribe(fast.concat_reindex(slow), on_change=lambda key, row, time, is_addition:
                        arrivals.append((time, row["t"], row["src"])))
        pw.run()
        commit_of = {(t, s): c for c, t, s in arrivals}
        got[name] = (sorted(commit_of), commit_of[(50, "fast")] >= commit_of[(48, "slow")])
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == sorted([(0, "fast"), (1, "fast"), (2, "fast"), (50, "fast"), (51, "fast"),
                                      (0, "slow"), (10, "slow"), (48, "slow")])
    assert got["torch"][1]


def _sync_pair(pw, max_difference=10):
    """Two QueueReader drivers of one group, driven by hand -> (readers, drivers,
    sessions, scheduler)."""
    conn = _mod(pw, "engine.connectors")
    scope = _mod(pw, "engine.graph").Scope()
    group = _mod(pw, "io._synchronization").InputSynchronizationGroup(max_difference=max_difference)
    readers, drivers, sessions = [], [], []
    for _ in range(2):
        session = scope.input_session(1)
        reader = conn.QueueReader()
        driver = conn.InputDriver(session, reader, conn.JsonLinesParser(["t"]))
        driver.sync_group, driver.sync_col = group, 0
        group.register(driver)
        readers.append(reader)
        drivers.append(driver)
        sessions.append(session)
    return readers, drivers, sessions, _mod(pw, "engine.graph").Scheduler(scope)


SYNC_SCRIPTS = {
    # the fast source's t=50 waits until the slow one reaches 45
    "paced": [([('{"t": 0}\n{"t": 50}', 0), ('{"t": 0}', 1)], 2), ([('{"t": 45}', 1)], 2)],
    # a finished source stops capping: the slow one closes at t=0, fast's t=50 goes
    "finished": [([('{"t": 0}\n{"t": 50}', 0), ('{"t": 0}', 1)], 2), ([("close", 1)], 3)],
    # a time that does not compare with the frontier is admitted (fail open); the
    # comparable t=99 behind it is still held
    "non_comparable": [([('{"t": 0}', 0), ('{"t": 0}', 1)], 2), ([('{"t": "late"}\n{"t": 99}', 0)], 2)],
}


@pytest.mark.parametrize("script", sorted(SYNC_SCRIPTS))
def test_synchronization_group_releases_alike(script):
    got = {}
    for name, pw in PACKAGES.items():
        readers, drivers, sessions, sched = _sync_pair(pw)
        states = []
        for pushes, polls in SYNC_SCRIPTS[script]:
            for payload, i in pushes:
                if payload == "close":
                    readers[i].close()
                else:
                    readers[i].push(payload)
            statuses = []
            for _ in range(polls):
                statuses.append([d.poll() for d in drivers])
            sched.commit()
            states.append((statuses, [sorted(map(repr, (v[0] for v in s.current.values()))) for s in sessions]))
        got[name] = states
    assert got["torch"] == got["jax"]
    last_fast = got["torch"][-1][1][0]
    assert {"paced": ["0", "50"], "finished": ["0", "50"],
            "non_comparable": ["'late'", "0"]}[script] == last_fast
    if script == "paced":
        assert got["torch"][0][1][0] == ["0"]  # t=50 held while slow's frontier is 0


def test_a_group_needs_two_sources_in_both():
    for pw in PACKAGES.values():
        t = pw.debug.table_from_rows(pw.schema_from_types(t=int), [(1,)])
        with pytest.raises(ValueError):
            pw.io.register_input_synchronization_group(t.t, max_difference=5)
        u = pw.io.python.read(type("S", (pw.io.python.ConnectorSubject,), {"run": lambda self: None})(),
                              schema=pw.schema_from_types(t=int))
        with pytest.raises(ValueError, match="connector input tables"):
            pw.io.register_input_synchronization_group(u.t, t.t, max_difference=5)


# -- persistence on an object store ------------------------------------------------------------


def test_s3_backed_program_crashed_and_resumed_emits_the_same_rows():
    """A word count over ``pw.io.s3.read(persistent_id=...)`` journaled into
    ``Backend.s3(client=DictObjectStore())``: three rounds, a crash (the runner
    dropped), a new object, and a resume over the same stores; both packages emit the
    same rows, and the resume counts no word twice."""
    got = {}
    for name, pw in PACKAGES.items():
        pers = _mod(pw, "persistence")
        inputs, store = _store(pw), _store(pw)
        inputs.put_object("in/a.txt", "apple\nbanana\napple\n")

        def build():
            words = pw.io.s3.read("in/", format="plaintext", client=inputs, persistent_id="words")
            counts = words.groupby(words.data).reduce(word=words.data, cnt=pw.reducers.count())
            return _Driven(pw, counts, pers.Config(pers.Backend.s3("root", client=store)))

        first = build()
        for _ in range(3):
            first.step()
        before = first.state()
        del first  # a crash: nothing past the journaled commits
        inputs.put_object("in/b.txt", "banana\ncherry\n")
        second = build()
        for _ in range(3):
            second.step()
        got[name] = (before, second.commits, second.state(), sorted(k for k, _s in store.list_objects("")))
    assert got["torch"][:3] == got["jax"][:3]
    assert sorted(got["torch"][2].values()) == [("apple", 2), ("banana", 2), ("cherry", 1)]
    assert got["torch"][3] and got["jax"][3]  # both journaled into the object store


def test_persistence_backends_behave_as_the_references():
    for pw in PACKAGES.values():
        Backend = _mod(pw, "persistence").Backend
        with pytest.raises(ValueError, match="client"):
            Backend.s3("root")
        with pytest.raises(ImportError, match="boto3"):
            Backend.s3("root", bucket_settings=pw.io.s3.AwsS3Settings(bucket_name="b"))
        with pytest.raises(ImportError, match="blob client"):
            Backend.azure("root")
        backend = Backend.azure("root", client=pw.io.s3.DictObjectStore())
        backend.write("a/b", b"1")
        assert backend.read("a/b") == b"1"
