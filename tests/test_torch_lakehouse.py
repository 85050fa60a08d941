"""The lakehouse connectors of the port against the JAX package's, on the same inputs:
Iceberg (the REST catalog's client and server, each package's client against the
other's server; tables written by one package and read by the other over the
filesystem and the REST catalogs; the metadata, manifests and manifest lists byte for
byte; the streaming reader, retractions, concurrent commits), Airbyte (one
Airbyte-protocol script run by both packages: the same rows and STATE, incremental
syncs, full refresh, persistence), the license keys and SharePoint.

Every comparison is exact. Where a file name, a uuid or a timestamp would differ, the
test draws them from the same seeded stand-ins for ``uuid.uuid4``, ``time.time`` and
``secrets.token_bytes`` in both packages, so the files compare byte for byte.
"""

from __future__ import annotations

import contextvars
import importlib
import itertools
import json
import os
import secrets
import shutil
import sys
import textwrap
import threading
import time
import uuid

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch.engine import device_ops as dops
from pathway_tpu_torch.internals.parse_graph import G as TG

PACKAGES = {"torch": tpw, "jax": jpw}
#: (client's package, server's package): the port against itself and across
PAIRS = [("torch", "torch"), ("torch", "jax"), ("jax", "torch")]


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


def _mod(name: str, module: str):
    return importlib.import_module(f"{PACKAGES[name].__name__}.{module}")


def _rows_of(entries) -> list:
    return [(e.kind, e.values) for events, _src, _meta in entries for e in events]


# -- the REST catalog -------------------------------------------------------------------------


def _schema() -> dict:
    return {"type": "struct", "schema-id": 0, "fields": [
        {"id": 1, "name": "k", "required": False, "type": "long"}]}


def _commit(client, meta, head, snap_id, seq=1):
    return client.commit_table(
        ["db"], "t",
        requirements=[{"type": "assert-table-uuid", "uuid": meta["table-uuid"]},
                      {"type": "assert-ref-snapshot-id", "ref": "main", "snapshot-id": head}],
        updates=[{"action": "add-snapshot", "snapshot": {
            "snapshot-id": snap_id, "sequence-number": seq, "timestamp-ms": 5,
            "manifest-list": "metadata/x.avro", "summary": {"operation": "append"},
            "schema-id": 0}},
            {"action": "set-snapshot-ref", "ref-name": "main", "type": "branch",
             "snapshot-id": snap_id}])


@pytest.mark.parametrize("client,server", PAIRS)
def test_rest_create_load_commit(client, server, tmp_path):
    rest = _mod(client, "io._iceberg_rest")
    srv = _mod(server, "io._iceberg_rest").FakeIcebergRestServer(str(tmp_path / "wh"))
    try:
        c = rest.RestCatalogClient(srv.uri())
        assert c.config()["overrides"]["warehouse"] == str(tmp_path / "wh")
        assert c.load_table(["db"], "t") is None
        c.create_namespace(["db"])
        c.create_namespace(["db"])  # 409: the namespace exists, which is fine
        meta = c.create_table(["db"], "t", _schema())["metadata"]
        assert meta["format-version"] == 2 and meta["snapshots"] == []
        assert os.path.isdir(os.path.join(meta["location"], "metadata"))
        with pytest.raises(rest.IcebergRestError) as err:
            c.create_table(["db"], "t", _schema())
        assert err.value.code == 409
        assert c.load_table(["db"], "t")["metadata"]["table-uuid"] == meta["table-uuid"]
        out = _commit(c, meta, None, 77)["metadata"]
        assert out["current-snapshot-id"] == 77 and out["last-sequence-number"] == 1
        assert out["refs"] == {"main": {"snapshot-id": 77, "type": "branch"}}
        assert [m for m, _p in srv.requests] == ["GET", "GET", "POST", "POST", "POST", "POST",
                                                 "GET", "POST"]
    finally:
        srv.close()


@pytest.mark.parametrize("client,server", PAIRS)
def test_rest_stale_snapshot_conflicts(client, server, tmp_path):
    rest = _mod(client, "io._iceberg_rest")
    srv = _mod(server, "io._iceberg_rest").FakeIcebergRestServer(str(tmp_path / "wh"))
    try:
        c = rest.RestCatalogClient(srv.uri())
        c.create_namespace(["db"])
        meta = c.create_table(["db"], "t", _schema())["metadata"]
        _commit(c, meta, None, 1)
        with pytest.raises(rest.IcebergRestError) as err:
            _commit(c, meta, None, 2)  # the ref moved to 1
        assert err.value.code == 409 and "is at 1" in str(err.value)
        with pytest.raises(rest.IcebergRestError) as err:
            _commit(c, {"table-uuid": "other"}, 1, 2)
        assert err.value.code == 409
        assert srv.conflicts == 2
        _commit(c, meta, 1, 2, seq=2)
        assert c.load_table(["db"], "t")["metadata"]["current-snapshot-id"] == 2
    finally:
        srv.close()


@pytest.mark.parametrize("client,server", PAIRS)
def test_rest_bearer_token(client, server, tmp_path):
    rest = _mod(client, "io._iceberg_rest")
    srv = _mod(server, "io._iceberg_rest").FakeIcebergRestServer(str(tmp_path / "wh"),
                                                                 token="tok123")
    try:
        with pytest.raises(rest.IcebergRestError) as err:
            rest.RestCatalogClient(srv.uri()).load_table(["db"], "t")
        assert err.value.code == 401 and "invalid token" in str(err.value)
        assert rest.RestCatalogClient(srv.uri(), token="tok123").load_table(["db"], "t") is None
    finally:
        srv.close()


def test_rest_fake_server_stops_its_threads_on_close(tmp_path):
    before = set(threading.enumerate())
    srv = _mod("torch", "io._iceberg_rest").FakeIcebergRestServer(str(tmp_path / "wh"))
    _mod("torch", "io._iceberg_rest").RestCatalogClient(srv.uri()).config()
    srv.close()
    assert set(threading.enumerate()) <= before


# -- Iceberg tables across the packages -------------------------------------------------------

ROWS = [(1, 0.5, True, "a"), (2, -1.25, False, "b"), (3, 2.0, True, None), (4, 1e-300, False, "é")]


def _typed_schema(pw):
    class S(pw.Schema):
        i: int
        f: float
        b: bool
        s: str | None

    return S


@pytest.mark.parametrize("writer,reader,server",
                         [("torch", "jax", "torch"), ("jax", "torch", "jax"),
                          ("torch", "torch", "jax")])
@pytest.mark.parametrize("catalog", ["filesystem", "rest"])
def test_iceberg_table_written_by_one_package_reads_in_the_other(tmp_path, catalog, writer,
                                                                  reader, server):
    wpw, rpw = PACKAGES[writer], PACKAGES[reader]
    srv = None
    uri = tmp_path / "wh"
    if catalog == "rest":
        srv = _mod(server, "io._iceberg_rest").FakeIcebergRestServer(str(uri))
        uri = srv.uri()
    try:
        wpw.io.iceberg.write(wpw.debug.table_from_rows(_typed_schema(wpw), ROWS), uri, ["db"], "t")
        wpw.run()
        back = rpw.io.iceberg.read(uri, ["db"], "t", schema=_typed_schema(rpw), mode="static")
        (snap,) = _mod(reader, "internals.runner").GraphRunner().capture(back)
        assert sorted(snap.values(), key=repr) == sorted(ROWS, key=repr)
    finally:
        if srv is not None:
            srv.close()


class _Seeded:
    """Seeded stand-ins for uuid4, time.time and the Avro sync marker."""

    def __init__(self, monkeypatch) -> None:
        self.reset()
        monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(self._ids)))
        monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0 + next(self._ticks))
        monkeypatch.setattr(secrets, "token_bytes", lambda n: bytes(range(n)))

    def reset(self) -> None:
        self._ids = itertools.count(12345)
        self._ticks = itertools.count()


def _tree(root) -> dict:
    """Every file under ``root``, by its path relative to ``root``, with its bytes."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("catalog", ["filesystem", "rest"])
def test_iceberg_files_are_the_same_bytes(tmp_path, monkeypatch, catalog):
    """Three commits (inserts, a retraction) by each package's ``IcebergWriter`` under the
    same seeded uuids and clocks: every metadata document, manifest, manifest list and
    data file is the same bytes, and the catalog saw the same requests."""
    seeded = _Seeded(monkeypatch)
    got = {}
    root = str(tmp_path / "wh")  # the same path for both: the metadata holds the location
    for name in PACKAGES:
        seeded.reset()
        ice, dt = _mod(name, "io.iceberg"), _mod(name, "internals.dtype")
        shutil.rmtree(root, ignore_errors=True)
        srv = None
        if catalog == "rest":
            srv = _mod("torch", "io._iceberg_rest").FakeIcebergRestServer(root)
            cat = ice.RestCatalog(srv.uri(), ["db"], "t")
        else:
            cat = ice.FilesystemCatalog(os.path.join(root, "db", "t"))
        try:
            w = ice.IcebergWriter(None, ["k", "v", "j"], {"k": dt.INT, "v": dt.FLOAT, "j": dt.JSON},
                                  catalog=cat)
            Json = _mod(name, "engine.value").Json
            for t, batch in enumerate([[(1, 0.5, Json({"a": 1})), (2, -0.25, Json([1]))],
                                       [(3, 1.5, Json(None))], [(1, 0.5, Json({"a": 1}))]]):
                for row in batch:
                    w.on_change(None, row, t, -1 if t == 2 else 1)
                w.on_time_end(t)
            files = _tree(root)
            got[name] = (files, srv.requests if srv else None,
                         srv.tables["db.t"] if srv else None)
        finally:
            if srv is not None:
                srv.close()
    assert got["torch"][0].keys() == got["jax"][0].keys()
    for path in got["torch"][0]:
        assert got["torch"][0][path] == got["jax"][0][path], path
    assert got["torch"][1:] == got["jax"][1:]
    assert sum(p.endswith(".parquet") for p in got["torch"][0]) == 3


def test_iceberg_manifests_are_avro_with_the_spec_field_ids(tmp_path):
    pw = tpw
    avro = _mod("torch", "io._avro")
    pw.io.iceberg.write(pw.debug.table_from_rows(pw.schema_from_types(a=int, b=str),
                                                 [(i, f"s{i}") for i in range(4)]),
                        tmp_path / "wh", ["db"], "tab")
    pw.run()
    loc = tmp_path / "wh" / "db" / "tab"
    version = int((loc / "metadata" / "version-hint.text").read_text())
    assert version == 2
    metadata = json.loads((loc / "metadata" / f"v{version}.metadata.json").read_text())
    assert [f["name"] for f in metadata["schemas"][0]["fields"]] == ["a", "b", "time", "diff"]
    schema, manifests, fmeta = avro.read_container(str(loc / metadata["snapshots"][-1]["manifest-list"]))
    ids = {f["name"]: f.get("field-id") for f in schema["fields"]}
    assert (ids["manifest_path"], ids["manifest_length"], ids["added_snapshot_id"],
            ids["sequence_number"], ids["content"]) == (500, 501, 503, 515, 517)
    (m,) = manifests
    assert m["manifest_length"] == (loc / m["manifest_path"]).stat().st_size
    eschema, (entry,), emeta = avro.read_container(str(loc / m["manifest_path"]))
    assert emeta["format-version"] == "2" and emeta["content"] == "data"
    df = {f["name"]: f.get("field-id") for f in next(
        f for f in eschema["fields"] if f["name"] == "data_file")["type"]["fields"]}
    assert (df["file_path"], df["record_count"], df["content"]) == (100, 103, 134)
    assert entry["status"] == 1 and entry["data_file"]["record_count"] == 4
    assert (loc / entry["data_file"]["file_path"]).exists()


@pytest.mark.parametrize("catalog", ["filesystem", "rest"])
def test_iceberg_streaming_readers_see_each_snapshot_once_alike(tmp_path, catalog):
    """A JAX-package writer commits while both packages' streaming readers poll: each
    snapshot's rows arrive once, in order; the readers' states are equal and a reader
    restored from one reads nothing again."""
    jice, jdt = _mod("jax", "io.iceberg"), _mod("jax", "internals.dtype")
    srv = None
    loc = str(tmp_path / "t")

    def catalog_of(name):
        if srv is None:
            return None
        return _mod(name, "io.iceberg").RestCatalog(srv.uri(), ["db"], "t")

    if catalog == "rest":
        srv = _mod("torch", "io._iceberg_rest").FakeIcebergRestServer(str(tmp_path / "wh"))
    try:
        w = jice.IcebergWriter(loc if srv is None else None, ["w", "n"],
                               {"w": jdt.STR, "n": jdt.INT}, catalog=catalog_of("jax"))
        readers = {name: _mod(name, "io.iceberg").IcebergReader(
            loc if srv is None else None, ["w", "n"], "streaming", catalog=catalog_of(name))
            for name in PACKAGES}
        got = {name: [] for name in PACKAGES}
        for t, batch in enumerate([[("a", 1)], [("b", 2), ("c", 3)], [], [("d", 4)]]):
            for row in batch:
                w.on_change(None, row, t, 1)
            w.on_time_end(t)
            if t == 1:
                w.on_change(None, ("e", 5), 9, 1)
                w.on_time_end(9)  # two snapshots between polls
            for name, r in readers.items():
                entries, done = r.poll()
                assert not done
                got[name].append(_rows_of(entries))
        assert got["torch"] == got["jax"]
        assert [[v for _k, v in step] for step in got["torch"]] == [
            [("a", 1)], [("b", 2), ("c", 3), ("e", 5)], [], [("d", 4)]]
        assert readers["torch"].state() == readers["jax"].state() == {"seen_seq": 4}
        again = _mod("torch", "io.iceberg").IcebergReader(
            loc if srv is None else None, ["w", "n"], "streaming", catalog=catalog_of("torch"))
        again.restore_state(readers["jax"].state())
        assert again.poll() == ([], False)
    finally:
        if srv is not None:
            srv.close()


def test_iceberg_retractions_need_a_primary_key_in_both(tmp_path):
    jice, jdt = _mod("jax", "io.iceberg"), _mod("jax", "internals.dtype")
    loc = str(tmp_path / "t")
    w = jice.IcebergWriter(loc, ["k", "v"], {"k": jdt.INT, "v": jdt.STR})
    w.on_change(None, (1, "x"), 0, 1)
    w.on_change(None, (2, "y"), 0, 1)
    w.on_time_end(0)
    w.on_change(None, (1, "x"), 1, -1)
    w.on_time_end(1)
    for name, pw in PACKAGES.items():
        with pytest.raises(ValueError, match="primary_key"):
            _mod(name, "io.iceberg").IcebergReader(loc, ["k", "v"], "static").poll()

        class S(pw.Schema):
            k: int = pw.column_definition(primary_key=True)
            v: str

        (snap,) = _mod(name, "internals.runner").GraphRunner().capture(
            pw.io.iceberg.read(loc, schema=S, mode="static"))
        assert sorted(snap.values()) == [(2, "y")]


def test_iceberg_concurrent_rest_writers_conflict_and_requeue(tmp_path):
    """Two writers commit on one head: the loser's commit raises 409 on its thread, its
    rows stay queued, and its next commit lands them."""
    ice = _mod("torch", "io.iceberg")
    rest = _mod("torch", "io._iceberg_rest")
    srv = rest.FakeIcebergRestServer(str(tmp_path / "wh"))
    try:
        writers = [ice.IcebergWriter(None, ["k", "v"], {}, catalog=ice.RestCatalog(srv.uri(), ["db"], "t"))
                   for _ in range(2)]
        loads = [w.catalog.load for w in writers]
        gate = threading.Barrier(2)

        def load_then_wait(i):
            def load():
                out = loads[i]()
                gate.wait(10)  # both read the same head before either commits
                return out
            return load

        for i, w in enumerate(writers):
            w.catalog.load = load_then_wait(i)
            w.on_change(None, (i, f"row{i}"), 0, 1)
        errors: list = []

        def flush(w):
            try:
                w.on_time_end(0)
            except rest.IcebergRestError as exc:
                errors.append(exc)

        threads = [threading.Thread(target=flush, args=(w,)) for w in writers]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert [e.code for e in errors] == [409] and srv.conflicts == 1
        (loser,) = [w for w in writers if w._rows]
        loser.catalog.load = loads[writers.index(loser)]
        loser.on_time_end(0)
        assert not loser._rows
        for name in PACKAGES:
            reader = _mod(name, "io.iceberg").IcebergReader(
                None, ["k", "v"], "static",
                catalog=_mod(name, "io.iceberg").RestCatalog(srv.uri(), ["db"], "t"))
            entries, done = reader.poll()
            assert done and sorted(v for _k, v in _rows_of(entries)) == [(0, "row0"), (1, "row1")]
    finally:
        srv.close()


@pytest.mark.parametrize("name", ["torch", "jax"])
def test_iceberg_filesystem_commit_loses_cleanly(tmp_path, name):
    """A writer whose version was published meanwhile raises FileExistsError, keeps its
    rows, and lands them at its next commit over the new head."""
    ice, dt = _mod(name, "io.iceberg"), _mod(name, "internals.dtype")
    loc = str(tmp_path / "t")
    a = ice.IcebergWriter(loc, ["w"], {"w": dt.STR})
    b = ice.IcebergWriter(loc, ["w"], {"w": dt.STR})
    stale = a.catalog.load()
    b.on_change(None, ("b",), 0, 1)
    b.on_time_end(0)
    a.catalog.load = lambda: (stale[0], json.loads(json.dumps(stale[1])))
    a.on_change(None, ("a",), 0, 1)
    with pytest.raises(FileExistsError):
        a.on_time_end(0)
    assert a._rows and not [f for f in os.listdir(os.path.join(loc, "metadata")) if ".tmp-" in f]
    del a.catalog.load
    a.on_time_end(1)
    entries, _done = _mod("torch", "io.iceberg").IcebergReader(loc, ["w"], "static").poll()
    assert sorted(v for _k, v in _rows_of(entries)) == [("a",), ("b",)]


def test_iceberg_types_and_refusals_match():
    for name, pw in PACKAGES.items():
        ice, dt = _mod(name, "io.iceberg"), _mod(name, "internals.dtype")
        types = [ice._iceberg_type(d) for d in (dt.INT, dt.FLOAT, dt.BOOL, dt.BYTES, dt.STR,
                                                dt.JSON, dt.wrap(int | None), dt.ANY,
                                                dt.DATE_TIME_NAIVE, dt.POINTER)]
        assert types == ["long", "double", "boolean", "binary", "string", "string", "long",
                         "string", "string", "string"]
        t = pw.debug.table_from_rows(pw.schema_from_types(a=int), [(1,)])
        with pytest.raises(NotImplementedError, match="REST"):
            pw.io.iceberg.write(t, "s3://bucket/warehouse", ["ns"], "t")
        with pytest.raises(ValueError, match="schema"):
            pw.io.iceberg.read("/tmp")
        with pytest.raises(ValueError, match="both namespace and table_name"):
            pw.io.iceberg.write(t, "/tmp", ["ns"])
        with pytest.raises(ValueError, match="REST catalogs need"):
            pw.io.iceberg._rest_catalog_factory("http://x", None, None, {})


def test_iceberg_streaming_read_through_pw_run_over_rest(tmp_path):
    """``pw.io.iceberg.read(mode="streaming")`` over the REST catalog through ``pw.run``
    while an outside writer commits: every committed row arrives once, retractions
    included, and the run ends when the reader reports done."""
    ice, dt = _mod("torch", "io.iceberg"), _mod("torch", "internals.dtype")
    srv = _mod("torch", "io._iceberg_rest").FakeIcebergRestServer(str(tmp_path / "wh"))
    try:
        w = ice.IcebergWriter(None, ["id", "k"], {"id": dt.INT, "k": dt.INT},
                              catalog=ice.RestCatalog(srv.uri(), ["db"], "t"))
        batches = [[((i, i % 3), 1) for i in range(6)], [((0, 0), -1), ((0, 2), 1)], [((5, 2), -1)]]
        polls = {"n": 0}
        poll = ice.IcebergReader.poll

        def paced(self):
            if polls["n"] < len(batches):
                for row, diff in batches[polls["n"]]:
                    w.on_change(None, row, polls["n"], diff)
                w.on_time_end(polls["n"])
            polls["n"] += 1
            entries, _done = poll(self)
            return entries, polls["n"] > len(batches)

        ice.IcebergReader.poll = paced
        try:
            class S(tpw.Schema):
                id: int = tpw.column_definition(primary_key=True)
                k: int

            t = tpw.io.iceberg.read(srv.uri(), ["db"], "t", schema=S, mode="streaming",
                                    autocommit_duration_ms=None)
            g = t.groupby(t.k).reduce(t.k, c=tpw.reducers.count())
            (snap,) = _mod("torch", "internals.runner").GraphRunner().capture(g)
        finally:
            ice.IcebergReader.poll = poll
        assert sorted(snap.values()) == [(0, 1), (1, 2), (2, 2)]
    finally:
        srv.close()


# -- Airbyte ----------------------------------------------------------------------------------

_SOURCE = textwrap.dedent(
    """
    import argparse, json, sys

    CATALOG = {"streams": [
        {"name": "users", "json_schema": {"type": "object"},
         "supported_sync_modes": ["full_refresh", "incremental"]},
        {"name": "events", "json_schema": {"type": "object"},
         "supported_sync_modes": ["full_refresh"]},
    ]}

    p = argparse.ArgumentParser()
    p.add_argument("command")
    p.add_argument("--config")
    p.add_argument("--catalog")
    p.add_argument("--state")
    a = p.parse_args()
    if a.command == "spec":
        print(json.dumps({"type": "SPEC", "spec": {"connectionSpecification": {}}}))
    elif a.command == "check":
        print(json.dumps({"type": "CONNECTION_STATUS", "connectionStatus": {"status": "SUCCEEDED"}}))
    elif a.command == "discover":
        print(json.dumps({"type": "CATALOG", "catalog": CATALOG}))
    elif a.command == "read":
        config = json.load(open(a.config))
        rows = json.load(open(config["rows_file"]))
        cursor = json.load(open(a.state)).get("cursor", 0) if a.state else 0
        print("a log line that is not JSON")
        streams = [s["stream"]["name"] for s in json.load(open(a.catalog))["streams"]]
        for row in rows:
            if row["id"] > cursor:
                for stream in streams:
                    print(json.dumps({"type": "RECORD", "record": {
                        "stream": stream, "data": row, "emitted_at": 0}}))
        if config.get("per_stream_state"):
            for stream in streams:
                print(json.dumps({"type": "STATE", "state": {"type": "STREAM", "stream": {
                    "stream_descriptor": {"name": stream},
                    "stream_state": {"cursor": rows[-1]["id"] if rows else cursor}}}}))
        else:
            print(json.dumps({"type": "STATE", "state": {"data": {
                "cursor": rows[-1]["id"] if rows else cursor}}}))
    """
)


@pytest.fixture()
def source(tmp_path):
    """(the script, the config file, the rows file) of an Airbyte-protocol source whose
    ``users`` stream reads the rows file past the STATE's cursor."""
    script = tmp_path / "source.py"
    script.write_text(_SOURCE)
    rows = tmp_path / "rows.json"
    rows.write_text(json.dumps([{"id": i, "name": n} for i, n in enumerate(["ann", "bob", "cid"], 1)]))
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"source": {"exec": f"{sys.executable} {script}",
                                          "config": {"rows_file": str(rows)}}}))
    return str(script), str(cfg), rows


def test_airbyte_protocol_calls_give_the_same_answers(source):
    script, _cfg, rows = source
    got = {}
    for name in PACKAGES:
        src = _mod(name, "io.airbyte").ExecutableAirbyteSource(
            [sys.executable, script], {"rows_file": str(rows)}, ["users"])
        records, state = src.extract()
        again, state2 = src.extract(state)
        got[name] = (src.check(), src.spec(), src.configured_catalog, records, state, again, state2)
    assert got["torch"] == got["jax"]
    check, spec, catalog, records, state, again, state2 = got["torch"]
    assert check and "connectionSpecification" in spec
    assert catalog["streams"][0]["sync_mode"] == "incremental"
    assert [r["data"]["id"] for r in records] == [1, 2, 3] and state == {"cursor": 3}
    assert again == [] and state2 == {"cursor": 3}


def test_airbyte_per_stream_states_accumulate_alike(source, tmp_path):
    script, _cfg, rows = source
    got = {}
    for name in PACKAGES:
        src = _mod(name, "io.airbyte").ExecutableAirbyteSource(
            [sys.executable, script], {"rows_file": str(rows), "per_stream_state": True},
            ["users", "events"])
        got[name] = src.extract()
    assert got["torch"] == got["jax"]
    records, state = got["torch"]
    assert len(records) == 6 and [s["stream"]["stream_descriptor"]["name"] for s in state] == [
        "users", "events"]


def test_airbyte_reads_the_same_rows_and_state_through_pw_run(source):
    """Two incremental syncs through ``pw.io.airbyte.read``'s reader: the same JSON rows
    and the same STATE in both packages; the second sync reads only the new rows."""
    _script, cfg, rows = source
    got = {}
    for name, pw in PACKAGES.items():
        rows.write_text(json.dumps([{"id": i, "name": n} for i, n in enumerate(["ann", "bob", "cid"], 1)]))
        t = pw.io.airbyte.read(cfg, ["users"], mode="streaming", refresh_interval_ms=0)
        runner = _mod(name, "internals.runner").GraphRunner()
        node = runner.build(t)
        updates: list = []
        runner.scope.subscribe_table(node, on_change=lambda key, row, time, diff: updates.append(
            (json.dumps(row[0].value, sort_keys=True), diff)))
        sched = _mod(name, "engine.graph").Scheduler(runner.scope)
        (driver,) = runner.drivers
        states = []
        for extra in ([], [{"id": 4, "name": "dan"}, {"id": 5, "name": "eve"}]):
            data = json.loads(rows.read_text()) + extra
            rows.write_text(json.dumps(data))
            driver.poll()
            sched.commit()
            states.append(driver.reader.state())
        got[name] = (sorted(updates), states)
    assert got["torch"] == got["jax"]
    updates, states = got["torch"]
    assert [json.loads(u)["name"] for u, _d in updates] == ["ann", "bob", "cid", "dan", "eve"]
    assert states == [{"airbyte_state": {"cursor": 3}}, {"airbyte_state": {"cursor": 5}}]


def test_airbyte_full_refresh_is_one_replacing_payload_in_both(source):
    script, _cfg, rows = source
    got = {}
    for name in PACKAGES:
        ab = _mod(name, "io.airbyte")
        src = ab.ExecutableAirbyteSource([sys.executable, script], {"rows_file": str(rows)}, ["users"])
        for s in src.discover()["streams"]:
            s["supported_sync_modes"] = ["full_refresh"]
        reader = ab._AirbyteReader(src, "static", 0.0)
        entries, done = reader.poll()
        got[name] = (reader.replaces_sources, entries, done)
        with pytest.raises(ValueError, match="share a sync_mode"):
            ab._AirbyteReader(ab.ExecutableAirbyteSource(
                [sys.executable, script], {"rows_file": str(rows)}, ["users", "events"]), "static", 0.0)
        with pytest.raises(ValueError, match="not in the source catalog"):
            ab.ExecutableAirbyteSource([sys.executable, script], {}, ["nope"]).configured_catalog
    assert got["torch"] == got["jax"]
    replaces, entries, done = got["torch"]
    assert replaces and done and len(entries) == 1
    payload, source_id, meta = entries[0]
    assert source_id == "airbyte:users" and [r["data"]["id"] for r in payload] == [1, 2, 3]


def test_airbyte_state_restored_by_persistence_resumes_the_cursor(source, tmp_path):
    """A persisted read stops after its first sync; the run restarted over the same
    store resumes the sync from the STATE it kept: only the new rows are read, in both
    packages alike."""
    _script, cfg, rows = source
    got = {}
    for name, pw in PACKAGES.items():
        rows.write_text(json.dumps([{"id": i, "name": n} for i, n in enumerate(["ann", "bob", "cid"], 1)]))
        store = str(tmp_path / f"store-{name}")
        runs = []
        for extra in ([], [{"id": 4, "name": "dan"}]):
            rows.write_text(json.dumps(json.loads(rows.read_text()) + extra))
            (TG if pw is tpw else JG).clear()
            t = pw.io.airbyte.read(cfg, ["users"], mode="static", persistent_id="ab")
            seen: list = []
            pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: seen.append(
                (row["data"].value["name"], is_addition)))
            pw.run(persistence_config=pw.persistence.Config(pw.persistence.Backend.filesystem(store)))
            runs.append(sorted(seen))
        got[name] = runs
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [("ann", True), ("bob", True), ("cid", True)]
    assert ("dan", True) in got["torch"][1] and got["torch"][1].count(("ann", True)) <= 1


def test_airbyte_preinstalled_venv_and_refusals(source, tmp_path):
    script, _cfg, rows = source
    venv = tmp_path / "venv"
    (venv / "bin").mkdir(parents=True)
    exe = venv / "bin" / "source-fixture"
    exe.write_text(f"#!{sys.executable}\n" + _SOURCE)
    exe.chmod(0o755)
    cfg = tmp_path / "plain.json"
    cfg.write_text(json.dumps({"rows_file": str(rows)}))
    got = {}
    for name, pw in PACKAGES.items():
        t = pw.io.airbyte.read(str(cfg), ["users"], mode="static", execution_type="venv",
                               connector_name="source-fixture", venv_path=str(venv))
        (snap,) = _mod(name, "internals.runner").GraphRunner().capture(t)
        got[name] = sorted(r[0].value["name"] for r in snap.values())
        with pytest.raises(ValueError, match="connector_name"):
            pw.io.airbyte.read(str(cfg), ["users"], execution_type="venv")
        with pytest.raises(NotImplementedError, match="docker"):
            pw.io.airbyte.read(str(cfg), ["users"], execution_type="docker")
        with pytest.raises(ValueError, match="no connector command"):
            pw.io.airbyte.read(str(cfg), ["users"])
    assert got["torch"] == got["jax"] == ["ann", "bob", "cid"]


def test_airbyte_venv_install_offline_error_names_the_offline_options(tmp_path):
    """``pip install`` with ``--no-index`` and an empty wheel directory (no package index
    is reached) fails with an error that names the offline options."""
    empty = tmp_path / "no-wheels"
    empty.mkdir()
    with pytest.raises(RuntimeError) as err:
        _mod("torch", "io.airbyte").venv_connector_command(
            "source-nonexistent-fixture", venv_path=str(tmp_path / "v"),
            pip_extra_args=["--no-index", "--find-links", str(empty)])
    msg = str(err.value)
    assert "--find-links" in msg and "connector_command=" in msg and "venv_path=" in msg


def test_airbyte_config_files_and_records_replay_alike(tmp_path):
    yaml_cfg = tmp_path / "c.yaml"
    yaml_cfg.write_text("source:\n  exec: python -m source_x --flag\n  config:\n    api_key: k\n")
    got = {}
    for name, pw in PACKAGES.items():
        ab = _mod(name, "io.airbyte")
        t = ab.read_records([{"a": 1, "b": "x"}, {"a": 2}], stream="s")
        (snap,) = _mod(name, "internals.runner").GraphRunner().capture(t)
        got[name] = (ab._load_config(str(yaml_cfg)), sorted(snap.values(), key=repr))
        with pytest.raises(ValueError, match="no records"):
            ab.read_records([])
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == ({"api_key": "k"}, ["python", "-m", "source_x", "--flag"])


# -- license and SharePoint -------------------------------------------------------------------

KEYS = [None, "", "pathway-tpu:", "pathway-tpu:xpack-sharepoint", "pathway-tpu:unlimited-workers",
        "pathway-tpu: unlimited-workers , xpack-sharepoint", "other-vendor:xpack-sharepoint"]


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the outcome is what is compared
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("key", KEYS)
def test_license_keys_give_the_same_answers(key, monkeypatch):
    if key is None:
        monkeypatch.delenv("PATHWAY_LICENSE_KEY", raising=False)
    else:
        monkeypatch.setenv("PATHWAY_LICENSE_KEY", key)
    got = {}
    for name in PACKAGES:
        lic = _mod(name, "internals.license")
        got[name] = [_outcome(lambda: lic.check_entitlements(lic.ENTITLEMENT_XPACK_SHAREPOINT)),
                     _outcome(lambda: lic.check_entitlements()),
                     *[_outcome(lambda n=n: lic.check_worker_count(n)) for n in (1, 8, 9, 64)]]
    assert got["torch"] == got["jax"]


def test_set_license_key_overrides_the_environment_alike(monkeypatch):
    """``pw.set_license_key`` wins over ``PATHWAY_LICENSE_KEY``, a key or None alike; each
    package runs in a context of its own, so the key set there does not outlive it."""
    monkeypatch.setenv("PATHWAY_LICENSE_KEY", "pathway-tpu:unlimited-workers")
    got = {}
    for name, pw in PACKAGES.items():
        lic = _mod(name, "internals.license")

        def answers():
            out = [_outcome(lambda: lic.check_entitlements(lic.ENTITLEMENT_XPACK_SHAREPOINT))]
            pw.set_license_key("pathway-tpu:xpack-sharepoint")
            out.append(_outcome(lambda: lic.check_entitlements(lic.ENTITLEMENT_XPACK_SHAREPOINT)))
            out.append(_outcome(lambda: lic.check_worker_count(9)))
            pw.set_license_key(None)
            out.append(_outcome(lambda: lic.check_entitlements(lic.ENTITLEMENT_XPACK_SHAREPOINT)))
            out.append(_outcome(lambda: lic.check_worker_count(9)))
            return out

        got[name] = contextvars.copy_context().run(answers)
        assert _outcome(lambda: lic.check_worker_count(9)) == ("ok", None)  # the context ended
    assert got["torch"] == got["jax"]
    assert [o[0] for o in got["torch"]] == ["LicenseError", "ok", "LicenseError", "LicenseError",
                                            "LicenseError"]


@pytest.mark.parametrize("key", [None, "pathway-tpu:xpack-sharepoint", "pathway-tpu:unlimited-workers"])
def test_sharepoint_reads_the_same_rows_or_raises_alike(key, monkeypatch):
    if key is None:
        monkeypatch.delenv("PATHWAY_LICENSE_KEY", raising=False)
    else:
        monkeypatch.setenv("PATHWAY_LICENSE_KEY", key)
    got = {}
    for name in PACKAGES:
        sp = importlib.import_module(f"{PACKAGES[name].__name__}.xpacks.connectors.sharepoint")
        store = _mod(name, "engine.storage").DictObjectStore()
        store.put_object("docs/a.txt", b"hello sharepoint")
        store.put_object("docs/b.bin", b"\x00\x01")
        store.put_object("other/c.txt", b"no")

        def run():
            t = sp.read("https://site", root_path="docs/", mode="static", client=store,
                        with_metadata=True)
            (snap,) = _mod(name, "internals.runner").GraphRunner().capture(t)
            return sorted((r[0], r[1].value["path"]) for r in snap.values())

        got[name] = [_outcome(run), _outcome(lambda: sp.read("https://site"))]
    assert got["torch"] == got["jax"]
    if key == "pathway-tpu:xpack-sharepoint":
        assert got["torch"][0] == ("ok", [(b"\x00\x01", "docs/b.bin"), (b"hello sharepoint", "docs/a.txt")])
        assert got["torch"][1][0] == "ValueError"
    else:
        assert got["torch"][0][0] == "LicenseError"
