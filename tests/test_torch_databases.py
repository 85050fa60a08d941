"""The database connectors of the port against the JAX package's, on the same inputs:
Postgres (the v3 wire client and server, ``pw.io.postgres.write`` and
``write_snapshot``), MongoDB (the BSON codec, the OP_MSG client and server,
``pw.io.mongodb.write``), Elasticsearch (the ``_bulk`` client and server, its three
authorization headers, ``pw.io.elasticsearch.write``), BigQuery's ``insertAll`` client,
Slack's alerts and ``engine/storage.py``'s database writers.

Each package's client talks to the other package's server, and to its own; the bytes
each package puts on the wire for the same values (text params, BSON, NDJSON bodies)
and the statements and documents its writers produce for the same seeded change
stream are compared exactly, floats by their bits and Pointer keys by their spelling.
"""

from __future__ import annotations

import base64
import importlib
import json
import os
import socket
import ssl
import struct
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch.engine import device_ops as dops
from pathway_tpu_torch.internals.parse_graph import G as TG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"torch": tpw, "jax": jpw}
#: (client's package, server's package): the port against itself and across
PAIRS = [("torch", "torch"), ("torch", "jax"), ("jax", "torch")]


@pytest.fixture(autouse=True)
def _clean():
    dops.configure(device="cpu")
    TG.clear()
    JG.clear()
    yield
    TG.clear()
    JG.clear()
    dops.configure()


def _mod(name: str, module: str):
    return importlib.import_module(f"{PACKAGES[name].__name__}.{module}")


def _canon(v):
    """A value both packages spell alike: floats by their bits, Json by its value."""
    if type(v).__name__ == "Json":
        return ("json", json.dumps(v.value, sort_keys=True))
    if isinstance(v, float):
        return ("f", np.float64(v).view(np.int64).item())
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _canon(x)) for k, x in v.items()))
    return v


# -- Postgres: the text params ------------------------------------------------------------

TEXT_VALUES = [None, True, False, 7, -(1 << 62), 2.5, -0.1, 1e-300, "héllo wörld", "",
               b"\x00\x01\xff", [1, None, 'a"b\\c'], (2.5, "x")]


@pytest.mark.parametrize("value", TEXT_VALUES, ids=[repr(v) for v in TEXT_VALUES])
def test_text_params_are_the_same_bytes(value):
    enc = {n: _mod(n, "io._pg_wire").encode_text_param(value) for n in PACKAGES}
    assert enc["torch"] == enc["jax"]
    dec = {n: _mod(n, "io._pg_wire").decode_text_param(enc[n]) for n in PACKAGES}
    assert _canon(dec["torch"]) == _canon(dec["jax"])


# -- Postgres: each client against each server ----------------------------------------------


def _pg(client: str, server: str, **server_kwargs):
    srv = _mod(server, "io._pg_wire").FakePostgresServer(**server_kwargs)
    return _mod(client, "io._pg_wire"), srv


@pytest.mark.parametrize("auth", ["trust", "password", "md5", "scram-sha-256"])
@pytest.mark.parametrize("client,server", PAIRS)
def test_pg_startup_and_auth(client, server, auth):
    password = None if auth == "trust" else "s3cret"
    wire, srv = _pg(client, server, password=password, auth=auth)
    try:
        conn = wire.PgWireConnection(port=srv.port, user="u", password=password, dbname="d")
        conn.execute("INSERT INTO t (a) VALUES ($1)", [1])
        conn.commit()
        conn.close()
        assert srv.snapshot("t") == [{"a": 1}]
    finally:
        srv.close()


@pytest.mark.parametrize("auth", ["password", "md5", "scram-sha-256"])
@pytest.mark.parametrize("client,server", PAIRS)
def test_pg_wrong_password_is_refused(client, server, auth):
    wire, srv = _pg(client, server, password="s3cret", auth=auth)
    try:
        with pytest.raises(wire.PgError, match="password"):
            wire.PgWireConnection(port=srv.port, user="u", password="nope")
        with pytest.raises(wire.PgError, match="requires a password"):
            wire.PgWireConnection(port=srv.port, user="u")
    finally:
        srv.close()


@pytest.mark.parametrize("client,server", PAIRS)
def test_pg_extended_frames_and_staging_until_commit(client, server):
    wire, srv = _pg(client, server)
    try:
        conn = wire.PgWireConnection(port=srv.port)
        conn.execute("INSERT INTO t (a,b) VALUES ($1,$2)", [1, "x"])
        assert srv.snapshot("t") == []  # staged, not yet visible
        conn.execute("INSERT INTO t (a,b) VALUES ($1,$2)", [2, None])
        assert srv.snapshot("t") == []
        conn.commit()
        conn.close()
        assert srv.snapshot("t") == [{"a": 1, "b": "x"}, {"a": 2, "b": None}]
        assert "PBESPBES" in "".join(srv.frames)  # each statement as Parse/Bind/Execute/Sync
        assert srv.statements[0] == "BEGIN" and srv.statements[-1] == "COMMIT"
        assert srv.commits == 1
    finally:
        srv.close()


@pytest.mark.parametrize("client,server", PAIRS)
def test_pg_param_types_roundtrip(client, server):
    wire, srv = _pg(client, server)
    try:
        conn = wire.PgWireConnection(port=srv.port)
        conn.execute("INSERT INTO t (i,f,b,s,n,y) VALUES ($1,$2,$3,$4,$5,$6)",
                     [7, 2.5, True, "hi there", None, b"\x00\xff"])
        conn.commit()
        conn.close()
        assert srv.snapshot("t") == [{"i": 7, "f": 2.5, "b": True, "s": "hi there", "n": None,
                                      "y": b"\x00\xff"}]
    finally:
        srv.close()


@pytest.mark.parametrize("client,server", PAIRS)
def test_pg_statement_error_rolls_back_and_raises(client, server):
    """A failed statement rolls its transaction back (the rows before it are lost), the
    error raises, and the next transaction works."""
    wire, srv = _pg(client, server)
    try:
        conn = wire.PgWireConnection(port=srv.port)
        conn.execute("INSERT INTO t (a) VALUES ($1)", [1])
        with pytest.raises(wire.PgError, match="unsupported statement"):
            conn.execute("TRUNCATE t", [])
        assert "ROLLBACK" in srv.statements
        conn.commit()  # nothing open: no COMMIT is sent
        assert srv.snapshot("t") == [] and srv.commits == 0
        conn.execute("INSERT INTO t (a) VALUES ($1)", [2])
        conn.commit()
        conn.close()
        assert srv.snapshot("t") == [{"a": 2}]
    finally:
        srv.close()


@pytest.mark.parametrize("client,server", PAIRS)
def test_pg_sslmode_require_refused_prefer_falls_back(client, server):
    wire, srv = _pg(client, server)
    try:
        with pytest.raises(wire.PgError, match="sslmode=require"):
            wire.PgWireConnection(port=srv.port, sslmode="require")
        for mode in ("prefer", "disable"):
            conn = wire.PgWireConnection(port=srv.port, sslmode=mode)
            conn.execute("INSERT INTO t (a) VALUES ($1)", [9])
            conn.commit()
            conn.close()
        assert srv.snapshot("t") == [{"a": 9}, {"a": 9}]
        with pytest.raises(wire.PgError, match="unsupported sslmode"):
            wire.PgWireConnection(port=srv.port, sslmode="verify-ca")
    finally:
        srv.close()


@pytest.mark.parametrize("server", ["torch", "jax"])
def test_pg_server_refuses_statements_in_an_aborted_transaction(server):
    """Raw frames from the port's helpers: after an error the server refuses every
    statement until the transaction ends, and its COMMIT is a rollback."""
    wire = _mod("torch", "io._pg_wire")
    srv = _mod(server, "io._pg_wire").FakePostgresServer()
    sock = socket.create_connection(("127.0.0.1", srv.port))
    try:
        payload = struct.pack(">I", 196608) + wire._cstr("user") + wire._cstr("u") + b"\0"
        sock.sendall(struct.pack(">I", len(payload) + 4) + payload)
        reader = wire._FrameReader(sock)

        def until_ready() -> list:
            tags = []
            while True:
                tag, _body = reader.read_message()
                tags.append(tag)
                if tag == b"Z":
                    return tags

        def extended(stmt: str) -> list:
            parse = wire._cstr("") + wire._cstr(stmt) + struct.pack(">H", 0)
            bind = wire._cstr("") + wire._cstr("") + struct.pack(">HHH", 0, 0, 0)
            execute = wire._cstr("") + struct.pack(">i", 0)
            sock.sendall(wire._frame(b"P", parse) + wire._frame(b"B", bind)
                         + wire._frame(b"E", execute) + wire._frame(b"S", b""))
            return until_ready()

        until_ready()
        sock.sendall(wire._frame(b"Q", wire._cstr("BEGIN")))
        until_ready()
        assert b"C" in extended("INSERT INTO t (a) VALUES (1)")
        assert b"E" in extended("TRUNCATE t")
        tags = extended("INSERT INTO t (a) VALUES (2)")
        assert b"E" in tags and b"C" not in tags
        sock.sendall(wire._frame(b"Q", wire._cstr("COMMIT")))
        until_ready()
        assert srv.snapshot("t") == [] and srv.commits == 0
    finally:
        sock.close()
        srv.close()


@pytest.fixture(scope="module")
def tls_cert(tmp_path_factory):
    d = tmp_path_factory.mktemp("tls")
    cert, key = d / "cert.pem", d / "key.pem"
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", str(key),
                    "-out", str(cert), "-days", "1", "-nodes", "-subj", "/CN=127.0.0.1"],
                   check=True, capture_output=True, timeout=60)
    return str(cert), str(key)


@pytest.fixture()
def tls_server(tls_cert):
    """Answers ``S`` to the SSLRequest, presents a self-signed certificate, and fails a
    client that completed the handshake with a recognisable error."""
    cert, key = tls_cert
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(2)
    srv.settimeout(10.0)

    def serve():
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(cert, key)
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            try:
                conn.settimeout(10.0)
                conn.recv(8)
                conn.sendall(b"S")
                try:
                    tls = ctx.wrap_socket(conn, server_side=True)
                except ssl.SSLError:
                    continue  # the verifying client dropped the handshake
                tls.recv(4096)
                body = b"SFATAL\0Mtls-handshake-ok\0\0"
                tls.sendall(b"E" + struct.pack(">I", len(body) + 4) + body)
                tls.close()
            except OSError:
                pass
            finally:
                conn.close()

    thread = threading.Thread(target=serve)
    thread.start()
    yield srv.getsockname()[1]
    srv.shutdown(socket.SHUT_RDWR)
    srv.close()
    thread.join(10.0)


@pytest.mark.parametrize("client", ["torch", "jax"])
def test_pg_tls_require_accepts_any_certificate_verify_full_checks_it(client, tls_server):
    wire = _mod(client, "io._pg_wire")
    with pytest.raises(wire.PgError, match="tls-handshake-ok"):
        wire.PgWireConnection(port=tls_server, sslmode="require")
    with pytest.raises(ssl.SSLCertVerificationError):
        wire.PgWireConnection(port=tls_server, sslmode="verify-full")


def test_pg_fake_server_stops_its_threads_on_close():
    wire = _mod("torch", "io._pg_wire")
    before = set(threading.enumerate())
    srv = wire.FakePostgresServer()
    conns = [wire.PgWireConnection(port=srv.port) for _ in range(3)]
    conns[0].execute("INSERT INTO t (a) VALUES ($1)", [1])
    srv.close()
    assert set(threading.enumerate()) <= before
    for conn in conns:
        conn.sock.close()


# -- Postgres: the writers ------------------------------------------------------------------


class _Recorder:
    """An executor that records statements, and commits as boundaries."""

    def __init__(self) -> None:
        self.commits: list[list] = [[]]

    def execute(self, statement, params):
        self.commits[-1].append((statement, _canon(list(params))))

    def commit(self):
        self.commits.append([])


def _change_stream(pw, seed: int):
    """A seeded stream of 4 commits of (k, v, meta) rows into ``groupby(k)``, with the
    group's id, sum, count and a Json column: insertions, then revisions."""
    rng = np.random.default_rng(seed)

    class S(pw.Schema):
        k: int
        v: float
        meta: pw.Json

    batches = [[{"k": int(rng.integers(0, 4)), "v": float(rng.integers(-40, 40)) / 8,
                 "meta": pw.Json({"i": i, "tag": "x" * int(rng.integers(0, 3))})}
                for i in range(int(rng.integers(2, 6)))] for _ in range(4)]
    t = pw.debug.StreamGenerator().table_from_list_of_batches(batches, S)
    g = t.groupby(t.k).reduce(t.k, s=pw.reducers.sum(t.v), c=pw.reducers.count(),
                              last=pw.reducers.max(t.meta))
    return g.select(pw.this.k, pw.this.s, pw.this.c, pw.this.last, gid=g.id)


@pytest.mark.parametrize("kind", ["write", "write_snapshot"])
@pytest.mark.parametrize("seed", range(3))
def test_postgres_writers_emit_the_same_statements(seed, kind):
    """A seeded change stream through both packages' ``pw.io.postgres`` over recording
    executors: the same statements and params, commit by commit (Pointer keys and Json
    values spelt alike)."""
    got = {}
    for name, pw in PACKAGES.items():
        rec = _Recorder()
        table = _change_stream(pw, seed)
        if kind == "write":
            pw.io.postgres.write(table, table_name="log", connection=rec)
        else:
            pw.io.postgres.write_snapshot(table, table_name="snap", primary_key=["k"],
                                          connection=rec)
        pw.run()
        got[name] = [sorted(c, key=repr) for c in rec.commits if c]
    assert got["torch"] == got["jax"]
    assert len(got["torch"]) >= 3
    stmts = [s for c in got["torch"] for s, _p in c]
    assert any("^" in repr(p) for c in got["torch"] for _s, p in c)  # a Pointer's spelling
    if kind == "write_snapshot":
        assert any(s.startswith("DELETE FROM snap WHERE k=$1") for s in stmts)


@pytest.mark.parametrize("client,server", PAIRS)
def test_pw_io_postgres_write_over_the_wire(client, server):
    pw = PACKAGES[client]
    srv = _mod(server, "io._pg_wire").FakePostgresServer(password="pw", auth="scram-sha-256")
    try:
        t = pw.debug.table_from_rows(pw.schema_from_types(k=int, v=str),
                                     [(1, "x"), (2, "y"), (3, None)])
        pw.io.postgres.write(t, postgres_settings={"host": "127.0.0.1", "port": srv.port,
                                                   "password": "pw"}, table_name="events")
        pw.run()
        rows = sorted((r["k"], r["v"], r["diff"]) for r in srv.snapshot("events"))
        assert rows == [(1, "x", 1), (2, "y", 1), (3, None, 1)]
        assert srv.commits >= 1 and "PBES" in "".join(srv.frames)
    finally:
        srv.close()


@pytest.mark.parametrize("client,server", PAIRS)
def test_pw_io_postgres_write_snapshot_streams_upserts_over_the_wire(client, server):
    pw = PACKAGES[client]
    srv = _mod(server, "io._pg_wire").FakePostgresServer()
    try:
        class S(pw.Schema):
            k: int
            v: int

        t = pw.debug.StreamGenerator().table_from_list_of_batches(
            [[{"k": 1, "v": 10}, {"k": 2, "v": 20}], [{"k": 1, "v": 5}], [{"k": 3, "v": -1}]], S)
        agg = t.groupby(t.k).reduce(k=t.k, total=pw.reducers.sum(t.v))
        pw.io.postgres.write_snapshot(agg, postgres_settings={"port": srv.port},
                                      table_name="snap", primary_key=["k"])
        pw.run()
        assert sorted((r["k"], r["total"]) for r in srv.snapshot("snap")) == [(1, 15), (2, 20),
                                                                              (3, -1)]
        assert srv.commits >= 3  # a transaction a commit
    finally:
        srv.close()


def test_write_snapshot_needs_a_primary_key_in_both():
    for pw in PACKAGES.values():
        t = pw.debug.table_from_rows(pw.schema_from_types(a=int), [(1,)])
        with pytest.raises(ValueError, match="primary_key"):
            pw.io.postgres.write_snapshot(t, table_name="x", connection=object())


def test_psycopg2_adapter_renders_the_same_statements():
    got = {}
    for name in PACKAGES:
        executed = []

        class _Cursor:
            def execute(self, stmt, named):
                executed.append(stmt % {k: repr(v) for k, v in named.items()})

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

        class _Conn:
            def cursor(self):
                return _Cursor()

            def commit(self):
                executed.append("COMMIT")

        adapter = _mod(name, "io.postgres").psycopg2_adapter(_Conn())
        fmt = _mod(name, "engine.formats").PsqlSnapshotFormatter("s", ["id"], ["id", "name"])
        for values, diff in (((1, "x"), 1), ((1, "x"), -1)):
            adapter.execute(*fmt.format(None, values, 2, diff))
        adapter.commit()
        got[name] = executed
    assert got["torch"] == got["jax"]
    assert "$" not in got["torch"][0] and "%(" not in got["torch"][0]
    assert got["torch"][-1] == "COMMIT"


# -- MongoDB --------------------------------------------------------------------------------

BSON_DOCS = [
    {"s": "héllo", "i": 42, "big": 1 << 62, "neg": -(1 << 62), "f": 2.5, "t": True,
     "fls": False, "none": None},
    {"bin": b"\x00\x01\xff", "nested": {"a": 1, "b": [1, "two", 3.0]},
     "arr": [True, None, {"x": 1}]},
    {"k": 3, "s": -0.125, "c": 7, "time": 4, "diff": -1},
    {},
]


@pytest.mark.parametrize("doc", BSON_DOCS, ids=range(len(BSON_DOCS)))
def test_bson_is_the_same_bytes(doc):
    enc = {n: _mod(n, "io._mongo_wire").encode_bson(doc) for n in PACKAGES}
    assert enc["torch"] == enc["jax"]
    for n in PACKAGES:
        back, end = _mod(n, "io._mongo_wire").decode_bson(enc["torch"])
        assert back == doc and end == len(enc["torch"])


def test_bson_tags_and_range_errors_are_the_same():
    for n in PACKAGES:
        m = _mod(n, "io._mongo_wire")
        raw = m.encode_bson({"b": True, "i": 1})
        assert b"\x08b\x00" in raw and b"\x12i\x00" in raw
        with pytest.raises(m.MongoError, match="int64"):
            m.encode_bson({"x": 1 << 64})
        # a bare Pointer is an int past int64 in both (the document formatter spells it
        # first): pinned as the reference has it (ROADMAP queue 3)
        with pytest.raises(m.MongoError, match="int64"):
            m.encode_bson({"p": _mod(n, "engine.value").ref_scalar(1)})
        with pytest.raises(m.MongoError, match="unsupported BSON tag"):
            m.decode_bson(struct.pack("<i", 8) + b"\x07a\x00\x00")


@pytest.mark.parametrize("client,server", PAIRS)
def test_mongo_hello_insert_find(client, server):
    wire = _mod(client, "io._mongo_wire")
    srv = _mod(server, "io._mongo_wire").FakeMongoServer()
    try:
        conn = wire.MongoWireClient(port=srv.port, database="db")
        assert conn.server_info["maxWireVersion"] == 17
        conn.insert_many("events", [{"k": 1, "v": "a", "f": 0.5}, {"k": 2, "v": "b", "f": None}])
        assert [(r["k"], r["v"]) for r in conn.find("events")] == [(1, "a"), (2, "b")]
        assert conn.find("events", {"k": 2}) == [{"k": 2, "v": "b", "f": None}]
        assert conn.command({"count": "events", "$db": "db"})["n"] == 2
        with pytest.raises(wire.MongoError, match="CommandNotFound"):
            conn.command({"shutdown": 1, "$db": "admin"})
        conn.close()
        assert srv.commands[:2] == ["hello", "insert"]
        assert srv.snapshot("db.events")[0] == {"k": 1, "v": "a", "f": 0.5}
    finally:
        srv.close()


@pytest.mark.parametrize("client,server", PAIRS)
def test_pw_io_mongodb_write_over_the_wire(client, server):
    pw = PACKAGES[client]
    srv = _mod(server, "io._mongo_wire").FakeMongoServer()
    try:
        t = pw.debug.table_from_rows(pw.schema_from_types(k=int, v=str), [(1, "x"), (2, "y")])
        pw.io.mongodb.write(t, f"mongodb://127.0.0.1:{srv.port}", database="db",
                            collection="events")
        pw.run()
        docs = sorted((d["k"], d["v"], d["diff"]) for d in srv.snapshot("db.events"))
        assert docs == [(1, "x", 1), (2, "y", 1)]
        assert srv.commands.count("insert") == 1  # one insert command a commit
    finally:
        srv.close()


def test_pw_io_mongodb_needs_a_connection_or_a_client_in_both():
    for pw in PACKAGES.values():
        t = pw.debug.table_from_rows(pw.schema_from_types(k=int), [(1,)])
        with pytest.raises(ValueError, match="connection_string and database"):
            pw.io.mongodb.write(t, collection="c")


def test_mongo_fake_server_stops_its_threads_on_close():
    wire = _mod("torch", "io._mongo_wire")
    before = set(threading.enumerate())
    srv = wire.FakeMongoServer()
    conns = [wire.MongoWireClient(port=srv.port) for _ in range(3)]
    srv.close()
    assert set(threading.enumerate()) <= before
    for conn in conns:
        conn.close()


# -- Elasticsearch --------------------------------------------------------------------------


def _bulk_body(name: str, docs: list) -> bytes:
    client = _mod(name, "io._es_wire").EsBulkClient("127.0.0.1:1")
    sent = []
    client._request = lambda method, path, body: sent.append((method, path, body)) or {}
    for index, doc in docs:
        client.index(index, doc)
    client.flush()
    ((method, path, body),) = sent
    assert (method, path) == ("POST", "/_bulk")
    return body


def test_bulk_bodies_are_the_same_bytes():
    docs = [("logs", {"msg": "a", "n": 1, "f": 0.1, "ok": True, "none": None}),
            ("logs", {"msg": "é\n\"", "n": -2, "nested": {"x": [1, 2]}}),
            ("other", {"k": 3, "time": 2, "diff": -1})]
    body = _bulk_body("torch", docs)
    assert body == _bulk_body("jax", docs)
    lines = body.decode().split("\n")
    assert lines[-1] == "" and json.loads(lines[0]) == {"index": {"_index": "logs"}}


@pytest.mark.parametrize("kind,args", [("basic", ("elastic", "pw")), ("bearer", ("tok",)),
                                       ("apikey", ("id1", "key1"))])
def test_auth_headers_are_the_same(kind, args):
    got = {n: getattr(_mod(n, "io._es_wire"), f"auth_header_{kind}")(*args) for n in PACKAGES}
    assert got["torch"] == got["jax"]
    if kind != "bearer":
        assert base64.b64decode(got["torch"].split()[1]).decode() == ":".join(args)


@pytest.mark.parametrize("client,server", PAIRS)
def test_es_bulk_roundtrip_with_basic_auth(client, server):
    wire = _mod(client, "io._es_wire")
    header = wire.auth_header_basic("elastic", "pw")
    srv = _mod(server, "io._es_wire").FakeElasticsearchServer(auth_header=header)
    try:
        bad = wire.EsBulkClient(srv.host())
        bad.index("x", {"a": 1})
        with pytest.raises(wire.EsError, match="401"):
            bad.flush()
        ok = wire.EsBulkClient(srv.host(), auth_header=header, max_batch=3)
        for i in range(4):
            ok.index("logs", {"msg": str(i), "n": i})
        assert srv.bulk_requests == [3]  # max_batch flushed the first three
        ok.flush()
        assert [d["n"] for d in srv.indices["logs"]] == [0, 1, 2, 3]
        assert srv.bulk_requests == [3, 1]
        resp = ok._request("POST", "/_bulk", (json.dumps({"delete": {"_index": "x"}}) + "\n").encode())
        assert resp["errors"] is True
    finally:
        srv.close()


@pytest.mark.parametrize("client,server", PAIRS)
def test_pw_io_elasticsearch_write_over_the_wire(client, server):
    pw = PACKAGES[client]
    srv = _mod(server, "io._es_wire").FakeElasticsearchServer(
        auth_header=_mod(server, "io._es_wire").auth_header_apikey("id", "k"))
    try:
        t = pw.debug.table_from_rows(pw.schema_from_types(k=int, v=str), [(1, "x"), (2, "y")])
        pw.io.elasticsearch.write(t, srv.host(), pw.io.elasticsearch.ElasticSearchAuth.apikey("id", "k"),
                                  index_name="events")
        pw.run()
        assert sorted((d["k"], d["v"], d["diff"]) for d in srv.indices["events"]) == [
            (1, "x", 1), (2, "y", 1)]
        assert len(srv.bulk_requests) == 1  # one _bulk request a commit
    finally:
        srv.close()


def test_es_bulk_item_errors_raise_and_clear_the_buffer_in_both():
    for name in PACKAGES:
        wire = _mod(name, "io._es_wire")
        client = wire.EsBulkClient("127.0.0.1:1")
        client._request = lambda method, path, body: {
            "errors": True, "items": [{"index": {"status": 201}},
                                      {"index": {"status": 400, "error": {"type": "bad"}}}]}
        client.index("x", {"a": 1})
        client.index("x", {"a": 2})
        with pytest.raises(wire.EsError, match="bad"):
            client.flush()
        assert client._buffer == []


# -- the storage writers with injected clients ----------------------------------------------


def test_document_writers_send_the_same_documents():
    got = {}
    for name, pw in PACKAGES.items():
        es_docs, batches = [], []

        class Es:
            def index(self, index_name, document):
                es_docs.append((index_name, _canon(document)))

        class Mongo:
            def insert_many(self, coll, docs):
                batches.append((coll, sorted(_canon(d) for d in docs)))

        table = _change_stream(pw, 5)
        pw.io.elasticsearch.write(table, index_name="idx", client=Es())
        pw.io.mongodb.write(table, collection="col", client=Mongo())
        pw.run()
        got[name] = (sorted(es_docs, key=repr), batches)
    assert got["torch"] == got["jax"]
    assert len(got["torch"][1]) >= 2  # one insert_many a commit


def test_storage_writers_commit_flush_and_batch_alike():
    got = {}
    for name in PACKAGES:
        storage, formats = _mod(name, "engine.storage"), _mod(name, "engine.formats")
        key = _mod(name, "engine.value").ref_scalar(7)
        log: list = []

        class Client:
            def execute(self, stmt, params):
                log.append(("execute", stmt, params))

            def commit(self):
                log.append(("commit",))

            def index(self, index_name, doc):
                log.append(("index", index_name, doc))

            def flush(self):
                log.append(("flush",))

            def insert_many(self, coll, docs):
                log.append(("insert_many", coll, docs))

        writers = [storage.PsqlWriter(Client(), formats.PsqlUpdatesFormatter("t", ["a", "p"])),
                   storage.ElasticsearchWriter(Client(), "i", formats.DocumentFormatter(["a", "p"])),
                   storage.MongoWriter(Client(), "c", formats.DocumentFormatter(["a", "p"]))]
        for w in writers:
            w.on_change(key, (1.5, key), 3, 1)
            w.on_change(key, (1.5, key), 4, -1)
            w.on_time_end(4)
            w.on_time_end(5)  # an empty commit
            w.on_end()
        got[name] = log
    assert got["torch"] == got["jax"]


# -- BigQuery and Slack ---------------------------------------------------------------------


class _FakeRest:
    """Records POST bodies by path and answers ``answer``."""

    def __init__(self, answer: dict) -> None:
        self.calls: list[tuple[str, dict, str | None]] = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):  # noqa: N802 — http.server API
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length).decode())
                outer.calls.append((self.path, body, self.headers.get("Authorization")))
                payload = json.dumps(answer).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever)
        self.thread.start()

    def url(self) -> str:
        return f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()


def test_bigquery_insert_all_bodies_are_the_same():
    got = {}
    for name, pw in PACKAGES.items():
        fake = _FakeRest({"kind": "bigquery#tableDataInsertAllResponse"})
        try:
            pw.io.bigquery.write(_change_stream(pw, 1), dataset_name="sales", table_name="orders",
                                 project_id="proj", access_token="tok", api_base=fake.url())
            pw.run()
        finally:
            fake.close()
        ids = [r["insertId"] for _p, b, _a in fake.calls for r in b["rows"]]
        assert len(set(ids)) == len(ids) and all(i.startswith("pw-") for i in ids)
        got[name] = [(p, b["kind"], sorted(_canon(r["json"]) for r in b["rows"]), a)
                     for p, b, a in fake.calls]
    assert got["torch"] == got["jax"]
    assert got["torch"][0][0] == "/projects/proj/datasets/sales/tables/orders/insertAll"
    assert got["torch"][0][3] == "Bearer tok"


def test_bigquery_insert_errors_raise_in_both():
    for name in PACKAGES:
        bq = _mod(name, "io.bigquery")
        client = bq.RestBigQueryClient("p", http_fn=lambda url, payload: {
            "insertErrors": [{"index": 0, "errors": [{"reason": "invalid"}]}]})
        with pytest.raises(RuntimeError, match="invalid"):
            client.insert_rows_json("d.t", [{"a": 1}])


def test_slack_alerts_post_insertions_only_alike():
    got = {}
    for name, pw in PACKAGES.items():
        sent = []

        class S(pw.Schema):
            msg: str
            n: int

        t = pw.debug.StreamGenerator().table_from_list_of_batches(
            [[{"msg": "a", "n": 1}, {"msg": "b", "n": 1}], [{"msg": "a", "n": 2}]], S)
        latest = t.groupby(t.n).reduce(text=pw.reducers.max(t.msg), n=t.n)
        pw.io.slack.send_alerts(latest, "C123", "xoxb-fake",
                                post_fn=lambda url, headers, payload: sent.append(
                                    (url, headers, payload)))
        pw.run()
        got[name] = sorted(sent, key=repr)
    assert got["torch"] == got["jax"]
    assert [p["text"] for _u, _h, p in got["torch"]] == ["a", "b"]
    assert got["torch"][0][1] == {"Authorization": "Bearer xoxb-fake"}


# -- the servers and writers under the lock-order watcher -------------------------------------

LOCKWATCHED = """
import json, threading
import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import lockwatch
from pathway_tpu_torch.engine import device_ops
from pathway_tpu_torch.io._es_wire import FakeElasticsearchServer
from pathway_tpu_torch.io._iceberg_rest import FakeIcebergRestServer
from pathway_tpu_torch.io._mongo_wire import FakeMongoServer
from pathway_tpu_torch.io._pg_wire import FakePostgresServer

device_ops.configure(device="cpu")
before = {t.name for t in threading.enumerate()}
pg, mongo, es = FakePostgresServer(password="p", auth="md5"), FakeMongoServer(), FakeElasticsearchServer()
lake = FakeIcebergRestServer("warehouse")
t = pw.debug.table_from_rows(pw.schema_from_types(k=int, v=float), [(i % 3, i / 8) for i in range(12)])
g = t.groupby(t.k).reduce(t.k, s=pw.reducers.sum(t.v))
pw.io.postgres.write_snapshot(g, {"port": pg.port, "password": "p"}, "g", primary_key=["k"])
pw.io.mongodb.write(g, f"127.0.0.1:{mongo.port}", database="d", collection="g")
pw.io.elasticsearch.write(g, es.host(), index_name="g")
pw.io.iceberg.write(g, lake.uri(), ["db"], "g")
pw.run()
rows = [len(pg.snapshot("g")), len(mongo.snapshot("d.g")), len(es.indices["g"]),
        len(lake.tables["db.g"]["snapshots"])]
for srv in (pg, mongo, es, lake):
    srv.close()
left = sorted({t.name for t in threading.enumerate()} - before)
print(json.dumps({"installed": lockwatch.enabled(), "cycles": len(lockwatch.cycles()),
                  "rows": rows, "left": left}))
"""


def test_servers_and_writers_form_no_lock_order_cycle(tmp_path):
    """Under ``PATHWAY_TPU_LOCKWATCH=1`` (a fresh interpreter: the watcher patches
    ``threading`` for the process) the four fake servers and the four writers run a
    program with no lock-order cycle, and closing the servers leaves none of their
    threads."""
    env = dict(os.environ, PYTHONPATH=REPO, PATHWAY_TPU_LOCKWATCH="1",
               PATHWAY_TPU_LOCKWATCH_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", LOCKWATCHED], env=env, cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["installed"] and got["cycles"] == 0
    assert got["rows"] == [3, 3, 3, 1]
    assert not [n for n in got["left"] if n.startswith("fake-")], got["left"]
