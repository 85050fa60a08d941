"""The other message buses of the port against the JAX package's, on the same inputs:
Debezium change streams (``engine/formats.py``'s parser, Postgres and MongoDB, over an
in-memory transport and over the Kafka wire), the Postgres and document formatters,
NATS (each package's connection against the other package's server, ``pw.io.nats``
write then read through ``pw.run``) and Google Pub/Sub's REST publisher against an
in-process fake of its endpoint.

Every comparison is exact: the events, statements and frames, and the keys, values and
diffs of the update streams.
"""

from __future__ import annotations

import base64
import http.server
import importlib
import json
import threading
import time

import numpy as np
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
    """A value both packages print alike: Json by its value, floats by their bits,
    Pointers by their integer."""
    name = type(v).__name__
    if name == "Json":
        return ("json", json.dumps(v.value, sort_keys=True))
    if name == "Pointer":
        return ("ptr", int(v))
    if isinstance(v, float):
        return ("f", np.float64(v).view(np.int64).item())
    if isinstance(v, (tuple, list)):
        return tuple(_canon(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _canon(x)) for k, x in v.items()))
    return v


def _updates(pw, table) -> list:
    out = []
    lock = threading.Lock()

    def on_change(key, row, time, is_addition):
        with lock:
            out.append((int(key), _canon(tuple(row.values())), 1 if is_addition else -1))

    pw.io.subscribe(table, on_change=on_change)
    pw.run()
    return sorted(out, key=repr)


# -- Debezium -----------------------------------------------------------------------------


def _envelope(op: str, before, after, ts: int = 0) -> str:
    return json.dumps({"schema": {"type": "struct"}, "payload": {
        "before": before, "after": after, "op": op, "ts_ms": ts,
        "source": {"connector": "postgresql", "table": "t"}}})


def _pg_stream(seed: int) -> list[tuple]:
    """A snapshot then c/u/d envelopes over keyed rows, as (key json, value json)."""
    rng = np.random.default_rng(seed)
    rows: dict[int, dict] = {}
    out = []
    for i in range(12):
        rows[i] = {"id": i, "k": int(rng.integers(0, 4)), "v": float(rng.integers(-40, 40)) / 8,
                   "meta": {"x": i}}
        out.append((json.dumps({"payload": {"id": i}}), _envelope("r", None, rows[i])))
    for step in range(30):
        op = "cud"[int(rng.integers(0, 3))]
        if op == "c" or not rows:
            i = 100 + step
            rows[i] = {"id": i, "k": int(rng.integers(0, 4)), "v": 0.5 * step, "meta": None}
            out.append((json.dumps({"payload": {"id": i}}), _envelope("c", None, rows[i])))
        elif op == "u":
            i = sorted(rows)[int(rng.integers(0, len(rows)))]
            new = {**rows[i], "k": int(rng.integers(0, 4)), "v": rows[i]["v"] + 1}
            out.append((json.dumps({"payload": {"id": i}}), _envelope("u", rows[i], new)))
            rows[i] = new
        else:
            i = sorted(rows)[int(rng.integers(0, len(rows)))]
            out.append((json.dumps({"payload": {"id": i}}), _envelope("d", rows.pop(i), None)))
            out.append((json.dumps({"payload": {"id": i}}), None))  # the delete's tombstone
    return out


def _pg_schema(pw):
    class S(pw.Schema):
        id: int = pw.column_definition(primary_key=True)
        k: int
        v: float
        meta: pw.Json | None

    return S


@pytest.mark.parametrize("seed", range(3))
def test_debezium_postgres_stream_is_the_same(seed):
    """r/c/u/d envelopes through ``pw.io.debezium.read`` over an ``InMemoryTransport``:
    the same update streams, and no row is retracted more often than inserted."""
    stream = _pg_stream(seed)
    got = {}
    for name, pw in PACKAGES.items():
        tr = pw.io.kafka.InMemoryTransport("cdc")
        for key, value in stream:
            tr.produce(value, key=key)
        tr.close()
        got[name] = _updates(pw, pw.io.debezium.read(schema=_pg_schema(pw), transport=tr,
                                                     autocommit_duration_ms=None))
    assert got["torch"] == got["jax"]
    final: dict = {}
    for key, row, diff in got["torch"]:
        final[(key, row)] = final.get((key, row), 0) + diff
    assert all(d in (0, 1) for d in final.values())


@pytest.mark.parametrize("seed", range(2))
def test_debezium_postgres_groupby_is_the_same(seed):
    """The same stream into a groupby: updates and deletes put negative diffs through the
    reduction, and both packages give the same update stream."""
    stream = _pg_stream(seed)
    got = {}
    for name, pw in PACKAGES.items():
        tr = pw.io.kafka.InMemoryTransport("cdc")
        for key, value in stream:
            tr.produce(value, key=key)
        tr.close()
        t = pw.io.debezium.read(schema=_pg_schema(pw), transport=tr, autocommit_duration_ms=None)
        g = t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v), c=pw.reducers.count())
        got[name] = _updates(pw, g)
    assert got["torch"] == got["jax"]


def test_debezium_over_the_kafka_wire_is_the_same():
    wire = _mod(tpw, "io._kafka_wire")
    broker = wire.FakeKafkaBroker()
    try:
        client = wire.KafkaWireClient(broker.host, broker.port)
        client.produce("pg.public.t", 0, [
            wire.WireRecord(value=None if v is None else v.encode(), key=k.encode())
            for k, v in _pg_stream(7)])
        client.close()
        got = {}
        for name, pw in PACKAGES.items():
            tr = _mod(pw, "io._kafka_wire").KafkaWireTransport(f"{broker.host}:{broker.port}",
                                                              "pg.public.t", mode="static")
            got[name] = _updates(pw, pw.io.debezium.read(schema=_pg_schema(pw), transport=tr,
                                                         topic_name="pg.public.t"))
        assert got["torch"] == got["jax"] and got["torch"]
    finally:
        broker.close()


def _mongo_stream() -> list[tuple]:
    docs = [("r", {"_id": 1, "name": "a", "n": 1}), ("r", {"_id": 2, "name": "b", "n": 2}),
            ("c", {"_id": 3, "name": "c", "n": 3}), ("u", {"_id": 1, "name": "a2", "n": 10}),
            ("d", {"_id": 2}), ("u", {"_id": 3, "name": "c", "n": 30})]
    out = []
    for op, doc in docs:
        after = None if op == "d" else doc
        out.append((json.dumps({"payload": {"_id": doc["_id"]}}),
                    json.dumps({"payload": {"op": op, "after": after, "before": None}})))
    return out


def test_debezium_mongodb_upserts_are_the_same():
    got = {}
    for name, pw in PACKAGES.items():
        class S(pw.Schema):
            _id: int = pw.column_definition(primary_key=True)
            name: str
            n: int

        tr = pw.io.kafka.InMemoryTransport("m")
        for key, value in _mongo_stream():
            tr.produce(value, key=key)
        tr.close()
        got[name] = _updates(pw, pw.io.debezium.read(schema=S, transport=tr, db_type="mongodb"))
    assert got["torch"] == got["jax"]
    final: dict = {}
    for key, row, diff in got["torch"]:
        final[row] = final.get(row, 0) + diff
    assert sorted(r for r, d in final.items() if d) == [(1, "a2", 10), (3, "c", 30)]


PARSER_LINES = [
    '{"payload": {"id": 1}}\t' + _envelope("c", None, {"id": 1, "k": 2, "v": 0.5, "meta": {"a": [1]}}),
    '{"payload": {"id": 1}}\t' + _envelope("u", {"id": 1, "k": 2, "v": 0.5, "meta": None},
                                          {"id": 1, "k": 3, "v": 1.5, "meta": None}),
    '{"payload": {"id": 1}}\t' + _envelope("d", {"id": 1, "k": 3, "v": 1.5, "meta": None}, None),
    '{"payload": {"id": 2}}\tnull',
    '{}\t' + _envelope("r", None, {"id": 5, "k": 1, "v": -1.0, "meta": None}),
]


@pytest.mark.parametrize("db_type", ["postgres", "mongodb"])
@pytest.mark.parametrize("line", range(len(PARSER_LINES)))
def test_debezium_parser_lines_are_the_same(db_type, line):
    """The tab-separated line form (a file's), bytes or str, in both packages."""
    got = {}
    for name, pw in PACKAGES.items():
        keys = None if PARSER_LINES[line].startswith("{}") else ["id"]  # an empty key payload
        parser = _mod(pw, "engine.formats").DebeziumParser(["id", "k", "v", "meta"], keys, db_type=db_type)
        events = parser.parse(PARSER_LINES[line])
        assert [(e.kind, _canon(e.values), e.key) for e in parser.parse(PARSER_LINES[line].encode())] == [
            (e.kind, _canon(e.values), e.key) for e in events]
        got[name] = [(e.kind, _canon(e.values), e.key) for e in events]
        assert parser.session_type == ("native" if db_type == "postgres" else "upsert")
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("payload,match", [
    ("only-one-token", "expected key"),
    ('{}\t{"no": "payload"}', "no payload"),
    ('{}\t{"payload": {"op": "t"}}', "unsupported operation"),
    ('{}\t{"payload": {"op": "c", "after": [1]}}', "expected JSON object"),
])
def test_debezium_parser_refusals_are_the_same(payload, match):
    for pw in PACKAGES.values():
        formats = _mod(pw, "engine.formats")
        with pytest.raises(ValueError, match=match):
            formats.DebeziumParser(["id"]).parse(payload)
    for pw in PACKAGES.values():
        formats = _mod(pw, "engine.formats")
        with pytest.raises(ValueError, match="db_type"):
            formats.DebeziumParser(["id"], db_type="mysql")
        with pytest.raises(ValueError, match="empty kafka key"):
            formats.DebeziumParser(["id"], ["id"]).parse((None, b"{}"))
        assert formats.DebeziumParser(["id"]).parse((None, None)) == []


# -- formatters ---------------------------------------------------------------------------


def _format_rows(pw):
    value = _mod(pw, "engine.value")
    return [((1, "a", 0.5, value.Json({"x": [1, 2]})), 2, 1),
            ((2, "b'c", None, value.Json(None)), 4, -1),
            ((value.ref_scalar(7), "p", -1.25, value.Json("s")), 6, 1)]


@pytest.mark.parametrize("kind", ["updates", "snapshot", "document"])
def test_formatters_give_the_reference_statements(kind):
    got = {}
    for name, pw in PACKAGES.items():
        formats = _mod(pw, "engine.formats")
        fields = ["id", "name", "score", "data"]
        fmt = {"updates": lambda: formats.PsqlUpdatesFormatter("out", fields),
               "snapshot": lambda: formats.PsqlSnapshotFormatter("out", ["id", "name"], fields),
               "document": lambda: formats.DocumentFormatter(fields)}[kind]()
        key = _mod(pw, "engine.value").ref_scalar(0)
        got[name] = [_canon(fmt.format(key, values, t, d)) for values, t, d in _format_rows(pw)]
        if kind != "document":
            with pytest.raises(ValueError, match="mismatch"):
                fmt.format(key, (1,), 0, 1)
    assert got["torch"] == got["jax"]
    if kind == "snapshot":
        for pw in PACKAGES.values():
            formats = _mod(pw, "engine.formats")
            with pytest.raises(ValueError, match="repeated"):
                formats.PsqlSnapshotFormatter("t", ["a"], ["a", "a"])
            with pytest.raises(ValueError, match="unknown key"):
                formats.PsqlSnapshotFormatter("t", ["b"], ["a"])


# -- NATS ---------------------------------------------------------------------------------


def _nats(pw):
    return _mod(pw, "io._nats_wire")


def _new_threads(before: set, prefix: str) -> list:
    """The live threads named ``prefix...`` that were not running at ``before``."""
    return [t for t in threading.enumerate() if t not in before and t.name.startswith(prefix)]


def test_fake_nats_server_stops_its_threads_on_close():
    """``close()`` shuts every session's socket down and joins the accept and session
    threads, even while clients still hold their connections open."""
    nats = _nats(tpw)
    before = set(threading.enumerate())
    server = nats.FakeNatsServer()
    conns = [nats.NatsConnection("127.0.0.1", server.port) for _ in range(3)]
    conns[0].publish("a", b"1")
    conns[0].flush()
    assert len(_new_threads(before, "fake-nats")) == 4  # the accept loop and 3 sessions
    server.close()
    assert not _new_threads(before, "fake-nats")
    server.close()  # a second close is a no-op
    for conn in conns:
        conn.sock.close()


@pytest.mark.parametrize("client_pkg,server_pkg", [("torch", "jax"), ("jax", "torch")])
def test_each_nats_connection_speaks_to_the_other_server(client_pkg, server_pkg):
    """Handshake, subscriptions with ``*`` and ``>`` wildcards, unsubscribe, verbose
    ``+OK``, and token auth, across packages."""
    server = _nats(PACKAGES[server_pkg]).FakeNatsServer(token="s3cret")
    nats = _nats(PACKAGES[client_pkg])
    try:
        with pytest.raises(nats.NatsError, match="Authorization"):
            nats.NatsConnection("127.0.0.1", server.port, token="wrong")
        sub = nats.NatsConnection("127.0.0.1", server.port, token="s3cret", verbose=True)
        assert sub.server_info["auth_required"] is True
        sub.subscribe("a.*", sid=1)
        sub.subscribe("a.>", sid=2)
        sub.subscribe("b", sid=3)
        sub.flush()
        pub = nats.NatsConnection("127.0.0.1", server.port, token="s3cret")
        for subject, payload in [("a.x", b"1"), ("a.x.y", b"22"), ("b", b""), ("c", b"4"),
                                 ("a", b"5")]:
            pub.publish(subject, payload)
        pub.flush()
        got = sorted(sub.drain(0.2))
        assert got == [("a.x", 1, b"1"), ("a.x", 2, b"1"), ("a.x.y", 2, b"22"), ("b", 3, b"")]
        sub.unsubscribe(2)
        sub.flush()
        pub.publish("a.z", b"6")
        pub.flush()
        assert sub.drain(0.2) == [("a.z", 1, b"6")]
        assert server.published["a.x"] == [b"1"] and server.published["c"] == [b"4"]
        assert ("CONNECT" in {v for _c, v in server.frames}) and ("UNSUB" in {v for _c, v in server.frames})
        sub.close()
        pub.close()
    finally:
        server.close()


@pytest.mark.parametrize("pattern,subject,want", [
    ("a.b", "a.b", True), ("a.*", "a.b", True), ("a.*", "a.b.c", False), ("a.>", "a", False),
    ("a.>", "a.b.c", True), ("*.b", "x.b", True), (">", "x", True), ("a.b", "a.c", False),
])
def test_subject_matching_is_the_reference_matching(pattern, subject, want):
    for pw in PACKAGES.values():
        assert _nats(pw)._subject_matches(pattern, subject) is want


class _Ending:
    """A transport that reports finished once it has delivered ``n`` messages."""

    def __init__(self, transport, n: int) -> None:
        self.transport, self.n, self.seen = transport, n, 0

    def poll_messages(self):
        out = self.transport.poll_messages()
        self.seen += len(out)
        return out

    def finished(self) -> bool:
        return self.seen >= self.n


def test_nats_write_then_read_through_pw_run():
    """``pw.io.nats.write`` of a groupby's update stream to a subject that a
    ``NatsConnection`` watches, the frames folded; then ``pw.io.nats.read`` of those
    frames published again. Both packages give the same messages and updates."""
    server = _nats(tpw).FakeNatsServer()
    try:
        written, read = {}, {}
        for name, pw in PACKAGES.items():
            watcher = _nats(tpw).NatsConnection("127.0.0.1", server.port)
            watcher.subscribe(f"out.{name}", sid=1)
            watcher.flush()
            rows = [(i % 3, float(i)) for i in range(9)]
            t = pw.debug.table_from_rows(pw.schema_from_types(g=int, v=float), rows)
            g = t.groupby(pw.this.g).reduce(pw.this.g, s=pw.reducers.sum(pw.this.v))
            pw.io.nats.write(g, f"nats://127.0.0.1:{server.port}", f"out.{name}")
            pw.run()
            msgs = []
            deadline = time.monotonic() + 10
            while len(msgs) < 3 and time.monotonic() < deadline:
                msgs += watcher.drain(0.05)
            watcher.close()
            written[name] = sorted(tuple(sorted((k, v) for k, v in json.loads(p).items() if k != "time"))
                                   for _s, _sid, p in msgs)
            tr = _nats(pw).NatsTransport("127.0.0.1", server.port, f"in.{name}")
            pub = _nats(tpw).NatsConnection("127.0.0.1", server.port)
            for _s, _sid, payload in msgs:
                pub.publish(f"in.{name}", payload)
            pub.flush()
            pub.close()
            t2 = pw.io.nats.read(schema=pw.schema_from_types(g=int, s=float, diff=int),
                                 transport=_Ending(tr, len(msgs)), autocommit_duration_ms=None)
            read[name] = sorted(r[1:] for r in _updates(pw, t2))
            tr.close()
        assert written["torch"] == written["jax"] and len(written["torch"]) == 3
        assert read["torch"] == read["jax"] and len(read["torch"]) == 3
    finally:
        server.close()


@pytest.mark.parametrize("uri,want", [
    ("nats://127.0.0.1:{port}", {}),
    ("127.0.0.1:{port}", {}),
    ("nats://tok@127.0.0.1:{port}", {"auth_token": "tok"}),
    ("nats://u:p@127.0.0.1:{port}", {"user": "u", "pass": "p"}),
])
def test_nats_uris_connect_alike(uri, want):
    """The URI's token or user and password reach the server's CONNECT alike."""
    got = {}
    for name, pw in PACKAGES.items():
        seen = []
        server = _nats(tpw).FakeNatsServer()
        original = json.loads

        def spy(s, *a, **k):
            obj = original(s, *a, **k)
            if isinstance(obj, dict) and "lang" in obj:
                seen.append({k2: obj[k2] for k2 in ("auth_token", "user", "pass") if k2 in obj})
            return obj

        _nats(tpw).json.loads = spy
        try:
            tr = pw.io.nats._wire_transport(uri.format(port=server.port), "s", subscribe=False)
            tr.close()
        finally:
            _nats(tpw).json.loads = original
            server.close()
        got[name] = seen
    assert got["torch"] == got["jax"] == [want]
    for pw in PACKAGES.values():
        with pytest.raises(ValueError, match="uri and topic"):
            pw.io.nats._wire_transport(None, "s")


def test_closing_a_nats_transport_ends_the_read_only_in_the_port():
    """ROADMAP: deliberate differences. The JAX package's transport never finishes."""
    server = _nats(tpw).FakeNatsServer()
    try:
        for name, pw in PACKAGES.items():
            tr = _nats(pw).NatsTransport("127.0.0.1", server.port, "x")
            tr.produce(b"m")
            assert not tr.finished()
            tr.close()
            if name == "torch":
                assert tr.finished() and tr.poll_messages() == []
            else:
                assert not tr.finished()
    finally:
        server.close()


def test_nats_server_counts_its_bytes():
    server = _nats(tpw).FakeNatsServer()
    try:
        c = _nats(tpw).NatsConnection("127.0.0.1", server.port)
        c.subscribe("s")
        c.publish("s", b"abcd")
        c.flush()
        assert c.drain(0.2) == [("s", 1, b"abcd")]
        c.close()
        sent_in = len(b"SUB s 1\r\n") + len(b"PUB s 4\r\nabcd\r\n") + 2 * len(b"PING\r\n")
        assert server.bytes_received >= sent_in
        assert server.bytes_sent >= len(b"MSG s 1 4\r\nabcd\r\n") + 2 * len(b"PONG\r\n")
    finally:
        server.close()


# -- Pub/Sub ------------------------------------------------------------------------------


class _PubSubFake:
    """An in-process ``topics.publish`` endpoint that keeps each request."""

    def __init__(self) -> None:
        requests, lock = [], threading.Lock()

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 — http.server's name
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                with lock:
                    requests.append((self.path, self.headers.get("Authorization"), body))
                    n = len(requests)
                data = json.dumps({"messageIds": [str(n)]}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.requests = requests
        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def test_pubsub_write_against_a_rest_fake():
    fake = _PubSubFake()
    try:
        got = {}
        for name, pw in PACKAGES.items():
            n0 = len(fake.requests)
            t = pw.debug.table_from_rows(pw.schema_from_types(a=int, b=str), [(1, "x"), (2, "y")])
            pw.io.pubsub.write(t, project_id="proj", topic_id=f"top_{name}", access_token="tok",
                               api_base=fake.url + "/")
            pw.run()
            reqs = fake.requests[n0:]
            got[name] = sorted(
                (path.replace(name, "*"), auth,
                 tuple(sorted((k, v) for k, v in json.loads(base64.b64decode(m["data"])).items()
                              if k != "time")))
                for path, auth, body in reqs for m in body["messages"])
        assert got["torch"] == got["jax"] and len(got["torch"]) == 2
        assert got["torch"][0][:2] == ("/v1/projects/proj/topics/top_*:publish", "Bearer tok")
        for pw in PACKAGES.values():
            pub = pw.io.pubsub.RestPublisher("p", api_base=fake.url)
            assert pub.publish("t", b"z", origin="test") == str(len(fake.requests))
            assert fake.requests[-1][2] == {"messages": [{"data": "eg==", "attributes": {"origin": "test"}}]}
    finally:
        fake.close()


def test_pubsub_write_through_an_injected_publisher():
    got = {}
    for name, pw in PACKAGES.items():
        calls = []

        class Publisher:
            def publish(self, topic, data, **attrs):
                calls.append((topic, json.loads(data)["a"], json.loads(data)["diff"]))

        t = pw.debug.table_from_rows(pw.schema_from_types(a=int), [(3,), (4,)])
        pw.io.pubsub.write(t, Publisher(), topic_id="t")
        pw.run()
        got[name] = sorted(calls)
    assert got["torch"] == got["jax"] == [("t", 3, 1), ("t", 4, 1)]
