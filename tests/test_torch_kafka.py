"""The Kafka connector of the port against the JAX package's, on the same inputs: the
wire primitives (CRC32C, varints, RecordBatch v2) byte for byte, each package's
``KafkaWireClient`` against the other package's ``FakeKafkaBroker``, the Avro codec and
its container files, and ``pw.io.kafka`` / ``pw.io.redpanda`` through ``pw.run`` in both
packages (json, raw, plaintext, upserts with tombstones, avro through a fake schema
registry, ``read_from_upstash``, ``write``), and a persisted read crashed and resumed.

Every comparison is exact: bytes on the wire, and the keys, values and diffs of the
update streams. Both packages' reads fetch the same topics of one broker.
"""

from __future__ import annotations

import importlib
import io
import json
import os
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
    """The CPU's device operators, empty graphs, and both packages' UDF cache roots as
    they were (a persistent run routes them under its store)."""
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


def _wire(pw):
    return _mod(pw, "io._kafka_wire")


def _canon(v):
    """A value both packages print alike: Json by its value, floats by their bits."""
    if type(v).__name__ == "Json":
        return ("json", json.dumps(v.value, sort_keys=True))
    if isinstance(v, float):
        return ("f", np.float64(v).view(np.int64).item())
    if isinstance(v, (tuple, list)):
        return tuple(_canon(x) for x in v)
    return v


def _updates(pw, table) -> list:
    """``pw.run`` of ``table``'s program -> its update stream, (key, row, diff) sorted."""
    out = []
    lock = threading.Lock()

    def on_change(key, row, time, is_addition):
        with lock:
            out.append((int(key), _canon(tuple(row.values())), 1 if is_addition else -1))

    pw.io.subscribe(table, on_change=on_change)
    pw.run()
    return sorted(out, key=repr)


@pytest.fixture
def broker():
    b = _wire(tpw).FakeKafkaBroker()
    yield b
    b.close()


def _produce(broker, topic: str, records: list[tuple]) -> None:
    """(key, value) pairs, as bytes or None, produced to ``topic`` in one batch."""
    wire = _wire(tpw)
    client = wire.KafkaWireClient(broker.host, broker.port)
    try:
        client.produce(topic, 0, [wire.WireRecord(value=v, key=k) for k, v in records])
    finally:
        client.close()


def _settings(broker) -> dict:
    return {"bootstrap.servers": f"{broker.host}:{broker.port}"}


# -- wire primitives ----------------------------------------------------------------------


def _new_threads(before: set, prefix: str) -> list:
    """The live threads named ``prefix...`` that were not running at ``before``."""
    return [t for t in threading.enumerate() if t not in before and t.name.startswith(prefix)]


def test_fake_broker_stops_its_threads_on_close():
    """``close()`` shuts every session's socket down and joins the accept and session
    threads, even while clients still hold their connections open."""
    wire = _wire(tpw)
    before = set(threading.enumerate())
    broker = wire.FakeKafkaBroker()
    clients = [wire.KafkaWireClient(broker.host, broker.port) for _ in range(3)]
    clients[0].produce("t", 0, [wire.WireRecord(b"v")])
    for client in clients:
        client.metadata(["t"])  # a round trip: the client's session thread serves it
    assert len(_new_threads(before, "fake-kafka")) == 4  # the accept loop and 3 sessions
    broker.close()
    assert not _new_threads(before, "fake-kafka")
    broker.close()  # a second close is a no-op
    for client in clients:
        client.sock.close()


def test_crc32c_is_castagnoli_and_the_reference_crc():
    # RFC 3720 B.4: 32 bytes of zeros, of 0xff, and ascending
    assert _wire(tpw).crc32c(bytes(32)) == 0x8A9136AA
    assert _wire(tpw).crc32c(b"\xff" * 32) == 0x62A8AB43
    assert _wire(tpw).crc32c(bytes(range(32))) == 0x46DD794E
    assert _wire(tpw).crc32c(b"123456789") == 0xE3069283
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 64, 1000, 4097):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert _wire(tpw).crc32c(data) == _wire(jpw).crc32c(data)


@pytest.mark.parametrize("n", [0, 1, 63, 64, 127, 128, 300, -1, -64, -65, 2**31, -(2**63), 2**63 - 1])
def test_varints_are_the_reference_bytes(n):
    outs = []
    for pw in PACKAGES.values():
        out = io.BytesIO()
        _wire(pw).write_varint(out, n)
        outs.append(out.getvalue())
        assert _wire(pw).read_varint(io.BytesIO(out.getvalue())) == n
    assert outs[0] == outs[1]


def _records(pw, seed: int) -> list:
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(int(rng.integers(1, 40))):
        key = None if rng.random() < 0.3 else rng.integers(0, 256, int(rng.integers(0, 20)), dtype=np.uint8).tobytes()
        value = None if rng.random() < 0.2 else rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8).tobytes()
        headers = [(f"h{j}", rng.integers(0, 256, int(rng.integers(0, 9)), dtype=np.uint8).tobytes())
                   for j in range(int(rng.integers(0, 3)))]
        recs.append(_wire(pw).WireRecord(value=value, key=key, timestamp=1_700_000_000_000 + 5 * i,
                                         headers=headers))
    return recs


@pytest.mark.parametrize("seed", range(6))
def test_record_batch_bytes_equal_the_reference(seed):
    """Tombstones (null values), null keys and headers: the same RecordBatch bytes, and
    each package decodes the other's batch to the same records."""
    base = 17 * seed
    ours = _wire(tpw).encode_record_batch(_records(tpw, seed), base_offset=base)
    theirs = _wire(jpw).encode_record_batch(_records(jpw, seed), base_offset=base)
    assert ours == theirs
    for pw in PACKAGES.values():
        back = _wire(pw).decode_record_batches(ours + theirs)
        want = _records(pw, seed)
        assert len(back) == 2 * len(want)
        for i, rec in enumerate(back):
            w = want[i % len(want)]
            assert (rec.key, rec.value, rec.timestamp, rec.headers) == (w.key, w.value, w.timestamp,
                                                                        w.headers)
            assert rec.offset == base + i % len(want)


def test_a_corrupted_batch_fails_its_crc():
    batch = bytearray(_wire(tpw).encode_record_batch(_records(tpw, 1), base_offset=0))
    batch[-3] ^= 0x40
    for pw in PACKAGES.values():
        with pytest.raises(ValueError, match="CRC32C"):
            _wire(pw).decode_record_batches(bytes(batch))


@pytest.mark.parametrize("client_pkg,broker_pkg", [("torch", "jax"), ("jax", "torch")])
def test_each_client_speaks_to_the_other_broker(client_pkg, broker_pkg):
    """ApiVersions, Metadata (topics created on first use), Produce, ListOffsets and
    Fetch across packages: the protocol is the contract."""
    b = _wire(PACKAGES[broker_pkg]).FakeKafkaBroker()
    wire = _wire(PACKAGES[client_pkg])
    client = wire.KafkaWireClient(b.host, b.port)
    try:
        assert client.api_versions() == {0: (3, 3), 1: (4, 4), 2: (1, 1), 3: (1, 1), 18: (0, 0)}
        meta = client.metadata(["t"])
        assert meta["brokers"] == [{"node_id": 0, "host": b.host, "port": b.port}]
        assert meta["topics"]["t"]["partitions"][0]["partition"] == 0
        recs = _records(PACKAGES[client_pkg], 3)
        assert client.produce("t", 0, recs) == 0
        assert client.produce("t", 0, recs[:2]) == len(recs)
        assert client.list_offsets("t", 0, -2) == 0
        assert client.list_offsets("t", 0, -1) == len(recs) + 2
        got, high = client.fetch("t", 0, 1)
        assert high == len(recs) + 2
        assert [(r.offset, r.key, r.value, r.headers) for r in got] == [
            (i + 1, r.key, r.value, r.headers) for i, r in enumerate(recs[1:] + recs[:2])]
        assert client.fetch("t", 0, len(recs) + 2) == ([], len(recs) + 2)
    finally:
        client.close()
        b.close()


def test_the_transports_produce_and_poll_alike(broker):
    """``KafkaWireTransport`` of both packages on one broker: what one produces (keyed and
    keyless) the other polls, with the same coordinates; static mode finishes at the
    end offset of its first poll."""
    tt = _wire(tpw).KafkaWireTransport(f"{broker.host}:{broker.port}", "x")
    jt = _wire(jpw).KafkaWireTransport(f"{broker.host}:{broker.port}", "x")
    tt.produce("a", key="k1")
    jt.produce(b"b")
    tt.produce(b"c", key=b"k2")
    got = {}
    for name, pw in PACKAGES.items():
        t = _wire(pw).KafkaWireTransport(f"{broker.host}:{broker.port}", "x", mode="static")
        msgs = t.poll_messages()
        got[name] = [(m.key, m.value, m.topic, m.partition, m.offset) for m in msgs]
        assert t.finished()
        t.close()
    assert got["torch"] == got["jax"] == [(b"k1", b"a", "x", 0, 0), (None, b"b", "x", 0, 1),
                                          (b"k2", b"c", "x", 0, 2)]
    latest = _wire(tpw).KafkaWireTransport(f"{broker.host}:{broker.port}", "x", start="latest")
    assert latest.poll_messages() == []
    for t in (tt, jt, latest):
        t.close()


# -- the deliberate difference: closing a streaming transport ends its read ---------------


def test_closing_a_streaming_transport_ends_the_read_only_in_the_port(broker):
    """The port's ``close()`` waits for a poll in flight; later polls read nothing and
    ``finished()`` holds. The JAX package's closes the socket under the poll, and a poll
    after it raises ``OSError`` (ROADMAP: deliberate differences)."""
    _produce(broker, "s", [(None, b"1")])
    for name, pw in PACKAGES.items():
        t = _wire(pw).KafkaWireTransport(f"{broker.host}:{broker.port}", "s")
        assert [m.value for m in t.poll_messages()] == [b"1"]
        assert not t.finished()
        t.close()
        assert t.finished()
        if name == "torch":
            assert t.poll_messages() == []
        else:
            with pytest.raises(OSError):
                t.poll_messages()


def test_the_port_closes_a_transport_polled_on_another_thread(broker):
    """A run thread polls without pause while the main thread produces and then closes:
    no poll raises, and every message produced before the close is read."""
    t = _wire(tpw).KafkaWireTransport(f"{broker.host}:{broker.port}", "busy")
    got, errors = [], []

    def poll():
        try:
            while not t.finished():
                got.extend(m.value for m in t.poll_messages())
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    th = threading.Thread(target=poll)
    th.start()
    for i in range(50):
        _produce(broker, "busy", [(None, str(i).encode())])
    while len(got) < 50 and th.is_alive():
        time.sleep(0.001)
    t.close()
    th.join(10)
    assert not th.is_alive() and errors == []
    assert got == [str(i).encode() for i in range(50)]


# -- Avro ---------------------------------------------------------------------------------

AVRO_SCHEMA = {
    "type": "record", "name": "r",
    "fields": [
        {"name": "i", "type": "long"}, {"name": "f", "type": "double"},
        {"name": "g", "type": "float"}, {"name": "b", "type": "boolean"},
        {"name": "s", "type": "string"}, {"name": "raw", "type": "bytes"},
        {"name": "opt", "type": ["null", "long"]},
        {"name": "fx", "type": {"type": "fixed", "name": "f4", "size": 4}},
        {"name": "arr", "type": {"type": "array", "items": "int"}},
        {"name": "m", "type": {"type": "map", "values": ["null", "string"]}},
        {"name": "sub", "type": {"type": "record", "name": "sub", "fields": [{"name": "x", "type": "int"}]}},
        {"name": "d", "type": "long", "default": 7},
    ],
}


def _avro_values(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        out.append({
            "i": int(rng.integers(-(2**62), 2**62)), "f": float(rng.normal()), "g": 0.5 * i,
            "b": bool(rng.random() < 0.5), "s": "é" * i + str(i),
            "raw": rng.integers(0, 256, i, dtype=np.uint8).tobytes(),
            "opt": None if i % 3 == 0 else i - 6, "fx": bytes([i, 1, 2, 3]),
            "arr": [int(x) for x in rng.integers(-1000, 1000, i % 5)],
            "m": {f"k{j}": (None if j % 2 else "v") for j in range(i % 4)},
            "sub": {"x": -i}, "d": None,
        })
    return out


@pytest.mark.parametrize("seed", range(3))
def test_avro_encode_and_decode_equal_the_reference(seed):
    for value in _avro_values(seed):
        outs = []
        for pw in PACKAGES.values():
            out = io.BytesIO()
            _mod(pw, "io._avro").encode(out, AVRO_SCHEMA, value)
            outs.append(out.getvalue())
        assert outs[0] == outs[1]
        for pw in PACKAGES.values():
            back = _mod(pw, "io._avro").decode(io.BytesIO(outs[0]), AVRO_SCHEMA)
            assert back == {**value, "d": 7}


def test_avro_refuses_what_the_reference_refuses():
    for pw in PACKAGES.values():
        avro = _mod(pw, "io._avro")
        with pytest.raises(ValueError, match="union"):
            avro.encode(io.BytesIO(), ["null", "long"], "x")
        with pytest.raises(ValueError, match="fixed"):
            avro.encode(io.BytesIO(), {"type": "fixed", "size": 2}, b"abc")
        with pytest.raises(ValueError, match="truncated"):
            avro.read_bytes(io.BytesIO(b"\x08ab"))


def test_avro_containers_read_across_packages(tmp_path, monkeypatch):
    """A container file written by either package, with the sync marker pinned, is the
    same bytes, and each package reads the other's file."""
    import secrets

    monkeypatch.setattr(secrets, "token_bytes", lambda n: bytes(range(n)))
    records = _avro_values(5)
    for rec in records:
        rec["d"] = 7
    paths = {}
    for name, pw in PACKAGES.items():
        paths[name] = tmp_path / f"{name}.avro"
        _mod(pw, "io._avro").write_container(paths[name], AVRO_SCHEMA, records, {"k": "v"})
    assert paths["torch"].read_bytes() == paths["jax"].read_bytes()
    for pw in PACKAGES.values():
        for path in paths.values():
            schema, back, meta = _mod(pw, "io._avro").read_container(path)
            assert schema == AVRO_SCHEMA and back == records and meta["k"] == "v"
    bad = tmp_path / "bad.avro"
    raw = bytearray(paths["torch"].read_bytes())
    raw[-1] ^= 1
    bad.write_bytes(bytes(raw))
    for pw in PACKAGES.values():
        with pytest.raises(ValueError, match="sync marker"):
            _mod(pw, "io._avro").read_container(bad)


# -- pw.io.kafka through pw.run -----------------------------------------------------------


def _docs(n: int, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"id": i, "name": f"n{int(rng.integers(0, 5))}", "score": float(rng.normal()),
             "tags": {"t": [int(x) for x in rng.integers(0, 9, 2)]}} for i in range(n)]


def _json_schema(pw, pk: bool = False):
    class S(pw.Schema):
        id: int = pw.column_definition(primary_key=pk)
        name: str
        score: float
        tags: pw.Json

    return S


def test_kafka_json_static_read_is_the_same(broker):
    _produce(broker, "j", [(None, json.dumps(d).encode()) for d in _docs(30)])
    got = {}
    for name, pw in PACKAGES.items():
        t = pw.io.kafka.read(_settings(broker), "j", format="json", schema=_json_schema(pw),
                             mode="static")
        got[name] = _updates(pw, t.select(pw.this.name, pw.this.score, pw.this.tags))
    assert got["torch"] == got["jax"]
    assert len(got["torch"]) == 30 and {d for *_, d in got["torch"]} == {1}


@pytest.mark.parametrize("fmt", ["raw", "plaintext"])
def test_kafka_raw_and_plaintext_reads_are_the_same(broker, fmt):
    _produce(broker, fmt, [(b"k", f"line é {i}".encode()) for i in range(9)] + [(b"k", None)])
    got = {name: _updates(pw, pw.io.kafka.read(_settings(broker), fmt, format=fmt, mode="static"))
           for name, pw in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    assert sorted(r[1][0] for r in got["torch"]) == sorted(
        (f"line é {i}".encode() if fmt == "raw" else f"line é {i}") for i in range(9))


def test_redpanda_is_kafka(broker):
    _produce(broker, "rp", [(None, b"x"), (None, b"y")])
    got = {name: _updates(pw, pw.io.redpanda.read(_settings(broker), "rp", format="plaintext",
                                                  mode="static"))
           for name, pw in PACKAGES.items()}
    assert got["torch"] == got["jax"] and len(got["torch"]) == 2
    assert tpw.io.redpanda.write is tpw.io.kafka.write
    assert tpw.io.redpanda.simple_read is tpw.io.kafka.simple_read


def test_kafka_simple_read_is_a_raw_read(broker):
    _produce(broker, "sr", [(None, b"\x00\x01"), (None, b"z")])
    got = {name: _updates(pw, pw.io.kafka.simple_read(f"{broker.host}:{broker.port}", "sr",
                                                      mode="static"))
           for name, pw in PACKAGES.items()}
    assert got["torch"] == got["jax"] and sorted(r[1] for r in got["torch"]) == [(b"\x00\x01",), (b"z",)]


UPSERT_CASES = {
    # the JSON key of a tombstone
    "json_key": [(b'{"id": 1}', {"id": 1, "name": "a"}), (b'{"id": 2}', {"id": 2, "name": "b"}),
                 (b'{"id": 1}', {"id": 1, "name": "c"}), (b'{"id": 2}', None),
                 (b'{"id": 3}', {"id": 3, "name": "d"})],
    # a bare (JSON scalar) key, and a key that is not JSON at all
    "raw_key": [(b"1", {"id": 1, "name": "a"}), (b"7", {"id": 7, "name": "b"}), (b"1", None),
                (b"7", {"id": 7, "name": "e"}), (b"zz", None), (None, None)],
}


@pytest.mark.parametrize("case", sorted(UPSERT_CASES))
def test_kafka_upserts_and_tombstones_are_the_same(broker, case):
    _produce(broker, case, [(k, None if v is None else json.dumps(v).encode())
                            for k, v in UPSERT_CASES[case]])
    got = {}
    for name, pw in PACKAGES.items():
        t = pw.io.kafka.read(_settings(broker), case, format="json", mode="static",
                             schema=pw.schema_from_types(id=int, name=str), primary_key=["id"])
        got[name] = _updates(pw, t)
    assert got["torch"] == got["jax"]
    final = {}
    for key, row, diff in got["torch"]:
        final[key] = final.get(key, 0) + diff
    assert sum(final.values()) == {"json_key": 2, "raw_key": 1}[case]


def test_a_composite_key_tombstone_needs_a_json_object():
    for pw in PACKAGES.values():
        parser = pw.io.kafka._KafkaJsonParser(["a", "b", "v"], ["a", "b"])
        (ev,) = parser.parse((b'{"a": 1, "b": "x"}', None))
        assert (ev.kind, ev.values, ev.key) == ("upsert", None, (1, "x"))
        with pytest.raises(ValueError, match="composite"):
            parser.parse((b"5", None))
        assert parser.parse((None, None)) == []


class _Registry:
    """An in-process schema registry behind ``request_fn``: ids count from 1."""

    def __init__(self) -> None:
        self.schemas: dict[int, str] = {}
        self.calls: list = []

    def __call__(self, method: str, url: str, payload):
        self.calls.append((method, url.split("/", 3)[-1]))
        if method == "POST":
            self.schemas[len(self.schemas) + 1] = payload["schema"]
            return {"id": len(self.schemas)}
        return {"schema": self.schemas[int(url.rsplit("/", 1)[1])]}


def test_kafka_avro_through_a_schema_registry(broker):
    """Rows written as registry-framed Avro by one package's ``kafka.write`` and read by
    both packages' ``kafka.read``; the frames and the reads are the same."""
    reg = _Registry()
    rows = [(i, f"w{i}", 0.25 * i, i % 2 == 0) for i in range(6)]
    frames = {}
    for name, pw in PACKAGES.items():
        t = pw.debug.table_from_rows(pw.schema_from_types(k=int, s=str, x=float, b=bool), rows)
        registry = pw.io.kafka.SchemaRegistry("http://registry", request_fn=reg)
        pw.io.kafka.write(t, _settings(broker), f"avro_{name}", format="avro", schema_registry=registry)
        pw.run()
        client = _wire(tpw).KafkaWireClient(broker.host, broker.port)
        frames[name] = sorted(r.value[5:] for r in client.fetch(f"avro_{name}", 0, 0)[0])
        client.close()
    assert frames["torch"] == frames["jax"] and len(frames["torch"]) == 6
    assert reg.schemas[1].replace("avro_torch", "avro_jax") == reg.schemas[2]
    got = {}
    for name, pw in PACKAGES.items():
        registry = pw.io.kafka.SchemaRegistry("http://registry", request_fn=reg)
        t = pw.io.kafka.read(_settings(broker), "avro_torch", format="avro", mode="static",
                             schema=pw.schema_from_types(k=int, s=str, x=float, b=bool, diff=int),
                             schema_registry=registry)
        got[name] = _updates(pw, t)
    assert got["torch"] == got["jax"]
    assert sorted(r[1][:4] for r in got["torch"]) == [_canon(r) for r in rows]
    for pw in PACKAGES.values():
        with pytest.raises(ValueError, match="magic byte"):
            pw.io.kafka.SchemaRegistry("u", request_fn=reg).decode_message(b"\x01abcd")


def test_kafka_avro_upsert_tombstones_use_the_message_key():
    reg = _Registry()
    schema = {"type": "record", "name": "r", "fields": [{"name": "id", "type": "long"},
                                                         {"name": "v", "type": "string"}]}
    for pw in PACKAGES.values():
        registry = pw.io.kafka.SchemaRegistry("http://registry", request_fn=reg)
        sid = registry.register("t-value", schema)
        parser = pw.io.kafka._KafkaAvroParser(["id", "v"], ["id"], registry)
        (ev,) = parser.parse((None, registry.encode_message(sid, {"id": 4, "v": "x"})))
        assert (ev.kind, ev.values, ev.key) == ("upsert", (4, "x"), (4,))
        (ev,) = parser.parse((b"4", None))
        assert (ev.kind, ev.values, ev.key) == ("upsert", None, (4,))


def test_read_from_upstash_with_an_injected_request_fn():
    """Two REST consume batches, then the end; the requests' URL and basic auth and the
    update streams are the same in both packages."""
    got, seen = {}, {}
    for name, pw in PACKAGES.items():
        batches = [[{"key": "a", "value": '{"id": 1, "name": "x"}', "offset": 0, "partition": 0},
                    {"key": None, "value": '{"id": 2, "name": "y"}', "offset": 1, "partition": 0}],
                   [],
                   [{"value": '{"id": 3, "name": "z"}', "offset": 0, "partition": 1}]]
        calls = []

        def request_fn(url, headers, batches=batches, calls=calls):
            calls.append((url, headers))
            return batches.pop(0) if batches else []

        request_fn.finished = lambda batches=batches: not batches
        t = pw.io.kafka.read_from_upstash("https://up.example/", "user", "pass", "topic",
                                          schema=pw.schema_from_types(id=int, name=str),
                                          format="json", request_fn=request_fn,
                                          autocommit_duration_ms=None)
        got[name] = _updates(pw, t)
        seen[name] = calls[0]
    assert got["torch"] == got["jax"] and len(got["torch"]) == 3
    assert seen["torch"] == seen["jax"] == (
        "https://up.example/consume/pathway-group/pathway-instance/topic",
        {"Authorization": "Basic dXNlcjpwYXNz"})


def test_kafka_write_answers_are_the_same(broker):
    """``kafka.write`` of a groupby's update stream (insertions and retractions across
    two commits) with a message key: the same messages, as keys, rows and diffs."""
    got = {}
    for name, pw in PACKAGES.items():
        _produce(broker, f"in_{name}", [(None, json.dumps({"g": i % 3, "v": i}).encode())
                                        for i in range(7)])
        t = pw.io.kafka.read(_settings(broker), f"in_{name}", format="json", mode="static",
                             schema=pw.schema_from_types(g=int, v=int))
        r = t.groupby(pw.this.g).reduce(pw.this.g, s=pw.reducers.sum(pw.this.v),
                                        c=pw.reducers.count())
        pw.io.kafka.write(r, _settings(broker), f"out_{name}", format="json", key="g")
        pw.run()
        client = _wire(tpw).KafkaWireClient(broker.host, broker.port)
        recs, _ = client.fetch(f"out_{name}", 0, 0)
        client.close()
        got[name] = sorted((r.key, tuple(sorted((k, v) for k, v in json.loads(r.value).items()
                                                 if k != "time"))) for r in recs)
    assert got["torch"] == got["jax"]
    assert {k for k, _ in got["torch"]} == {b"0", b"1", b"2"}
    with pytest.raises(ValueError, match="unsupported kafka write format"):
        tpw.io.kafka.write(tpw.debug.table_from_rows(tpw.schema_from_types(a=int), [(1,)]),
                           transport=tpw.io.kafka.InMemoryTransport(), format="csv")


def test_kafka_read_refusals_are_the_reference_refusals(broker):
    for pw in PACKAGES.values():
        with pytest.raises(ValueError, match="bootstrap.servers"):
            pw.io.kafka.read({}, "t")
        with pytest.raises(ValueError, match="one topic per connector"):
            pw.io.kafka.read(_settings(broker), ["a", "b"])
        with pytest.raises(ValueError, match="needs schema="):
            pw.io.kafka.read(_settings(broker), "t", format="json")
        with pytest.raises(ValueError, match="schema_registry"):
            pw.io.kafka.read(_settings(broker), "t", format="avro",
                             schema=pw.schema_from_types(a=int))
        with pytest.raises(ValueError, match="unknown kafka format"):
            pw.io.kafka.read(_settings(broker), "t", format="xml")


def test_in_memory_transport_and_reader_state_are_the_reference_ones():
    """``InMemoryTransport`` through ``MessageQueueReader``: the same entries, and a
    reader restored from the other package's ``state()`` drops what it saw."""
    states = {}
    for name, pw in PACKAGES.items():
        storage = _mod(pw, "engine.storage")
        tr = storage.InMemoryTransport("t")
        for i in range(4):
            tr.produce(f"v{i}", key=f"k{i}")
        reader = storage.MessageQueueReader(tr)
        entries, done = reader.poll()
        assert [e[0] for e in entries] == [(f"k{i}", f"v{i}") for i in range(4)] and not done
        assert entries[2][1:] == ("t:0", {"topic": "t", "partition": 0, "offset": 2})
        tr.close()
        assert reader.poll() == ([], True)
        states[name] = reader.state()
    assert states["torch"] == states["jax"] == {"offsets": {"t\x000": 3}}
    for name, pw in PACKAGES.items():
        storage = _mod(pw, "engine.storage")
        tr = storage.InMemoryTransport("t")
        for i in range(6):
            tr.produce(f"v{i}")
        reader = storage.MessageQueueReader(tr)
        reader.restore_state(states["jax" if name == "torch" else "torch"])
        assert [e[0][1] for e in reader.poll()[0]] == ["v4", "v5"]


# -- persistence --------------------------------------------------------------------------


def _persisted_counts(pw, broker, topic, store):
    pers = _mod(pw, "persistence")
    t = pw.io.kafka.read(_settings(broker), topic, format="plaintext", persistent_id="bus")
    counts = t.groupby(t.data).reduce(word=t.data, cnt=pw.reducers.count())
    runner = _mod(pw, "internals.runner").GraphRunner(
        persistence_config=pers.Config(pers.Backend.filesystem(str(store))))
    return runner, runner.build(counts)


def _drive(pw, runner, rounds: int):
    """``GraphRunner.run``'s journal wiring for ``rounds`` poll and commit rounds (no
    clean end: dropping the runner after it is a crash) -> the entries polled."""
    sched = _mod(pw, "engine.graph").Scheduler(runner.scope)
    persistent = [d for d in runner.drivers if hasattr(d, "replay")]
    for d in persistent:
        d.replay()
    sched.commit()
    for _ in range(rounds):
        if any(d.poll() == "data" for d in runner.drivers):
            t = sched.commit()
            for d in persistent:
                d.on_commit(t)
        else:
            time.sleep(0.01)
    return sum(getattr(d, "driver", d).entries_total for d in runner.drivers)


def test_a_persisted_kafka_read_resumes_with_only_the_new_messages(broker, tmp_path):
    """A streaming read journaled under ``PersistenceMode.PERSISTING``, crashed and
    resumed: the transport reads the topic from the start again, the restored reader
    drops the offsets it had seen, the counts double nothing, and both packages end with
    the same keyed state."""
    states = {}
    for name, pw in PACKAGES.items():
        topic, store = f"words_{name}", tmp_path / name
        _produce(broker, topic, [(None, w.encode()) for w in ["a", "b", "a"]])
        runner1, node1 = _persisted_counts(pw, broker, topic, store)
        assert _drive(pw, runner1, 3) == 3
        assert {r[0]: r[1] for r in node1.current.values()} == {"a": 2, "b": 1}
        del runner1  # crash
        _produce(broker, topic, [(None, w.encode()) for w in ["b", "c"]])
        runner2, node2 = _persisted_counts(pw, broker, topic, store)
        assert _drive(pw, runner2, 3) == 2  # the new messages only
        assert {r[0]: r[1] for r in node2.current.values()} == {"a": 2, "b": 2, "c": 1}
        states[name] = {int(k): tuple(v) for k, v in node2.current.items()}
    assert states["torch"] == states["jax"]
