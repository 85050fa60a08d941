"""The Kafka binary wire protocol: a client, an in-process broker and the transport
that ``pw.io.kafka`` reads and writes through.

Counterpart of ``pathway_tpu/io/_kafka_wire.py``, speaking the same bytes (the
non-flexible request versions, fixed headers):

- ApiVersions v0, Metadata v1, Produce v3, Fetch v4, ListOffsets v1;
- RecordBatch v2 (magic 2, uncompressed): zigzag varints, CRC32C (Castagnoli,
  table-driven) over the section after the crc, record headers.

:class:`KafkaWireClient` is a blocking one-connection client; :class:`FakeKafkaBroker`
is a TCP broker on a local port speaking the same five APIs (one partition a topic,
records kept decoded, topics created on first use), which counts the bytes that cross
it. A Fetch answers with every record after the offset in one batch, whatever
``max_bytes`` asks. :class:`KafkaWireTransport` is the :class:`MessageTransport` over the
client: it reads every partition the topic's metadata reports and produces by the
key's crc32 (keyless messages round-robin). Its ``close()`` waits for a poll in flight
on another thread and ends the read: later polls read nothing and ``finished()`` holds
(the reference's closes the socket under the poll).
"""

from __future__ import annotations

import io
import socket
import struct
import threading
from dataclasses import dataclass, field
from typing import Any

from pathway_tpu_torch.io._pg_wire import _close_server

# -- CRC32C (Castagnoli), table-driven ---------------------------------------

_CRC32C_POLY = 0x82F63B78


def _make_crc32c_table() -> list[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C_TABLE = _make_crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC32C_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# -- varints ------------------------------------------------------------------


def write_uvarint(out: io.BytesIO, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            return


def write_varint(out: io.BytesIO, n: int) -> None:
    write_uvarint(out, (n << 1) ^ (n >> 63) if n < 0 else n << 1)


def read_uvarint(buf: io.BytesIO) -> int:
    shift = 0
    result = 0
    while True:
        (b,) = buf.read(1)
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result
        shift += 7


def read_varint(buf: io.BytesIO) -> int:
    n = read_uvarint(buf)
    return (n >> 1) ^ -(n & 1)


# -- primitive codecs ---------------------------------------------------------


def _w(out: io.BytesIO, fmt: str, *vals: Any) -> None:
    out.write(struct.pack(">" + fmt, *vals))


def _r(buf: io.BytesIO, fmt: str):
    size = struct.calcsize(">" + fmt)
    vals = struct.unpack(">" + fmt, buf.read(size))
    return vals[0] if len(vals) == 1 else vals


def _w_string(out: io.BytesIO, s: str | None) -> None:
    if s is None:
        _w(out, "h", -1)
    else:
        b = s.encode()
        _w(out, "h", len(b))
        out.write(b)


def _r_string(buf: io.BytesIO) -> str | None:
    n = _r(buf, "h")
    if n < 0:
        return None
    return buf.read(n).decode()


def _w_bytes(out: io.BytesIO, b: bytes | None) -> None:
    if b is None:
        _w(out, "i", -1)
    else:
        _w(out, "i", len(b))
        out.write(b)


def _r_bytes(buf: io.BytesIO) -> bytes | None:
    n = _r(buf, "i")
    if n < 0:
        return None
    return buf.read(n)


# -- RecordBatch v2 -----------------------------------------------------------


@dataclass
class WireRecord:
    value: bytes | None
    key: bytes | None = None
    timestamp: int = 0
    headers: list[tuple[str, bytes]] = field(default_factory=list)
    offset: int = 0  # absolute, filled by decode


def encode_record_batch(records: list[WireRecord], base_offset: int) -> bytes:
    """RecordBatch (magic 2, uncompressed)."""
    first_ts = records[0].timestamp if records else 0
    max_ts = max((r.timestamp for r in records), default=0)
    body = io.BytesIO()
    _w(body, "h", 0)  # attributes: no compression
    _w(body, "i", len(records) - 1)  # last_offset_delta
    _w(body, "qq", first_ts, max_ts)
    _w(body, "qhi", -1, -1, -1)  # producer id/epoch, base sequence
    _w(body, "i", len(records))
    for i, rec in enumerate(records):
        r = io.BytesIO()
        r.write(b"\x00")  # record attributes
        write_varint(r, rec.timestamp - first_ts)
        write_varint(r, i)  # offset delta
        for blob in (rec.key, rec.value):
            if blob is None:
                write_varint(r, -1)
            else:
                write_varint(r, len(blob))
                r.write(blob)
        write_varint(r, len(rec.headers))
        for hk, hv in rec.headers:
            kb = hk.encode()
            write_varint(r, len(kb))
            r.write(kb)
            write_varint(r, len(hv))
            r.write(hv)
        rb = r.getvalue()
        write_varint(body, len(rb))
        body.write(rb)
    payload = body.getvalue()
    crc = crc32c(payload)
    inner = io.BytesIO()
    _w(inner, "i", 0)  # partition leader epoch
    _w(inner, "b", 2)  # magic
    _w(inner, "I", crc)
    inner.write(payload)
    inner_b = inner.getvalue()
    out = io.BytesIO()
    _w(out, "q", base_offset)
    _w(out, "i", len(inner_b))
    out.write(inner_b)
    return out.getvalue()


def decode_record_batches(data: bytes) -> list[WireRecord]:
    """All records of all batches in a fetched record set."""
    buf = io.BytesIO(data)
    out: list[WireRecord] = []
    while True:
        head = buf.read(12)
        if len(head) < 12:
            return out
        base_offset, length = struct.unpack(">qi", head)
        inner = io.BytesIO(buf.read(length))
        _r(inner, "i")  # leader epoch
        magic = _r(inner, "b")
        if magic != 2:
            raise ValueError(f"unsupported record batch magic {magic}")
        crc = _r(inner, "I")
        payload = inner.read()
        if crc32c(payload) != crc:
            raise ValueError("record batch CRC32C mismatch")
        body = io.BytesIO(payload)
        _r(body, "h")  # attributes
        _r(body, "i")  # last offset delta
        first_ts, _max_ts = _r(body, "qq")
        _r(body, "qhi")
        n = _r(body, "i")
        for _ in range(n):
            rlen = read_varint(body)
            r = io.BytesIO(body.read(rlen))
            r.read(1)  # attributes
            ts_delta = read_varint(r)
            off_delta = read_varint(r)
            klen = read_varint(r)
            key = r.read(klen) if klen >= 0 else None
            vlen = read_varint(r)
            value = r.read(vlen) if vlen >= 0 else None
            headers = []
            for _h in range(read_varint(r)):
                hklen = read_varint(r)
                hk = r.read(hklen).decode()
                hvlen = read_varint(r)
                hv = r.read(hvlen) if hvlen >= 0 else b""
                headers.append((hk, hv))
            out.append(
                WireRecord(
                    value=value,
                    key=key,
                    timestamp=first_ts + ts_delta,
                    headers=headers,
                    offset=base_offset + off_delta,
                )
            )


# -- framing ------------------------------------------------------------------

API_VERSIONS = 18
METADATA = 3
PRODUCE = 0
FETCH = 1
LIST_OFFSETS = 2


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        got = sock.recv(n)
        if not got:
            raise ConnectionError("kafka connection closed")
        chunks.append(got)
        n -= len(got)
    return b"".join(chunks)


class KafkaWireClient:
    """Blocking single-connection Kafka protocol client."""

    def __init__(
        self, host: str, port: int, client_id: str = "pathway-tpu"
    ) -> None:
        self.sock = socket.create_connection((host, port), timeout=30)
        self.client_id = client_id
        self._corr = 0
        self._lock = threading.Lock()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def _call(self, api_key: int, api_version: int, body: bytes) -> io.BytesIO:
        with self._lock:
            self._corr += 1
            corr = self._corr
            head = io.BytesIO()
            _w(head, "hhi", api_key, api_version, corr)
            _w_string(head, self.client_id)
            frame = head.getvalue() + body
            # the lock pairs each request with its response
            self.sock.sendall(struct.pack(">i", len(frame)) + frame)
            (length,) = struct.unpack(">i", _recv_exact(self.sock, 4))
            resp = io.BytesIO(_recv_exact(self.sock, length))
            got_corr = _r(resp, "i")
            if got_corr != corr:
                raise ValueError(
                    f"correlation id mismatch: {got_corr} != {corr}"
                )
            return resp

    def api_versions(self) -> dict[int, tuple[int, int]]:
        resp = self._call(API_VERSIONS, 0, b"")
        error = _r(resp, "h")
        if error:
            raise ValueError(f"ApiVersions error {error}")
        out = {}
        for _ in range(_r(resp, "i")):
            key, lo, hi = _r(resp, "hhh")
            out[key] = (lo, hi)
        return out

    def metadata(self, topics: list[str] | None = None) -> dict:
        body = io.BytesIO()
        if topics is None:
            _w(body, "i", -1)
        else:
            _w(body, "i", len(topics))
            for t in topics:
                _w_string(body, t)
        resp = self._call(METADATA, 1, body.getvalue())
        brokers = []
        for _ in range(_r(resp, "i")):
            node = _r(resp, "i")
            host = _r_string(resp)
            port = _r(resp, "i")
            _r_string(resp)  # rack
            brokers.append({"node_id": node, "host": host, "port": port})
        controller = _r(resp, "i")
        topics_out = {}
        for _ in range(_r(resp, "i")):
            terr = _r(resp, "h")
            name = _r_string(resp)
            _r(resp, "?")  # is_internal
            parts = []
            for _p in range(_r(resp, "i")):
                perr = _r(resp, "h")
                pid = _r(resp, "i")
                leader = _r(resp, "i")
                replicas = [_r(resp, "i") for _x in range(_r(resp, "i"))]
                isr = [_r(resp, "i") for _x in range(_r(resp, "i"))]
                parts.append(
                    {
                        "error": perr,
                        "partition": pid,
                        "leader": leader,
                        "replicas": replicas,
                        "isr": isr,
                    }
                )
            topics_out[name] = {"error": terr, "partitions": parts}
        return {
            "brokers": brokers,
            "controller": controller,
            "topics": topics_out,
        }

    def produce(
        self,
        topic: str,
        partition: int,
        records: list[WireRecord],
        acks: int = -1,
        timeout_ms: int = 30000,
    ) -> int:
        """Returns the base offset assigned by the broker."""
        batch = encode_record_batch(records, base_offset=0)
        body = io.BytesIO()
        _w_string(body, None)  # transactional id
        _w(body, "hi", acks, timeout_ms)
        _w(body, "i", 1)  # one topic
        _w_string(body, topic)
        _w(body, "i", 1)  # one partition
        _w(body, "i", partition)
        _w_bytes(body, batch)
        resp = self._call(PRODUCE, 3, body.getvalue())
        base_offset = -1
        for _ in range(_r(resp, "i")):
            _r_string(resp)
            for _p in range(_r(resp, "i")):
                _pid = _r(resp, "i")
                err = _r(resp, "h")
                base_offset = _r(resp, "q")
                _r(resp, "q")  # log append time
                if err:
                    raise ValueError(f"Produce error {err}")
        _r(resp, "i")  # throttle
        return base_offset

    def list_offsets(
        self, topic: str, partition: int, timestamp: int = -1
    ) -> int:
        """-1 = latest (end offset), -2 = earliest."""
        body = io.BytesIO()
        _w(body, "i", -1)  # replica id
        _w(body, "i", 1)
        _w_string(body, topic)
        _w(body, "i", 1)
        _w(body, "iq", partition, timestamp)
        resp = self._call(LIST_OFFSETS, 1, body.getvalue())
        offset = -1
        for _ in range(_r(resp, "i")):
            _r_string(resp)
            for _p in range(_r(resp, "i")):
                _pid = _r(resp, "i")
                err = _r(resp, "h")
                _r(resp, "q")  # timestamp
                offset = _r(resp, "q")
                if err:
                    raise ValueError(f"ListOffsets error {err}")
        return offset

    def fetch(
        self,
        topic: str,
        partition: int,
        offset: int,
        max_wait_ms: int = 100,
        max_bytes: int = 1 << 22,
    ) -> tuple[list[WireRecord], int]:
        """(records from ``offset``, high watermark)."""
        body = io.BytesIO()
        _w(body, "i", -1)  # replica id
        _w(body, "ii", max_wait_ms, 1)  # max wait, min bytes
        _w(body, "i", max_bytes)
        _w(body, "b", 0)  # isolation level
        _w(body, "i", 1)
        _w_string(body, topic)
        _w(body, "i", 1)
        _w(body, "iqi", partition, offset, max_bytes)
        resp = self._call(FETCH, 4, body.getvalue())
        _r(resp, "i")  # throttle
        records: list[WireRecord] = []
        high_watermark = -1
        for _ in range(_r(resp, "i")):
            _r_string(resp)
            for _p in range(_r(resp, "i")):
                _pid = _r(resp, "i")
                err = _r(resp, "h")
                high_watermark = _r(resp, "q")
                _r(resp, "q")  # last stable offset
                for _a in range(_r(resp, "i")):  # aborted txns
                    _r(resp, "qq")
                record_set = _r_bytes(resp) or b""
                if err:
                    raise ValueError(f"Fetch error {err}")
                records.extend(
                    r
                    for r in decode_record_batches(record_set)
                    if r.offset >= offset
                )
        return records, high_watermark


# -- in-process broker --------------------------------------------------------


class FakeKafkaBroker:
    """A TCP server speaking the same five Kafka APIs (one partition per
    topic, records stored decoded). Frames on the socket are genuine
    Kafka protocol bytes — tests round-trip through real encode/decode on
    both sides of a real socket."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.host, self.port = self._srv.getsockname()
        self.logs: dict[str, list[WireRecord]] = {}
        #: request and response bytes that crossed the broker's sockets, frames included
        self.bytes_received = 0
        self.bytes_sent = 0
        self._lock = threading.Lock()
        self._closing = threading.Event()
        #: live sessions: (socket, thread)
        self._sessions: list[tuple[socket.socket, threading.Thread]] = []
        self._thread = threading.Thread(
            target=self._accept_loop, name="fake-kafka", daemon=True
        )
        self._thread.start()

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        """Stop accepting, end every session and join the broker's threads."""
        if self._closing.is_set():
            return
        self._closing.set()
        _close_server(self._srv, self._thread, self._sessions, self._lock)

    def __enter__(self) -> "FakeKafkaBroker":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def _accept_loop(self) -> None:
        while not self._closing.is_set():
            try:
                conn, _addr = self._srv.accept()
            except OSError:
                return
            thread = threading.Thread(
                target=self._serve_conn, args=(conn,), name="fake-kafka-session", daemon=True
            )
            with self._lock:
                self._sessions.append((conn, thread))
            thread.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while True:
                (length,) = struct.unpack(">i", _recv_exact(conn, 4))
                req = io.BytesIO(_recv_exact(conn, length))
                api_key, api_version, corr = _r(req, "hhi")
                _r_string(req)  # client id
                body = self._dispatch(api_key, api_version, req)
                frame = struct.pack(">i", corr) + body
                conn.sendall(struct.pack(">i", len(frame)) + frame)
                with self._lock:
                    self.bytes_received += 4 + length
                    self.bytes_sent += 4 + len(frame)
        except (ConnectionError, struct.error, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- request handling ----------------------------------------------------

    def _dispatch(self, api_key: int, version: int, req: io.BytesIO) -> bytes:
        if api_key == API_VERSIONS:
            out = io.BytesIO()
            _w(out, "h", 0)
            supported = [
                (PRODUCE, 3, 3),
                (FETCH, 4, 4),
                (LIST_OFFSETS, 1, 1),
                (METADATA, 1, 1),
                (API_VERSIONS, 0, 0),
            ]
            _w(out, "i", len(supported))
            for key, lo, hi in supported:
                _w(out, "hhh", key, lo, hi)
            return out.getvalue()
        if api_key == METADATA:
            n = _r(req, "i")
            names = (
                list(self.logs)
                if n < 0
                else [_r_string(req) for _ in range(n)]
            )
            out = io.BytesIO()
            _w(out, "i", 1)  # one broker
            _w(out, "i", 0)
            _w_string(out, self.host)
            _w(out, "i", self.port)
            _w_string(out, None)  # rack
            _w(out, "i", 0)  # controller
            _w(out, "i", len(names))
            for name in names:
                with self._lock:
                    self.logs.setdefault(name, [])  # auto-create topics
                _w(out, "h", 0)
                _w_string(out, name)
                _w(out, "?", False)
                _w(out, "i", 1)  # one partition
                _w(out, "h", 0)
                _w(out, "i", 0)  # partition id
                _w(out, "i", 0)  # leader
                _w(out, "i", 1)
                _w(out, "i", 0)  # replicas
                _w(out, "i", 1)
                _w(out, "i", 0)  # isr
            return out.getvalue()
        if api_key == PRODUCE:
            _r_string(req)  # transactional id
            _r(req, "hi")  # acks, timeout
            out_topics = []
            for _ in range(_r(req, "i")):
                topic = _r_string(req)
                for _p in range(_r(req, "i")):
                    _pid = _r(req, "i")
                    record_set = _r_bytes(req) or b""
                    records = decode_record_batches(record_set)
                    with self._lock:
                        log = self.logs.setdefault(topic, [])
                        base = len(log)
                        for i, rec in enumerate(records):
                            rec.offset = base + i
                            log.append(rec)
                    out_topics.append((topic, 0, base))
            out = io.BytesIO()
            _w(out, "i", len(out_topics))
            for topic, pid, base in out_topics:
                _w_string(out, topic)
                _w(out, "i", 1)
                _w(out, "i", pid)
                _w(out, "h", 0)
                _w(out, "q", base)
                _w(out, "q", -1)
            _w(out, "i", 0)  # throttle
            return out.getvalue()
        if api_key == LIST_OFFSETS:
            _r(req, "i")  # replica
            answers = []
            for _ in range(_r(req, "i")):
                topic = _r_string(req)
                for _p in range(_r(req, "i")):
                    pid = _r(req, "i")
                    ts = _r(req, "q")
                    with self._lock:
                        end = len(self.logs.get(topic, []))
                    answers.append((topic, pid, 0 if ts == -2 else end))
            out = io.BytesIO()
            _w(out, "i", len(answers))
            for topic, pid, offset in answers:
                _w_string(out, topic)
                _w(out, "i", 1)
                _w(out, "i", pid)
                _w(out, "h", 0)
                _w(out, "q", -1)
                _w(out, "q", offset)
            return out.getvalue()
        if api_key == FETCH:
            _r(req, "i")  # replica
            _r(req, "ii")  # max wait, min bytes
            _r(req, "i")  # max bytes
            _r(req, "b")  # isolation
            answers = []
            for _ in range(_r(req, "i")):
                topic = _r_string(req)
                for _p in range(_r(req, "i")):
                    pid = _r(req, "i")
                    offset = _r(req, "q")
                    _r(req, "i")  # partition max bytes
                    with self._lock:
                        log = list(self.logs.get(topic, []))
                    tail = log[offset:]
                    record_set = (
                        encode_record_batch(tail, base_offset=offset)
                        if tail
                        else b""
                    )
                    answers.append((topic, pid, len(log), record_set))
            out = io.BytesIO()
            _w(out, "i", 0)  # throttle
            _w(out, "i", len(answers))
            for topic, pid, high, record_set in answers:
                _w_string(out, topic)
                _w(out, "i", 1)
                _w(out, "i", pid)
                _w(out, "h", 0)
                _w(out, "q", high)
                _w(out, "q", high)  # last stable offset
                _w(out, "i", 0)  # aborted txns
                _w_bytes(out, record_set)
            return out.getvalue()
        raise ValueError(f"unsupported api key {api_key}")


# -- MessageTransport adapter -------------------------------------------------


class KafkaWireTransport:
    """MessageTransport over :class:`KafkaWireClient` — the production
    Kafka path (pw.io.kafka.read/write default when ``transport=None``).

    Consumes EVERY partition the topic metadata reports, with
    per-partition offsets; produces by key hash (keyless messages
    round-robin). ``mode='streaming'`` finishes only once closed;
    ``mode='static'`` snapshots each partition's end offset at first poll
    and finishes once all are reached."""

    def __init__(
        self,
        bootstrap: str,
        topic: str,
        mode: str = "streaming",
        start: str = "earliest",
    ) -> None:
        host, _, port = bootstrap.partition(":")
        self.client = KafkaWireClient(host, int(port or 9092))
        self.topic = topic
        self.mode = mode
        meta = self.client.metadata([topic])
        parts = meta["topics"].get(topic, {}).get("partitions", [])
        self.partitions = sorted(p["partition"] for p in parts) or [0]
        ts = -2 if start == "earliest" else -1
        self._offsets = {
            p: self.client.list_offsets(topic, p, ts)
            for p in self.partitions
        }
        self._stop_at: dict[int, int] | None = None
        self._rr = 0
        self._closed = False
        self._poll_lock = threading.Lock()

    def produce(self, value: Any, key: Any = None) -> None:
        if isinstance(value, str):
            value = value.encode()
        if isinstance(key, str):
            key = key.encode()
        if key is not None:
            import zlib

            partition = self.partitions[
                zlib.crc32(key) % len(self.partitions)
            ]
        else:
            partition = self.partitions[self._rr % len(self.partitions)]
            self._rr += 1
        self.client.produce(
            self.topic, partition, [WireRecord(value=value, key=key)]
        )

    def poll_messages(self) -> list:
        from pathway_tpu_torch.engine.storage import Message

        with self._poll_lock:
            if self._closed:
                return []
            if self._stop_at is None and self.mode == "static":
                self._stop_at = {
                    p: self.client.list_offsets(self.topic, p, -1)
                    for p in self.partitions
                }
            out = []
            for p in self.partitions:
                records, _high = self.client.fetch(self.topic, p, self._offsets[p])
                for rec in records:
                    self._offsets[p] = rec.offset + 1
                    out.append(
                        Message(
                            rec.value,
                            key=rec.key,
                            topic=self.topic,
                            partition=p,
                            offset=rec.offset,
                        )
                    )
            return out

    def close(self) -> None:
        """End the transport: wait for a poll in flight, then close the connection."""
        with self._poll_lock:
            self._closed = True
            self.client.close()

    def finished(self) -> bool:
        if self._closed:
            return True
        if self.mode == "static" and self._stop_at is not None:
            return all(
                self._offsets[p] >= end
                for p, end in self._stop_at.items()
            )
        return False
