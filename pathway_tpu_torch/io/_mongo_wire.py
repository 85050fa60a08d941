"""The MongoDB wire protocol: a BSON codec, OP_MSG framing, a client and an in-process
server.

Counterpart of ``pathway_tpu/io/_mongo_wire.py``, speaking the same bytes:

- :func:`encode_bson` / :func:`decode_bson` for the values the document formatter emits
  (string, int64, double, bool, null, binary, documents and arrays; an int32 decodes
  too); another value is written as its text, as the formatter's fallback;
- OP_MSG (opcode 2013) with one kind-0 section, under the 16-byte header (length,
  request id, response to, opcode);
- :class:`MongoWireClient` says ``hello`` and then runs ``insert`` (``insert_many``)
  and ``find`` commands; a reply with ``ok: 0`` raises :class:`MongoError`;
- :class:`FakeMongoServer` answers ``hello``, ``insert``, ``find`` and ``count`` on a
  local port over in-memory collections named ``<db>.<collection>``; ``close`` ends
  every session and joins the server's threads.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Any

from pathway_tpu_torch.io._pg_wire import _close_server

_OP_MSG = 2013


class MongoError(Exception):
    """Command failure ({ok: 0}) or protocol violation."""


# -- BSON codec --------------------------------------------------------------


def _enc_cstring(s: str) -> bytes:
    return s.encode("utf-8") + b"\0"


def encode_bson(doc: dict) -> bytes:
    """dict -> BSON document bytes (spec: bsonspec.org)."""
    body = b""
    for key, value in doc.items():
        body += _encode_element(str(key), value)
    return struct.pack("<i", len(body) + 5) + body + b"\0"


def _encode_element(key: str, v: Any) -> bytes:
    name = _enc_cstring(key)
    if isinstance(v, bool):  # before int: bool subclasses int
        return b"\x08" + name + (b"\x01" if v else b"\x00")
    if isinstance(v, int):
        if -(1 << 63) <= v < (1 << 63):
            return b"\x12" + name + struct.pack("<q", v)
        raise MongoError(f"int out of int64 range: {v}")
    if isinstance(v, float):
        return b"\x01" + name + struct.pack("<d", v)
    if isinstance(v, str):
        enc = v.encode("utf-8")
        return b"\x02" + name + struct.pack("<i", len(enc) + 1) + enc + b"\0"
    if v is None:
        return b"\x0a" + name
    if isinstance(v, (bytes, bytearray)):
        raw = bytes(v)
        return b"\x05" + name + struct.pack("<i", len(raw)) + b"\x00" + raw
    if isinstance(v, dict):
        return b"\x03" + name + encode_bson(v)
    if isinstance(v, (list, tuple)):
        as_doc = {str(i): item for i, item in enumerate(v)}
        return b"\x04" + name + encode_bson(as_doc)
    # exotic values (Json wrappers, pointers) stringify, like the
    # DocumentFormatter's fallback
    return _encode_element(key, str(v))


def decode_bson(data: bytes, offset: int = 0) -> tuple[dict, int]:
    """BSON document bytes -> (dict, end offset)."""
    (length,) = struct.unpack_from("<i", data, offset)
    end = offset + length
    pos = offset + 4
    out: dict = {}
    while pos < end - 1:
        tag = data[pos]
        pos += 1
        name_end = data.index(b"\0", pos)
        key = data[pos:name_end].decode("utf-8")
        pos = name_end + 1
        if tag == 0x01:
            (out[key],) = struct.unpack_from("<d", data, pos)
            pos += 8
        elif tag == 0x02:
            (slen,) = struct.unpack_from("<i", data, pos)
            out[key] = data[pos + 4 : pos + 4 + slen - 1].decode("utf-8")
            pos += 4 + slen
        elif tag in (0x03, 0x04):
            sub, pos = decode_bson(data, pos)
            out[key] = (
                sub if tag == 0x03 else [sub[str(i)] for i in range(len(sub))]
            )
        elif tag == 0x05:
            (blen,) = struct.unpack_from("<i", data, pos)
            out[key] = data[pos + 5 : pos + 5 + blen]
            pos += 5 + blen
        elif tag == 0x08:
            out[key] = data[pos] == 1
            pos += 1
        elif tag == 0x0A:
            out[key] = None
        elif tag == 0x10:
            (out[key],) = struct.unpack_from("<i", data, pos)
            pos += 4
        elif tag == 0x12:
            (out[key],) = struct.unpack_from("<q", data, pos)
            pos += 8
        else:
            raise MongoError(f"unsupported BSON tag 0x{tag:02x}")
    return out, end


# -- OP_MSG framing ----------------------------------------------------------


def _read_exact(sock: socket.socket, buf: bytearray, n: int) -> bytes:
    while len(buf) < n:
        chunk = sock.recv(65536)
        if not chunk:
            raise MongoError("connection closed by peer")
        buf += chunk
    out = bytes(buf[:n])
    del buf[:n]
    return out


def _read_message(sock: socket.socket, buf: bytearray) -> tuple[int, int, dict]:
    """One wire message -> (request_id, response_to, command document)."""
    header = _read_exact(sock, buf, 16)
    length, request_id, response_to, opcode = struct.unpack("<iiii", header)
    body = _read_exact(sock, buf, length - 16)
    if opcode != _OP_MSG:
        raise MongoError(f"unsupported opcode {opcode}")
    (_flags,) = struct.unpack_from("<I", body, 0)
    kind = body[4]
    if kind != 0:
        raise MongoError(f"unsupported OP_MSG section kind {kind}")
    doc, _end = decode_bson(body, 5)
    return request_id, response_to, doc


def _build_message(request_id: int, response_to: int, doc: dict) -> bytes:
    payload = struct.pack("<I", 0) + b"\x00" + encode_bson(doc)
    header = struct.pack(
        "<iiii", 16 + len(payload), request_id, response_to, _OP_MSG
    )
    return header + payload


class MongoWireClient:
    """``insert_many(collection, docs)`` over real OP_MSG frames (the
    MongoWriter client contract, engine/storage.py:422)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 27017,
        database: str = "pathway",
        connect_timeout: float = 10.0,
    ) -> None:
        self.database = database
        self.sock = socket.create_connection(
            (host, port), timeout=connect_timeout
        )
        self._buf = bytearray()
        self._next_id = 1
        hello = self.command({"hello": 1, "$db": "admin"})
        self.server_info = hello
        self.sock.settimeout(None)

    def command(self, doc: dict) -> dict:
        rid = self._next_id
        self._next_id += 1
        self.sock.sendall(_build_message(rid, 0, doc))
        _req, response_to, reply = _read_message(self.sock, self._buf)
        if response_to != rid:
            raise MongoError(
                f"response_to {response_to} does not match request {rid}"
            )
        if not reply.get("ok"):
            raise MongoError(
                f"{reply.get('codeName', 'CommandFailed')}: "
                f"{reply.get('errmsg', reply)}"
            )
        return reply

    def insert_many(self, collection: str, docs: list) -> None:
        reply = self.command(
            {
                "insert": collection,
                "$db": self.database,
                "documents": [dict(d) for d in docs],
                "ordered": True,
            }
        )
        if reply.get("n") != len(docs):
            raise MongoError(
                f"insert acknowledged {reply.get('n')} of {len(docs)}"
            )

    def find(self, collection: str, filter_: dict | None = None) -> list[dict]:
        reply = self.command(
            {
                "find": collection,
                "$db": self.database,
                "filter": filter_ or {},
            }
        )
        return reply["cursor"]["firstBatch"]

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# -- fake mongod -------------------------------------------------------------


class FakeMongoServer:
    """In-process mongod: real OP_MSG frames, BSON decode, in-memory
    collections keyed '<db>.<collection>'."""

    def __init__(self) -> None:
        #: "db.collection" -> stored documents in arrival order
        self.collections: dict[str, list[dict]] = {}
        #: every command name the server decoded, in order
        self.commands: list[str] = []
        self._lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self._closing = False
        #: live sessions: (socket, thread)
        self._sessions: list[tuple[socket.socket, threading.Thread]] = []
        self._thread = threading.Thread(target=self._serve, name="fake-mongo", daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop accepting, end every session and join the server's threads."""
        self._closing = True
        _close_server(self._srv, self._thread, self._sessions, self._lock)

    def _serve(self) -> None:
        while not self._closing:
            try:
                conn, _addr = self._srv.accept()
            except OSError:
                return
            thread = threading.Thread(
                target=self._handle, args=(conn,), name="fake-mongo-session", daemon=True
            )
            with self._lock:
                self._sessions.append((conn, thread))
            thread.start()

    def _handle(self, conn: socket.socket) -> None:
        buf = bytearray()
        try:
            while True:
                request_id, _rt, doc = _read_message(conn, buf)
                reply = self._dispatch(doc)
                conn.sendall(
                    _build_message(10_000 + request_id, request_id, reply)
                )
        except (MongoError, OSError, ValueError):
            pass  # the client went away or broke the protocol: the session ends
        finally:
            conn.close()

    def _dispatch(self, doc: dict) -> dict:
        name = next(iter(doc), "")
        with self._lock:
            self.commands.append(name)
        if name == "hello":
            return {
                "ok": 1.0,
                "isWritablePrimary": True,
                "maxWireVersion": 17,
                "version": "7.0.0-fake",
            }
        db = doc.get("$db", "test")
        if name == "insert":
            key = f"{db}.{doc['insert']}"
            docs = doc.get("documents", [])
            with self._lock:
                self.collections.setdefault(key, []).extend(
                    dict(d) for d in docs
                )
            return {"ok": 1.0, "n": len(docs)}
        if name == "find":
            key = f"{db}.{doc['find']}"
            flt = doc.get("filter") or {}
            with self._lock:
                rows = [
                    d
                    for d in self.collections.get(key, ())
                    if all(d.get(k) == v for k, v in flt.items())
                ]
            return {
                "ok": 1.0,
                "cursor": {
                    "id": 0,
                    "ns": key,
                    "firstBatch": rows,
                },
            }
        if name == "count":
            key = f"{db}.{doc['count']}"
            with self._lock:
                n = len(self.collections.get(key, ()))
            return {"ok": 1.0, "n": n}
        return {
            "ok": 0.0,
            "errmsg": f"no such command: '{name}'",
            "codeName": "CommandNotFound",
        }

    def snapshot(self, namespace: str) -> list[dict]:
        with self._lock:
            return [dict(d) for d in self.collections.get(namespace, ())]
