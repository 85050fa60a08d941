"""Database, message-queue and object-store readers and writers over injected clients.

Counterpart of the first part of ``pathway_tpu/engine/storage.py``:

- :class:`TransparentParser` passes a reader's own :class:`ParsedEvent` lists through;
- :class:`SqliteReader` polls a SQLite table: ``PRAGMA data_version`` is the cheap
  change hint (it moves on writes from *other* connections), then the whole table is
  scanned again and diffed by rowid: a new rowid inserts, a changed row deletes and
  inserts, a missing rowid deletes; every event is keyed by its rowid;
- :class:`ObjectStoreClient` is the S3-shaped seam (``list_objects(prefix)`` of ``(key,
  signature)`` pairs, ``get_object(key)``, ``put_object`` for writes), with
  :class:`DictObjectStore` in memory; :class:`ObjectStoreReader` scans a prefix (a new
  key inserts, a new signature replaces the key's rows, a vanished key retracts them)
  and :class:`ObjectStoreWriter` puts one JSON-lines object a commit.

- :class:`Message` is one queue record; a :class:`MessageTransport` (``poll_messages``,
  ``finished``, and ``produce`` for writes) is what a Kafka, Redpanda or NATS consumer
  provides (``io/_kafka_wire.py``, ``io/_nats_wire.py``), with
  :class:`InMemoryTransport` in memory; :class:`MessageQueueReader` hands the parser
  ``(key, value)`` pairs and keeps each (topic, partition)'s last offset in ``state()``,
  so that after ``restore_state`` it drops what a transport delivers again (a
  transport with ``seek`` is also moved past it); :class:`MessageQueueWriter` produces
  one message a change.

- the database writers: :class:`SqlExecutor` is the statement seam (``execute(statement,
  params)`` with ``$N`` placeholders, and ``commit``) that ``io/_pg_wire.py``'s
  connection provides; :class:`PsqlWriter` runs one statement a change and commits at
  the end of every engine commit (a per-commit transaction); :class:`ElasticsearchWriter`
  indexes one document a change and flushes its client (one ``_bulk`` request) a
  commit; :class:`MongoWriter` buffers a commit's documents into one ``insert_many``.

``DictObjectStore.list_objects`` hashes every object on every poll, as the reference
does: its signature is the md5 of the bytes.
"""

from __future__ import annotations

import hashlib
import sqlite3
from typing import Any, Protocol, Sequence

from pathway_tpu_torch.engine.connectors import DELETE, INSERT, ParsedEvent, Parser, Reader
from pathway_tpu_torch.engine.value import Pointer

__all__ = [
    "DictObjectStore",
    "ElasticsearchWriter",
    "InMemoryTransport",
    "Message",
    "MessageQueueReader",
    "MessageQueueWriter",
    "MessageTransport",
    "MongoWriter",
    "ObjectStoreClient",
    "ObjectStoreReader",
    "ObjectStoreWriter",
    "PsqlWriter",
    "SqlExecutor",
    "SqliteReader",
    "TransparentParser",
]


class TransparentParser(Parser):
    """The reader already produced ParsedEvents: pass them through."""

    def __init__(self, column_names: Sequence[str], session_type: str = "native"):
        super().__init__(column_names)
        self.session_type = session_type

    def parse(self, payload: Any) -> list[ParsedEvent]:
        return list(payload)


# -- SQLite -------------------------------------------------------------------


class SqliteReader(Reader):
    """Poll a SQLite table and emit insert and delete events keyed by rowid, so an
    update revises the same engine row. A poll whose ``PRAGMA data_version`` has not
    moved since the last scan reads nothing; otherwise the table is scanned whole
    (``SELECT cols, _rowid_``) and diffed against the rows kept from the last scan."""

    def __init__(
        self,
        path: str,
        table_name: str,
        column_names: Sequence[str],
        mode: str = "streaming",
    ) -> None:
        self.path = path
        self.table_name = table_name
        self.column_names = list(column_names)
        self.mode = mode
        self._conn: sqlite3.Connection | None = None
        self._state: dict[int, tuple] = {}
        self._last_version: int | None = None
        self._done_static = False

    def _connection(self) -> sqlite3.Connection:
        if self._conn is None:
            self._conn = sqlite3.connect(self.path)
        return self._conn

    def _scan(self) -> list[ParsedEvent]:
        cols = ",".join(self.column_names)
        rows = self._connection().execute(f"SELECT {cols},_rowid_ FROM {self.table_name}").fetchall()
        events: list[ParsedEvent] = []
        state = self._state
        present: set[int] = set()
        for row in rows:
            rowid = row[-1]
            values = tuple(row[:-1])
            present.add(rowid)
            prev = state.get(rowid)
            if prev is None:
                events.append(ParsedEvent(INSERT, values, key=(rowid,)))
                state[rowid] = values
            elif prev != values:
                events.append(ParsedEvent(DELETE, prev, key=(rowid,)))
                events.append(ParsedEvent(INSERT, values, key=(rowid,)))
                state[rowid] = values
        for rowid in list(state):
            if rowid not in present:
                events.append(ParsedEvent(DELETE, state.pop(rowid), key=(rowid,)))
        return events

    def poll(self) -> tuple[list[tuple[Any, str, dict]], bool]:
        if self._done_static:
            return [], True
        version = self._connection().execute("PRAGMA data_version").fetchone()[0]
        if self._last_version == version and self._state:
            # data_version moves only on writes from other connections
            return [], self.mode == "static"
        self._last_version = version
        events = self._scan()
        if self.mode == "static":
            self._done_static = True
        src = f"sqlite:{self.path}:{self.table_name}"
        return ([(events, src, {})] if events else []), self.mode == "static"

    # -- persistence (engine/persistence.py) ----------------------------------

    def state(self) -> dict:
        return {
            "rows": {str(k): list(v) for k, v in self._state.items()},
            "done_static": self._done_static,
        }

    def restore_state(self, state: dict) -> None:
        self._state = {int(k): tuple(v) for k, v in state.get("rows", {}).items()}
        self._done_static = bool(state.get("done_static", False))


# -- message transports ---------------------------------------------------------


class Message:
    """One queue record: its key and value bytes and where it came from."""

    __slots__ = ("key", "value", "topic", "partition", "offset")

    def __init__(
        self,
        value: bytes | str | None,
        key: bytes | str | None = None,
        topic: str = "",
        partition: int = 0,
        offset: int = 0,
    ) -> None:
        self.key = key
        self.value = value
        self.topic = topic
        self.partition = partition
        self.offset = offset


class MessageTransport(Protocol):
    """What a Kafka, Redpanda or NATS consumer provides; tests inject
    :class:`InMemoryTransport`."""

    def poll_messages(self) -> list[Message]: ...

    def finished(self) -> bool: ...


class InMemoryTransport:
    """An in-memory :class:`MessageTransport`: produce messages, then optionally close
    it; it is finished once closed and read to its end. One producer thread."""

    def __init__(self, topic: str = "topic") -> None:
        self.topic = topic
        self._messages: list[Message] = []
        self._offset = 0
        self._closed = False

    def produce(self, value: Any, key: Any = None) -> None:
        self._messages.append(
            Message(value, key=key, topic=self.topic, partition=0, offset=len(self._messages))
        )

    def close(self) -> None:
        self._closed = True

    def poll_messages(self) -> list[Message]:
        out = self._messages[self._offset :]
        self._offset = len(self._messages)
        return out

    def finished(self) -> bool:
        return self._closed and self._offset == len(self._messages)


class MessageQueueReader(Reader):
    """A reader over a :class:`MessageTransport`: each message becomes one ``(key,
    value)`` payload, its source ``<topic>:<partition>``. A message at or below the
    last offset seen on its (topic, partition) is dropped: a resumed transport that
    reads from the start again emits only what is new."""

    def __init__(self, transport: Any) -> None:
        self.transport = transport
        self._offsets: dict[tuple[str, int], int] = {}

    def poll(self) -> tuple[list[tuple[Any, str, dict]], bool]:
        entries = []
        offsets = self._offsets
        for msg in self.transport.poll_messages():
            coord = (msg.topic, msg.partition)
            seen = offsets.get(coord)
            if seen is not None and msg.offset <= seen:
                continue  # consumed before a resume
            offsets[coord] = msg.offset
            entries.append(
                (
                    (msg.key, msg.value),
                    f"{msg.topic}:{msg.partition}",
                    {"topic": msg.topic, "partition": msg.partition, "offset": msg.offset},
                )
            )
        return entries, self.transport.finished()

    # -- persistence (engine/persistence.py) ----------------------------------

    def state(self) -> dict:
        return {"offsets": {f"{t}\x00{p}": o for (t, p), o in self._offsets.items()}}

    def restore_state(self, state: dict) -> None:
        self._offsets = {}
        for k, o in state.get("offsets", {}).items():
            topic, _, part = k.partition("\x00")
            self._offsets[(topic, int(part))] = int(o)
        seek = getattr(self.transport, "seek", None)
        if seek is not None:
            for (topic, part), o in self._offsets.items():
                seek(topic, part, o + 1)


class MessageQueueWriter:
    """Produce one message a change onto a transport (``produce(value, key=)``); the
    message key is the ``key_index`` column's text, else None. A transport with
    ``flush`` is flushed at the end of every commit."""

    def __init__(
        self,
        transport: Any,
        formatter: Any,
        column_names: Sequence[str],
        key_index: int | None = None,
    ) -> None:
        self.transport = transport
        self.formatter = formatter
        self.column_names = list(column_names)
        self.key_index = key_index

    def on_change(self, key: Pointer, values: tuple, time: int, diff: int) -> None:
        payload = self.formatter.format(key, values, self.column_names, time, diff)
        msg_key = None
        if self.key_index is not None:
            msg_key = str(values[self.key_index]).encode()
        self.transport.produce(payload, key=msg_key)

    def on_time_end(self, time: int) -> None:
        flush = getattr(self.transport, "flush", None)
        if flush is not None:
            flush()

    def on_end(self) -> None:
        self.on_time_end(-1)


# -- databases ------------------------------------------------------------------


class SqlExecutor(Protocol):
    """Runs one statement with ``$N``-style params (``io/_pg_wire.py``'s connection, or
    ``io/postgres.py::psycopg2_adapter`` around a psycopg2 connection); a ``commit``
    method, where there is one, ends the commit's transaction."""

    def execute(self, statement: str, params: Sequence[Any]) -> None: ...


class PsqlWriter:
    """Postgres sink: one statement a change from a Psql formatter (``engine/formats.py``)
    through an executor, and the executor's ``commit`` at the end of every engine commit,
    so each commit is one transaction."""

    def __init__(self, executor: Any, formatter: Any) -> None:
        self.executor = executor
        self.formatter = formatter

    def on_change(self, key: Pointer, values: tuple, time: int, diff: int) -> None:
        stmt, params = self.formatter.format(key, values, time, diff)
        self.executor.execute(stmt, params)

    def on_time_end(self, time: int) -> None:
        commit = getattr(self.executor, "commit", None)
        if commit is not None:
            commit()

    def on_end(self) -> None:
        self.on_time_end(-1)


class ElasticsearchWriter:
    """Index one document a change (``client.index(index_name, document)``); a client
    with ``flush`` (the bulk client) is flushed at the end of every commit, one
    ``_bulk`` request a commit."""

    def __init__(self, client: Any, index_name: str, formatter: Any) -> None:
        self.client = client
        self.index_name = index_name
        self.formatter = formatter

    def on_change(self, key: Pointer, values: tuple, time: int, diff: int) -> None:
        self.client.index(self.index_name, self.formatter.format(key, values, time, diff))

    def on_time_end(self, time: int) -> None:
        flush = getattr(self.client, "flush", None)
        if flush is not None:
            flush()

    def on_end(self) -> None:
        self.on_time_end(-1)


class MongoWriter:
    """Buffer a commit's documents (row, ``time`` and ``diff``) and insert them with
    one ``client.insert_many(collection, documents)`` at the commit's end."""

    def __init__(self, client: Any, collection: str, formatter: Any) -> None:
        self.client = client
        self.collection = collection
        self.formatter = formatter
        self._batch: list[dict] = []

    def on_change(self, key: Pointer, values: tuple, time: int, diff: int) -> None:
        self._batch.append(self.formatter.format(key, values, time, diff))

    def on_time_end(self, time: int) -> None:
        if self._batch:
            self.client.insert_many(self.collection, self._batch)
            self._batch = []

    def on_end(self) -> None:
        self.on_time_end(-1)


# -- object store (S3-shaped) --------------------------------------------------


class ObjectStoreClient(Protocol):
    """An S3-shaped client: the keys under a prefix with a version signature (an
    etag), and one object's bytes. boto3 adapts in a few lines (``pw.io.s3``'s
    ``AwsS3Settings.create_client``); tests use :class:`DictObjectStore`."""

    def list_objects(self, prefix: str) -> list[tuple[str, str]]:
        """-> [(key, version signature)]"""
        ...

    def get_object(self, key: str) -> bytes: ...


class DictObjectStore:
    """An in-memory :class:`ObjectStoreClient`; a key's signature is the md5 of its
    bytes."""

    def __init__(self) -> None:
        self.objects: dict[str, bytes] = {}
        self._version = 0

    def put_object(self, key: str, data: bytes | str) -> None:
        if isinstance(data, str):
            data = data.encode("utf-8")
        self._version += 1
        self.objects[key] = data

    def delete_object(self, key: str) -> None:
        self.objects.pop(key, None)

    def list_objects(self, prefix: str) -> list[tuple[str, str]]:
        return [
            (key, hashlib.md5(self.objects[key]).hexdigest())
            for key in sorted(self.objects)
            if key.startswith(prefix)
        ]

    def get_object(self, key: str) -> bytes:
        return self.objects[key]


class ObjectStoreReader(Reader):
    """Scan an object-store prefix: a new key inserts its rows, a changed signature
    replaces them, a deleted key retracts them (streaming mode); static mode reads the
    listing once."""

    replaces_sources = True

    def __init__(self, client: Any, prefix: str, mode: str = "streaming", binary: bool = False) -> None:
        self.client = client
        self.prefix = prefix
        self.mode = mode
        self.binary = binary
        self._seen: dict[str, str] = {}
        self._done_static = False

    def _payload(self, key: str) -> Any:
        data = self.client.get_object(key)
        return data if self.binary else data.decode("utf-8", errors="replace")

    def poll(self) -> tuple[list[tuple[Any, str, dict]], bool]:
        if self._done_static:
            return [], True
        entries = []
        current = dict(self.client.list_objects(self.prefix))
        for key, sig in current.items():
            if self._seen.get(key) != sig:
                entries.append((self._payload(key), key, {"path": key, "deleted": False}))
        for key in set(self._seen) - set(current):
            entries.append((None, key, {"path": key, "deleted": True}))
        self._seen = current
        if self.mode == "static":
            self._done_static = True
        return entries, self.mode == "static"

    def state(self) -> dict:
        return {"seen": dict(self._seen), "done_static": self._done_static}

    def restore_state(self, state: dict) -> None:
        self._seen = dict(state.get("seen", {}))
        self._done_static = False


class ObjectStoreWriter:
    """Put one object a commit under ``prefix``, ``part-<n>-<time>.jsonl``, holding the
    commit's changes formatted a line each (the reference's S3 file sink)."""

    def __init__(self, client: Any, prefix: str, formatter: Any, column_names: Sequence[str]) -> None:
        self.client = client
        self.prefix = prefix.rstrip("/")
        self.formatter = formatter
        self.column_names = list(column_names)
        self._lines: list[str] = []
        self._part = 0

    def on_change(self, key: Pointer, values: tuple, time: int, diff: int) -> None:
        self._lines.append(self.formatter.format(key, values, self.column_names, time, diff))

    def on_time_end(self, time: int) -> None:
        if not self._lines:
            return
        name = f"{self.prefix}/part-{self._part:06d}-{time}.jsonl"
        self.client.put_object(name, "\n".join(self._lines) + "\n")
        self._lines = []
        self._part += 1

    def on_end(self) -> None:
        self.on_time_end(-1)
