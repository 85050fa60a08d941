"""Connector framework: a Reader's payloads, parsed into events, fed into an
InputSession; and the writers that a subscription feeds.

Counterpart of ``pathway_tpu/engine/connectors.py``: each source is an
:class:`InputDriver` polled by the streaming run loop between commits. A
:class:`QueueReader` takes the payloads that a source's own thread pushes (the python
connector); an :class:`FsReader` scans a file, a directory or a glob, once (static) or
on every poll (streaming: new files insert, changed files replace their rows, deleted
files retract them). The parsers turn a payload into events: delimiter-separated values
with a header (:class:`DsvParser`), one JSON object a line (:class:`JsonLinesParser`),
and the whole payload or its lines (:class:`IdentityParser`). Rows without a primary
key get the reference's key, ``hash_values((source_name, source_id, index, seq),
salt=b"connector")`` (hashed a payload at a time by the host kernels), so the same files
and paths give the same keys in both packages. The sinks' side: :class:`JsonLinesFormatter`,
:class:`DsvFormatter` and :class:`FileWriter`, whose ``<path>.pw-offsets`` sidecar lets
a process relaunched under the same ``PATHWAY_RUN_ID`` resume its file past the last
durable commit.

Each driver counts its entries and poll batches (``pathway_connector_entries_total``,
``pathway_connector_batches_total``, labelled by connector), stamps its oldest
uncommitted row (``first_pending_wall``, the start of the ingest-to-sink latency and of
a trace's ``ingest-wait`` span), and retries a reader poll that raises ``OSError``
(``PATHWAY_TPU_CONNECTOR_RETRIES``, ``pathway_connector_retries_total``).

An :class:`InputDriver` may belong to a synchronization group (``io/_synchronization.py``):
an event whose sync column runs more than the group's ``max_difference`` ahead of the
slowest member waits in its backlog, in order, until the group admits it. The readers
over databases, message buses and object stores are in ``engine/storage.py``, and the
Debezium parser in ``engine/formats.py``. A :class:`FileWriter` rewinds to a commit
(:meth:`FileWriter.rewind_to`) when a mesh of processes rolls back to a common commit,
so a recovered or rescaled run writes each commit once. :class:`BatchScheduleDriver`
feeds ``pw.debug``'s ``StreamGenerator``.
"""

from __future__ import annotations

import collections
import csv as _csv
import glob as _glob
import io as _io
import json as _json
import os
import queue
import random
import time as _time
import weakref as _weakref
from typing import Any, Callable, Sequence

from pathway_tpu_torch.engine import device_pipeline
from pathway_tpu_torch.engine.batch import Columns
from pathway_tpu_torch.engine.graph import InputSession
from pathway_tpu_torch.engine.value import Json, Pointer, hash_values_batch, ref_scalar
from pathway_tpu_torch.internals import metrics as _metrics

# -- parsed events ----------------------------------------------------------

INSERT = "insert"
DELETE = "delete"
UPSERT = "upsert"


class ParsedEvent:
    """One row event: ``kind`` (INSERT, DELETE or UPSERT), the values in schema order
    (None for an upsert's deletion) and an optional ``key``, a tuple of key values that
    streams carrying the row identity give explicitly."""

    __slots__ = ("kind", "values", "key")

    def __init__(self, kind: str, values: tuple | None, key: tuple | None = None) -> None:
        self.kind = kind
        self.values = values
        self.key = key


# -- parsers ----------------------------------------------------------------


class Parser:
    """payload -> list of ParsedEvent with values in schema order. ``session_type``
    "native" feeds inserts and removes; "upsert" feeds a session keyed by the event
    key, where an insert replaces the key's row."""

    session_type = "native"

    def __init__(self, column_names: Sequence[str]) -> None:
        self.column_names = list(column_names)

    def parse(self, payload: Any) -> list[ParsedEvent]:
        raise NotImplementedError


class DsvParser(Parser):
    """Delimiter-separated values with a header row."""

    def __init__(
        self,
        column_names: Sequence[str],
        converters: Sequence[Callable[[str], Any]] | None = None,
        delimiter: str = ",",
    ) -> None:
        super().__init__(column_names)
        self.delimiter = delimiter
        self.converters = list(converters) if converters else None
        self._header: list[str] | None = None

    def reset(self) -> None:
        self._header = None

    def parse(self, payload: str) -> list[ParsedEvent]:
        rows = list(_csv.reader(_io.StringIO(payload), delimiter=self.delimiter))
        if not rows:
            return []
        events = []
        start = 0
        if self._header is None:
            self._header = [h.strip() for h in rows[0]]
            start = 1
        positions = [self._header.index(c) for c in self.column_names]
        for row in rows[start:]:
            if not row:
                continue
            raw = tuple(row[p] if p < len(row) else "" for p in positions)
            if self.converters:
                values = tuple(conv(v) for conv, v in zip(self.converters, raw))
            else:
                values = raw
            events.append(ParsedEvent(INSERT, values))
        return events


class JsonLinesParser(Parser):
    """One JSON object a line; objects and arrays become ``Json`` values."""

    def __init__(self, column_names: Sequence[str], defaults: dict[str, Any] | None = None) -> None:
        super().__init__(column_names)
        self.defaults = defaults or {}

    def parse(self, payload: str) -> list[ParsedEvent]:
        events = []
        for line in payload.splitlines():
            line = line.strip()
            if not line:
                continue
            obj = _json.loads(line)
            values = []
            for name in self.column_names:
                if name in obj:
                    v = obj[name]
                    values.append(Json(v) if isinstance(v, (dict, list)) else v)
                elif name in self.defaults:
                    values.append(self.defaults[name])
                else:
                    values.append(None)
            events.append(ParsedEvent(INSERT, tuple(values)))
        return events


class IdentityParser(Parser):
    """The whole payload, or each non-blank line of it, as one ``data`` column
    (plaintext, plaintext by file, binary)."""

    def __init__(self, binary: bool = False, split_lines: bool = False) -> None:
        super().__init__(["data"])
        self.binary = binary
        self.split_lines = split_lines

    def parse(self, payload: Any) -> list[ParsedEvent]:
        if self.split_lines:
            return [ParsedEvent(INSERT, (line,)) for line in payload.splitlines() if line.strip()]
        return [ParsedEvent(INSERT, (payload,))]


# -- readers ----------------------------------------------------------------


class Reader:
    """Produces ``(payload, source_id, metadata)`` triples per poll."""

    #: True when a later payload with the same source_id REPLACES the earlier one (a
    #: file read again): the driver then retracts the old rows first
    replaces_sources = False

    def poll(self) -> tuple[list[tuple[Any, str, dict]], bool]:
        """Returns (entries, done)."""
        raise NotImplementedError


class FsReader(Reader):
    """File, directory or glob scanner. Static mode reads every file once; streaming
    mode diffs the listing on each poll: a new file inserts, a changed one (mtime or
    size) replaces its rows, a deleted one retracts them."""

    replaces_sources = True

    def __init__(self, path: str | os.PathLike, mode: str = "static", binary: bool = False) -> None:
        self.path = os.fspath(path)
        self.mode = mode
        self.binary = binary
        self._seen: dict[str, tuple[float, int]] = {}  # path -> (mtime, size)
        self._done_static = False

    def _list_files(self) -> list[str]:
        if os.path.isdir(self.path):
            out = []
            for root, _dirs, files in os.walk(self.path):
                out.extend(os.path.join(root, f) for f in sorted(files))
            return sorted(out)
        return sorted(_glob.glob(self.path))

    def _read_file(self, path: str) -> Any:
        if self.binary:
            with open(path, "rb") as f:
                return f.read()
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            return f.read()

    def poll(self) -> tuple[list[tuple[Any, str, dict]], bool]:
        if self.mode == "static":
            if self._done_static:
                return [], True
            self._done_static = True
            entries = []
            for path in self._list_files():
                try:
                    stat = os.stat(path)
                except FileNotFoundError:
                    continue
                sig = (stat.st_mtime, stat.st_size)
                if self._seen.get(path) == sig:
                    continue  # consumed before a resume: the journal or snapshot has it
                self._seen[path] = sig
                entries.append((self._read_file(path), path, {"path": path, "deleted": False}))
            return entries, True
        entries = []
        current: dict[str, tuple[float, int]] = {}
        for path in self._list_files():
            try:
                stat = os.stat(path)
            except FileNotFoundError:
                continue
            current[path] = (stat.st_mtime, stat.st_size)
        for path, sig in current.items():
            if self._seen.get(path) != sig:
                entries.append((self._read_file(path), path, {"path": path, "deleted": False}))
        for path in set(self._seen) - set(current):
            entries.append((None, path, {"path": path, "deleted": True}))
        self._seen = current
        return entries, False

    # -- persistence (engine/persistence.py) ----------------------------------

    def state(self) -> dict:
        return {"seen": dict(self._seen), "done_static": self._done_static}

    def restore_state(self, state: dict) -> None:
        self._seen = dict(state.get("seen", {}))
        # a resumed static read scans once more: consumed files are skipped through
        # _seen, files that appeared or changed while the process was down are read
        self._done_static = False


class QueueReader(Reader):
    """Thread-fed queue (the python ConnectorSubject)."""

    def __init__(self) -> None:
        self.queue: "queue.Queue[Any]" = queue.Queue()
        self.closed = False

    def push(self, payload: Any, source_id: str = "q") -> None:
        self.queue.put((payload, source_id, {}))

    def close(self) -> None:
        self.closed = True

    def poll(self) -> tuple[list[tuple[Any, str, dict]], bool]:
        entries = []
        while True:
            try:
                entries.append(self.queue.get_nowait())
            except queue.Empty:
                break
        return entries, self.closed and self.queue.empty()


# -- input driver -----------------------------------------------------------


class InputDriver:
    """Pumps one Reader and Parser into an InputSession; polled between commits. For a
    reader whose sources are replaced (files), the rows each source emitted are kept in
    ``_per_source_rows`` so that a changed source retracts them before its new rows and
    a deleted one retracts them all. ``append_metadata`` adds the entry's metadata as a
    trailing ``Json`` column."""

    def __init__(
        self,
        session: InputSession,
        reader: Reader,
        parser: Parser,
        *,
        primary_key_indices: Sequence[int] | None = None,
        source_name: str = "input",
        append_metadata: bool = False,
        autocommit_duration_ms: int | None = None,
    ) -> None:
        self.session = session
        self.reader = reader
        self.parser = parser
        self.pk = list(primary_key_indices) if primary_key_indices else None
        self.source_name = source_name
        #: max seconds this connector's rows may wait before a commit (the pump loop
        #: batches accordingly); 0 commits on every poll
        self.autocommit_s = (autocommit_duration_ms or 0) / 1000.0
        self.append_metadata = append_metadata
        self._per_source_rows: dict[str, list[tuple[Pointer, tuple]]] = {}
        self._seq = 0
        self.done = False
        self.entries_total = 0
        self.batches_total = 0
        self.last_entry_wall: float | None = None
        #: monotonic stamp of the oldest row fed to the session and not yet committed;
        #: the runner pops it per commit for the ingest-to-sink latency
        self.first_pending_wall: float | None = None
        self._m_entries = _metrics.REGISTRY.counter(
            "pathway_connector_entries_total",
            "entries ingested per connector",
            connector=self.source_name,
        )
        self._m_batches = _metrics.REGISTRY.counter(
            "pathway_connector_batches_total",
            "reader poll batches per connector",
            connector=self.source_name,
        )
        # synchronization-group pacing (io/_synchronization.py): events whose sync
        # column runs ahead of the group wait in ``_sync_backlog``, in order, as
        # (kind, key, values, track, source_id)
        self.sync_group: Any = None
        self.sync_col: int | None = None
        self._sync_backlog: collections.deque = collections.deque()
        #: the reader finished while the group still held events back
        self._done_pending = False

    def effective_autocommit_s(self) -> float:
        """The autocommit window scaled by the device pipeline's pressure: a congested
        device stage wants fewer, fatter commits, so the adaptive controller widens the
        window (up to 4x) while commits are in flight. Host-only programs and the
        synchronous boundary (``PATHWAY_TPU_ASYNC_DEVICE=0``) see the configured
        window; a 0-window connector (queries) stays immediate."""
        if self.autocommit_s <= 0.0:
            return self.autocommit_s
        return self.autocommit_s * device_pipeline.ingest_window_scale()

    def _keys_for(self, events: list, rows: list, source_id: str) -> list[Pointer]:
        """The row keys of one payload's events: an event's explicit key, else the
        primary key's ``ref_scalar``, else ``hash_values((source_name, source_id,
        index, seq), salt=b"connector")`` with ``seq`` counting the rows keyed so,
        hashed for the whole payload in one host-kernel call."""
        keys: list = [None] * len(events)
        hashed: list[int] = []
        salted: list[tuple] = []
        for i, (event, values) in enumerate(zip(events, rows)):
            if event.key is not None:
                if len(event.key) == 1 and isinstance(event.key[0], Pointer):
                    keys[i] = event.key[0]  # loopback streams keep their row ids
                else:
                    keys[i] = ref_scalar(*event.key)
            elif values is None:
                raise ValueError("connector event without values needs an explicit key")
            elif self.pk is not None:
                keys[i] = ref_scalar(*[values[j] for j in self.pk])
            else:
                self._seq += 1
                hashed.append(i)
                salted.append((self.source_name, source_id, i, self._seq))
        if salted:
            digests = hash_values_batch(salted, salt=b"connector")
            for i, key in zip(hashed, Columns(len(salted), [], kbytes=digests).kobjs()):
                keys[i] = key
        return keys

    def _feed(self, kind: str, key: Pointer, values: tuple | None, track: list | None) -> None:
        if kind == UPSERT:
            # the upsert session: an insert replaces the key's row, None deletes it
            if values is None:
                self.session.remove(key)
            else:
                self.session.insert(key, values)
        elif kind == INSERT:
            self.session.insert(key, values)
            if track is not None:
                track.append((key, values))
        else:
            self.session.remove(key, values)

    def _sync_admit(self, values: tuple | None) -> bool:
        """The synchronization group's gate: once anything is held back, later events
        queue behind it to keep their order; an event with no sync time (None) is not
        paced."""
        if self.sync_group is None:
            return True
        if self._sync_backlog:
            return False
        if values is None or values[self.sync_col] is None:
            return True
        return self.sync_group.admit(self, values[self.sync_col])

    def _drain_backlog(self) -> bool:
        """Release the held events the group now admits, in order."""
        produced = False
        while self._sync_backlog:
            kind, key, values, track, _src = self._sync_backlog[0]
            t = values[self.sync_col] if values is not None else None
            if t is not None and not self.sync_group.admit(self, t):
                break
            self._sync_backlog.popleft()
            self._feed(kind, key, values, track)
            produced = True
        self._note_pending()
        return produced

    def _note_pending(self) -> None:
        """Tell the group the time of this source's next held event (None: none)."""
        if self.sync_group is None:
            return
        head_t = None
        if self._sync_backlog:
            head_values = self._sync_backlog[0][2]
            if head_values is not None:
                head_t = head_values[self.sync_col]
        self.sync_group.note_pending(self, head_t)

    def _poll_reader(self) -> tuple[list, bool]:
        """``reader.poll()``, with ``PATHWAY_TPU_CONNECTOR_RETRIES`` (default 3, 0
        disables) retries of a poll that raises ``OSError`` (a network filesystem
        hiccup, a refused socket), backing off exponentially with jitter and counted in
        ``pathway_connector_retries_total``. When the retries are spent the error
        raises; any other error is never retried."""
        try:
            return self.reader.poll()
        except OSError:
            retries = int(os.environ.get("PATHWAY_TPU_CONNECTOR_RETRIES", "3"))
            if retries <= 0:
                raise
            counter = _metrics.REGISTRY.counter(
                "pathway_connector_retries_total",
                "connector reader polls retried after transient I/O errors",
            )
            delay = 0.05
            for attempt in range(retries):
                counter.inc(1)
                _time.sleep(delay * (0.5 + random.random()))
                delay = min(delay * 2, 2.0)
                try:
                    return self.reader.poll()
                except OSError:
                    if attempt == retries - 1:
                        raise
            raise  # unreachable: the last attempt returns or raises

    def poll(self) -> str:
        if self.done:
            return "done"
        produced = False
        if self._sync_backlog:
            produced = self._drain_backlog()
        if self._done_pending:
            entries, done = [], True
        else:
            entries, done = self._poll_reader()
        if entries:
            self.entries_total += len(entries)
            self.batches_total += 1
            self.last_entry_wall = _time.monotonic()
            self._m_entries.inc(len(entries))
            self._m_batches.inc(1)
        replaces = self.reader.replaces_sources
        notify_source = getattr(self.session, "on_source", None)
        for payload, source_id, metadata in entries:
            if notify_source is not None:
                notify_source(source_id)
            # retract the rows a replaced or deleted source emitted before
            old_rows = self._per_source_rows.pop(source_id, None) if replaces else None
            if old_rows:
                for key, row in old_rows:
                    self.session.remove(key, row)
                produced = True
            if replaces and self._sync_backlog:
                # the held events of a replaced source version never surface: they
                # were superseded before they were emitted
                self._sync_backlog = collections.deque(
                    e for e in self._sync_backlog if e[4] != source_id
                )
            if metadata.get("deleted"):
                continue
            reset = getattr(self.parser, "reset", None)
            if reset is not None:
                reset()
            events = self.parser.parse(payload)
            rows = [e.values for e in events]
            if self.append_metadata:
                meta = Json(dict(metadata))
                rows = [v if v is None else v + (meta,) for v in rows]
            new_rows: list[tuple[Pointer, tuple]] = []
            for event, values, key in zip(events, rows, self._keys_for(events, rows, source_id)):
                track = new_rows if (event.kind == INSERT and replaces) else None
                if self._sync_admit(values):
                    self._feed(event.kind, key, values, track)
                    produced = True
                else:
                    self._sync_backlog.append((event.kind, key, values, track, source_id))
            if replaces and events:
                # held inserts append to this same list when they are released
                self._per_source_rows[source_id] = new_rows
        self._note_pending()
        if produced and self.first_pending_wall is None:
            self.first_pending_wall = _time.monotonic()
        if done:
            if self._sync_backlog:
                # the group still holds events back: idle until the other sources
                # release them
                self._done_pending = True
                return "data" if produced else "idle"
            self.done = True
            if self.sync_group is not None:
                self.sync_group.mark_done(self)
            return "done"
        return "data" if produced else "idle"


class BatchScheduleDriver:
    """Feeds predefined batches of ``(kind, key, values)`` events, one batch a commit
    (``pw.debug.StreamGenerator``)."""

    def __init__(self, session: InputSession, batches: list[list[tuple[str, Pointer, tuple]]]):
        self.session = session
        self.batches = list(batches)

    def effective_autocommit_s(self) -> float:
        return 0.0  # every batch is its own commit

    def poll(self) -> str:
        if not self.batches:
            return "done"
        batch = self.batches.pop(0)
        for kind, key, values in batch:
            if kind == INSERT:
                self.session.insert(key, values)
            else:
                self.session.remove(key, values)
        return "data" if batch or self.batches else "done"


# -- formatters and writers --------------------------------------------------


class Formatter:
    def header(self, column_names: Sequence[str]) -> str | None:
        return None

    def format(
        self, key: Pointer, values: tuple, column_names: Sequence[str], time: int, diff: int
    ) -> str:
        raise NotImplementedError


def _plain(value: Any) -> Any:
    if isinstance(value, Json):
        return value.value
    if isinstance(value, Pointer):
        return repr(value)
    if isinstance(value, tuple):
        return [_plain(v) for v in value]
    return value


class JsonLinesFormatter(Formatter):
    """The row's columns, then ``diff`` and ``time``, as one JSON object."""

    def format(self, key, values, column_names, time, diff):
        obj = {name: _plain(v) for name, v in zip(column_names, values)}
        obj["diff"] = diff
        obj["time"] = time
        return _json.dumps(obj, default=str)


class DsvFormatter(Formatter):
    """The row's columns, then ``time`` and ``diff`` columns, under a header."""

    def __init__(self, delimiter: str = ",") -> None:
        self.delimiter = delimiter

    @staticmethod
    def _row(out: _io.StringIO) -> str:
        # the csv module quotes only fields holding the delimiter, the quote or the
        # line terminator, so the default \r\n terminator stays while writing (an
        # embedded newline is quoted) and is stripped after: FileWriter adds "\n"
        return out.getvalue().rstrip("\r\n")

    def header(self, column_names: Sequence[str]) -> str:
        out = _io.StringIO()
        _csv.writer(out, delimiter=self.delimiter).writerow(list(column_names) + ["time", "diff"])
        return self._row(out)

    def format(self, key, values, column_names, time, diff):
        out = _io.StringIO()
        _csv.writer(out, delimiter=self.delimiter).writerow(
            [_plain(v) for v in values] + [time, diff]
        )
        return self._row(out)


#: every live FileWriter of this process: the multi-process runner rewinds them all
#: when the mesh rolls back
FILE_WRITERS: "_weakref.WeakSet[FileWriter]" = _weakref.WeakSet()


class FileWriter:
    """Line-oriented file sink.

    Keeps the byte offset of each commit boundary (a trail of the last
    ``_OFFSET_TRAIL`` commits) and, under a ``PATHWAY_RUN_ID``, rewrites a
    ``<path>.pw-offsets`` sidecar (run id, header end, trail) atomically at every
    commit. A process relaunched under the same run id resumes the existing file: the
    tail past the newest recorded boundary, written by a commit that never became
    durable, is dropped. A fresh run id never resumes a stale file."""

    _OFFSET_TRAIL = 8

    def __init__(self, path: str | os.PathLike, formatter: Formatter, column_names: Sequence[str]):
        self.path = os.fspath(path)
        self.formatter = formatter
        self.column_names = list(column_names)
        self._offsets_path = self.path + ".pw-offsets"
        self._run_id = os.environ.get("PATHWAY_RUN_ID", "")
        if not self._try_resume():
            self._file = open(self.path, "w", encoding="utf-8")
            header = formatter.header(self.column_names)
            if header:
                self._file.write(header + "\n")
            self._header_end = self._file.tell()
            self._commit_offsets: dict[int, int] = {}
        FILE_WRITERS.add(self)

    def _try_resume(self) -> bool:
        """Reopen an existing sink file when the sidecar shows it belongs to this run
        (the same ``PATHWAY_RUN_ID``)."""
        if not self._run_id or not os.path.exists(self.path):
            return False
        try:
            with open(self._offsets_path, "r", encoding="utf-8") as fh:
                meta = _json.load(fh)
        except (OSError, ValueError):
            return False
        if meta.get("run_id") != self._run_id:
            return False
        try:
            offsets = {int(t): int(o) for t, o in meta["offsets"].items()}
            header_end = int(meta["header_end"])
        except (KeyError, TypeError, ValueError):
            return False
        self._file = open(self.path, "r+", encoding="utf-8")
        self._header_end = header_end
        self._commit_offsets = offsets
        durable_end = max(offsets.values()) if offsets else header_end
        self._file.truncate(durable_end)
        self._file.seek(durable_end)
        return True

    def _persist_offsets(self) -> None:
        """Rewrite the sidecar through a temporary file and a rename, so a crash
        leaves the old trail or the new one, never a torn one."""
        if not self._run_id:
            return
        tmp = self._offsets_path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                _json.dump(
                    {
                        "run_id": self._run_id,
                        "header_end": self._header_end,
                        "offsets": {str(t): o for t, o in self._commit_offsets.items()},
                    },
                    fh,
                )
            os.replace(tmp, self._offsets_path)
        except OSError:
            pass

    def on_change(self, key: Pointer, values: tuple, time: int, diff: int) -> None:
        self._file.write(self.formatter.format(key, values, self.column_names, time, diff) + "\n")

    def on_time_end(self, time: int) -> None:
        if not self._file.closed:
            self._file.flush()
            self._commit_offsets[time] = self._file.tell()
            while len(self._commit_offsets) > self._OFFSET_TRAIL:
                del self._commit_offsets[min(self._commit_offsets)]
            self._persist_offsets()

    def rewind_to(self, time: int) -> None:
        """Truncate everything written after commit ``time`` (``-1``: back to the
        header), so the commits a mesh rolled back land once when they are driven
        again. Nothing happens when no later commit reached this sink; a boundary that
        fell off the trail raises ``ValueError``."""
        if self._file.closed:
            return
        if time < 0:
            offset = self._header_end
        elif time in self._commit_offsets:
            offset = self._commit_offsets[time]
        else:
            if not any(t > time for t in self._commit_offsets):
                return
            raise ValueError(
                f"sink {self.path}: cannot rewind to commit {time} — its boundary "
                f"offset is no longer tracked (trail keeps {self._OFFSET_TRAIL} commits)"
            )
        self._file.flush()
        self._file.truncate(offset)
        self._file.seek(offset)
        self._commit_offsets = {t: o for t, o in self._commit_offsets.items() if t <= time}
        self._persist_offsets()

    def on_end(self) -> None:
        if not self._file.closed:
            self._file.flush()
            self._file.close()
