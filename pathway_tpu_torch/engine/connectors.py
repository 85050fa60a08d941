"""Connector framework: a Reader's payloads, parsed into events, fed into an
InputSession.

Counterpart of the part of ``pathway_tpu/engine/connectors.py`` that Python push
sources use: each source is an :class:`InputDriver` polled by the streaming run loop
between commits; a :class:`QueueReader` takes the payloads that a source's own thread
pushes. Rows without a primary key get the reference's key,
``hash_values((source_name, source_id, index, seq), salt=b"connector")``, so the same
feed gives the same keys in both packages. The file, CSV, JSON-lines and message-bus
connectors (with their replaced sources, explicit event keys, upsert parsers and
metadata columns), the synchronization groups and the writers are not ported yet
(ROADMAP queue 1 item 15). :class:`BatchScheduleDriver` feeds ``pw.debug``'s
``StreamGenerator``.
"""

from __future__ import annotations

import queue
from typing import Any, Sequence

from pathway_tpu_torch.engine import device_pipeline
from pathway_tpu_torch.engine.graph import InputSession
from pathway_tpu_torch.engine.value import Pointer, hash_values, ref_scalar

INSERT = "insert"
DELETE = "delete"


class ParsedEvent:
    """One row event: ``kind`` (INSERT or DELETE) and the values in schema order."""

    __slots__ = ("kind", "values")

    def __init__(self, kind: str, values: tuple) -> None:
        self.kind = kind
        self.values = values


class Parser:
    """payload -> list of ParsedEvent with values in schema order."""

    def __init__(self, column_names: Sequence[str]) -> None:
        self.column_names = list(column_names)

    def parse(self, payload: Any) -> list[ParsedEvent]:
        raise NotImplementedError


class Reader:
    """Produces (payload, source_id) pairs per poll."""

    def poll(self) -> tuple[list[tuple[Any, str]], bool]:
        """Returns (entries, done)."""
        raise NotImplementedError


class QueueReader(Reader):
    """Thread-fed queue (the python ConnectorSubject)."""

    def __init__(self) -> None:
        self.queue: "queue.Queue[Any]" = queue.Queue()
        self.closed = False

    def push(self, payload: Any, source_id: str = "q") -> None:
        self.queue.put((payload, source_id))

    def close(self) -> None:
        self.closed = True

    def poll(self) -> tuple[list[tuple[Any, str]], bool]:
        entries = []
        while True:
            try:
                entries.append(self.queue.get_nowait())
            except queue.Empty:
                break
        return entries, self.closed and self.queue.empty()


class InputDriver:
    """Pumps one Reader and Parser into an InputSession; polled between commits."""

    def __init__(
        self,
        session: InputSession,
        reader: Reader,
        parser: Parser,
        *,
        primary_key_indices: Sequence[int] | None = None,
        source_name: str = "input",
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
        self._seq = 0
        self.done = False

    def effective_autocommit_s(self) -> float:
        """The autocommit window scaled by the device pipeline's pressure: a congested
        device stage wants fewer, fatter commits, so the adaptive controller widens the
        window (up to 4x) while commits are in flight. Host-only programs and the
        synchronous boundary (``PATHWAY_TPU_ASYNC_DEVICE=0``) see the configured
        window; a 0-window connector (queries) stays immediate."""
        if self.autocommit_s <= 0.0:
            return self.autocommit_s
        return self.autocommit_s * device_pipeline.ingest_window_scale()

    def _key_for(self, values: tuple, source_id: str, index: int) -> Pointer:
        if self.pk is not None:
            return ref_scalar(*[values[i] for i in self.pk])
        self._seq += 1
        return hash_values(
            (self.source_name, source_id, index, self._seq), salt=b"connector"
        )

    def poll(self) -> str:
        if self.done:
            return "done"
        produced = False
        entries, done = self.reader.poll()
        for payload, source_id in entries:
            for i, event in enumerate(self.parser.parse(payload)):
                key = self._key_for(event.values, source_id, i)
                if event.kind == INSERT:
                    self.session.insert(key, event.values)
                else:
                    self.session.remove(key, event.values)
                produced = True
        if done:
            self.done = True
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
