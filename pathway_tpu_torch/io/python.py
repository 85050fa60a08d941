"""``pw.io.python``: user-defined push sources.

Counterpart of ``pathway_tpu/io/python.py``: a ``ConnectorSubject`` runs ``run()`` on
its own thread, and each ``next(**fields)`` puts one row on a queue that the streaming
run loop drains between commits. Only the subject's thread feeds the queue; every
engine operator, the UDFs and all device work run on the thread that called
``pw.run``.
"""

from __future__ import annotations

import json as _json
import threading
from typing import Any, Sequence

from pathway_tpu_torch.engine.connectors import DELETE, INSERT, ParsedEvent, Parser, QueueReader
from pathway_tpu_torch.engine.value import Json
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._utils import input_table


class ConnectorSubject:
    """Subclass and implement ``run()``, calling ``self.next(**fields)``."""

    def __init__(self) -> None:
        self._reader = QueueReader()
        self._thread: threading.Thread | None = None

    # -- user API -----------------------------------------------------------

    def next(self, **kwargs: Any) -> None:
        self._reader.push(("insert", kwargs))

    def next_json(self, message: dict | str) -> None:
        if isinstance(message, str):
            message = _json.loads(message)
        self.next(**message)

    def next_str(self, message: str) -> None:
        self.next(data=message)

    def next_bytes(self, message: bytes) -> None:
        self.next(data=message)

    def _remove(self, **kwargs: Any) -> None:
        self._reader.push(("delete", kwargs))

    def commit(self) -> None:
        self._reader.push(("commit", None))

    def close(self) -> None:
        self._reader.close()

    def run(self) -> None:
        raise NotImplementedError

    # -- engine integration --------------------------------------------------

    def _start(self) -> None:
        def runner() -> None:
            try:
                self.run()
            finally:
                self.close()

        self._thread = threading.Thread(target=runner, daemon=True)
        self._thread.start()


class _SubjectParser(Parser):
    def parse(self, payload: Any) -> list[ParsedEvent]:
        kind, fields = payload
        if kind == "commit" or fields is None:
            return []
        values = []
        for name in self.column_names:
            v = fields.get(name)
            if isinstance(v, (dict, list)):
                v = Json(v)
            values.append(v)
        return [ParsedEvent(INSERT if kind == "insert" else DELETE, tuple(values))]


def read(
    subject: ConnectorSubject,
    *,
    schema: schema_mod.SchemaMetaclass,
    autocommit_duration_ms: int | None = 1500,
) -> Table:
    """A table fed by ``subject``; its thread starts when the table is built."""
    started = False

    def make_reader() -> QueueReader:
        nonlocal started
        if not started:
            subject._start()
            started = True
        return subject._reader

    def make_parser(names: Sequence[str]) -> Parser:
        return _SubjectParser(names)

    return input_table(
        schema,
        make_reader,
        make_parser,
        source_name="python-connector",
        autocommit_duration_ms=autocommit_duration_ms,
    )
