"""``pw.io.sqlite``: read a SQLite table as a change stream.

Counterpart of ``pathway_tpu/io/sqlite.py`` over ``engine/storage.py::SqliteReader``:
inserts, updates and deletions of the table's rows (keyed by rowid) become the engine's
diffs. A write from another connection moves ``PRAGMA data_version``; the reader then
scans the whole table again and diffs it against the last scan."""

from __future__ import annotations

import os
from typing import Any

from pathway_tpu_torch.engine.storage import SqliteReader, TransparentParser
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._utils import input_table


def read(
    path: str | os.PathLike,
    table_name: str,
    schema: schema_mod.SchemaMetaclass,
    *,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    **kwargs: Any,
) -> Table:
    """Poll ``table_name`` of the database at ``path`` (``mode="static"``: read once)."""
    column_names = schema.column_names()
    path = os.fspath(path)
    return input_table(
        schema,
        lambda: SqliteReader(path, table_name, column_names, mode=mode),
        lambda names: TransparentParser(names),
        source_name=f"sqlite:{path}:{table_name}",
        autocommit_duration_ms=autocommit_duration_ms,
    )
