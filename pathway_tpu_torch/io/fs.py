"""``pw.io.fs``: read files, a directory or a glob, and write an update log.

Counterpart of ``pathway_tpu/io/fs.py``. Formats: ``csv`` (a header row; cells
converted to the schema's types), ``json`` (one object a line), ``plaintext`` (a row a
non-blank line), ``plaintext_by_file`` and ``binary`` (a row a file). ``mode="static"``
reads once; ``"streaming"`` polls the path until the run ends, and a changed or deleted
file retracts the rows it gave. ``persistent_id`` journals or snapshots the source
under ``pw.run(persistence_config=...)``. ``write`` appends every change as a line (its
columns, ``time`` and ``diff``) in csv or JSON lines.
"""

from __future__ import annotations

import os
from typing import Any

from pathway_tpu_torch.engine.connectors import (
    DsvFormatter,
    DsvParser,
    FileWriter,
    FsReader,
    IdentityParser,
    JsonLinesFormatter,
    JsonLinesParser,
)
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._utils import attach_writer, converter_for, input_table


def read(
    path: str | os.PathLike,
    *,
    format: str = "csv",  # noqa: A002
    schema: schema_mod.SchemaMetaclass | None = None,
    mode: str = "streaming",
    with_metadata: bool = False,
    csv_settings: Any = None,
    autocommit_duration_ms: int | None = 1500,
    persistent_id: str | None = None,
    **kwargs: Any,
) -> Table:
    if format in ("plaintext", "plaintext_by_file", "binary"):
        schema = schema_mod.schema_from_types(data=bytes if format == "binary" else str)
    if schema is None:
        raise ValueError("schema= is required for csv/json formats")
    dtypes = schema.dtypes()
    binary = format == "binary"

    def make_reader() -> FsReader:
        return FsReader(path, mode=mode, binary=binary)

    def make_parser(names):
        if format == "csv":
            delimiter = getattr(csv_settings, "delimiter", ",") if csv_settings is not None else ","
            return DsvParser(
                names, converters=[converter_for(dtypes[n]) for n in names], delimiter=delimiter
            )
        if format == "json":
            return JsonLinesParser(names)
        if format == "plaintext":
            return IdentityParser(split_lines=True)
        if format in ("plaintext_by_file", "binary"):
            return IdentityParser(binary=binary, split_lines=False)
        raise ValueError(f"unknown format {format!r}")

    return input_table(
        schema,
        make_reader,
        make_parser,
        source_name=f"fs:{path}",
        with_metadata=with_metadata,
        persistent_id=persistent_id,
        autocommit_duration_ms=autocommit_duration_ms,
    )


def write(table: Table, filename: str | os.PathLike, *, format: str = "json", **kwargs: Any) -> None:  # noqa: A002
    formatter = DsvFormatter if format == "csv" else JsonLinesFormatter
    attach_writer(table, lambda names: FileWriter(filename, formatter(), names))
