"""Shared io plumbing: connector-backed input tables, the text converters of the
typed readers, and the writers' sinks.

Counterpart of ``converter_for``, ``input_table`` and ``attach_writer`` in
``pathway_tpu/io/_utils.py``.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Sequence

from pathway_tpu_torch.engine.connectors import InputDriver, Parser, Reader
from pathway_tpu_torch.engine.graph import Scope
from pathway_tpu_torch.engine.value import Json
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table, TableSpec

METADATA_COLUMN = "_metadata"


def converter_for(dtype: dt.DType) -> Callable[[str], Any]:
    """Text cell -> value of ``dtype``; an empty cell of an optional column is None."""
    base = dtype.strip_optional()
    optional = dtype.is_optional()

    def conv(text: str) -> Any:
        if text == "" and optional:
            return None
        if base == dt.INT:
            return int(text)
        if base == dt.FLOAT:
            return float(text)
        if base == dt.BOOL:
            return text.strip().lower() in ("true", "1", "yes", "on")
        if base == dt.STR:
            return text
        if base == dt.JSON:
            return Json(json.loads(text))
        return text

    return conv


def input_table(
    schema: schema_mod.SchemaMetaclass,
    make_reader: Callable[[], Reader],
    make_parser: Callable[[Sequence[str]], Parser],
    *,
    source_name: str = "input",
    with_metadata: bool = False,
    persistent_id: str | None = None,
    autocommit_duration_ms: int | None = None,
) -> Table:
    """Create a connector-backed table (spec kind "input"): at build time it makes an
    input session in the scope (an upsert session where the parser asks for one) and
    the driver that feeds it. ``with_metadata`` adds a ``_metadata`` Json column;
    ``persistent_id`` names the source's journal under persistence."""
    column_names = schema.column_names()
    dtypes = dict(schema.dtypes())
    if with_metadata:
        dtypes[METADATA_COLUMN] = dt.JSON
    all_names = list(dtypes.keys())
    pk = schema.primary_key_columns()
    pk_indices = [column_names.index(p) for p in pk] if pk else None

    def attach(scope: Scope):
        parser = make_parser(column_names)
        session = scope.input_session(
            len(all_names), upsert=getattr(parser, "session_type", "native") == "upsert"
        )
        driver = InputDriver(
            session,
            make_reader(),
            parser,
            primary_key_indices=pk_indices,
            source_name=source_name,
            append_metadata=with_metadata,
            autocommit_duration_ms=autocommit_duration_ms,
        )
        return session, driver

    return Table(
        TableSpec("input", [], {"attach": attach, "persistent_id": persistent_id}),
        all_names,
        dtypes,
        name=source_name,
    )


def attach_writer(table: Table, make_writer: Callable[[Sequence[str]], Any]) -> None:
    """Wire a writer (``on_change``, ``on_time_end``, ``on_end``) as a sink of
    ``table``."""
    from pathway_tpu_torch.internals.parse_graph import G

    column_names = table.column_names()

    def attach(scope: Scope, node: Any):
        writer = make_writer(column_names)
        scope.subscribe_table(
            node,
            on_change=writer.on_change,
            on_time_end=writer.on_time_end,
            on_end=writer.on_end,
        )
        return None

    G.add_sink(table, attach)
