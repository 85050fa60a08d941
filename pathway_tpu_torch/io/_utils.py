"""Shared io plumbing: connector-backed input tables, the text converters of the
typed readers, and the writers' sinks.

Counterpart of ``pathway_tpu/io/_utils.py``: ``converter_for``, ``input_table`` and
``attach_writer``; ``post_json``, the JSON POST behind the REST writers; ``require``,
which gates a connector on its client library unless a client is injected; and
``lake_parquet_events``, the data lakes' parquet read leg (pyarrow), whose rows with
``diff = -1`` become retractions keyed by the schema's primary key.
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

    def attach(scope: Scope, make_driver: bool = True):
        parser = make_parser(column_names)
        session = scope.input_session(
            len(all_names), upsert=getattr(parser, "session_type", "native") == "upsert"
        )
        if not make_driver:
            # a sharded replica (worker > 0) needs the session for the graph's shape
            # but builds no reader: a reader may start threads or consume from a
            # service, and only worker 0 reads
            return session, None
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


def post_json(
    url: str,
    payload: dict,
    token: str | None = None,
    timeout: float = 60.0,
    content_type: str = "application/json",
) -> dict:
    """POST a JSON body and parse the JSON response: the shared transport of the REST
    write connectors."""
    import urllib.request

    headers = {"Content-Type": content_type}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers=headers, method="POST"
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def require(module_names: str, feature: str, injected: Any = None) -> Any:
    """The client library ``module_names`` of ``feature``, or ``injected`` when a client
    is given; a missing library raises ``ImportError`` saying how to run without it."""
    if injected is not None:
        return injected
    import importlib

    try:
        return importlib.import_module(module_names)
    except ImportError as e:
        raise ImportError(
            f"{feature} needs the {module_names!r} client library, which is "
            f"not installed; pass an explicit client/transport object to run "
            f"without it"
        ) from e


def lake_parquet_events(
    path: str,
    column_names: Sequence[str],
    key_indices: Sequence[int] | None,
    lake_kind: str,
) -> list:
    """One parquet data file of a data lake (Delta, Iceberg) -> ParsedEvents. Files a
    Pathway writer wrote carry ``time`` and ``diff`` columns; a row with ``diff < 0``
    becomes a retraction, which needs the primary-key columns to find the row it
    cancels (a ``ValueError`` without them)."""
    import pyarrow.parquet as pq

    from pathway_tpu_torch.engine.connectors import DELETE, INSERT, ParsedEvent

    table = pq.read_table(path)
    data = {c: table.column(c).to_pylist() for c in table.column_names}
    absent = [None] * table.num_rows
    events = []
    for i in range(table.num_rows):
        values = tuple(data.get(name, absent)[i] for name in column_names)
        diff = data["diff"][i] if "diff" in data else 1
        key = tuple(values[j] for j in key_indices) if key_indices else None
        if diff < 0 and key is None:
            raise ValueError(
                f"{lake_kind} table contains retractions (diff=-1); declare "
                "primary_key columns in the read schema so they key the "
                "update stream"
            )
        events.append(ParsedEvent(INSERT if diff >= 0 else DELETE, values, key=key))
    return events
