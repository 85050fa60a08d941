"""Shared io plumbing: connector-backed input tables.

Counterpart of ``input_table`` in ``pathway_tpu/io/_utils.py``.
"""

from __future__ import annotations

from typing import Callable, Sequence

from pathway_tpu_torch.engine.connectors import InputDriver, Parser, Reader
from pathway_tpu_torch.engine.graph import Scope
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table, TableSpec


def input_table(
    schema: schema_mod.SchemaMetaclass,
    make_reader: Callable[[], Reader],
    make_parser: Callable[[Sequence[str]], Parser],
    *,
    source_name: str = "input",
    autocommit_duration_ms: int | None = None,
) -> Table:
    """Create a connector-backed table (spec kind "input"): at build time it makes
    an input session in the scope and the driver that feeds it."""
    column_names = schema.column_names()
    pk = schema.primary_key_columns()
    pk_indices = [column_names.index(p) for p in pk] if pk else None

    def attach(scope: Scope):
        session = scope.input_session(len(column_names))
        driver = InputDriver(
            session,
            make_reader(),
            make_parser(column_names),
            primary_key_indices=pk_indices,
            source_name=source_name,
            autocommit_duration_ms=autocommit_duration_ms,
        )
        return session, driver

    return Table(
        TableSpec("input", [], {"attach": attach}),
        column_names,
        schema.dtypes(),
        name=source_name,
    )
