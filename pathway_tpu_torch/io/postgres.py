"""``pw.io.postgres``: a table's update log or its live snapshot, written into Postgres.

Counterpart of ``pathway_tpu/io/postgres.py``. :func:`write` appends every change as a
row ``(values..., time, diff)``; :func:`write_snapshot` keeps the table as its current
snapshot (an upsert on the primary key for an insertion, a DELETE by key for a
retraction). Both run through ``engine/storage.py::PsqlWriter``, one transaction an
engine commit, over the built-in v3 client (``io/_pg_wire.py``) made from
``postgres_settings`` (``host``, ``port``, ``user``, ``password``, ``dbname``,
``connect_timeout``, ``sslmode``), or over an injected ``connection`` with
``execute(statement, params)`` and, optionally, ``commit()``. :func:`psycopg2_adapter`
wraps a psycopg2 connection: it turns the ``$N`` placeholders into named pyformat ones.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.formats import PsqlSnapshotFormatter, PsqlUpdatesFormatter
from pathway_tpu_torch.engine.storage import PsqlWriter
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._utils import attach_writer


def psycopg2_adapter(conn: Any) -> Any:
    """Wrap a psycopg2 connection into the executor contract: the Psql
    formatters emit $N placeholders (which repeat — the snapshot upsert
    reuses $1 in VALUES, SET and WHERE), translated here to psycopg2's
    NAMED pyformat so each occurrence binds the same parameter."""
    import re

    class _Adapter:
        def execute(self, statement: str, params):
            stmt = re.sub(r"\$(\d+)", r"%(p\1)s", statement)
            named = {f"p{i + 1}": v for i, v in enumerate(params)}
            with conn.cursor() as cur:
                cur.execute(stmt, named)

        def commit(self):
            conn.commit()

    return _Adapter()


def _executor(postgres_settings: dict | None, connection: Any) -> Any:
    if connection is not None:
        return connection
    from pathway_tpu_torch.io._pg_wire import PgWireConnection

    settings = dict(postgres_settings or {})
    return PgWireConnection(
        host=settings.get("host", "127.0.0.1"),
        port=int(settings.get("port", 5432)),
        user=settings.get("user", "pathway"),
        password=settings.get("password"),
        dbname=settings.get("dbname", settings.get("database", "pathway")),
        connect_timeout=float(settings.get("connect_timeout", 10.0)),
        sslmode=settings.get("sslmode", "prefer"),
    )


def write(
    table: Table,
    postgres_settings: dict | None = None,
    table_name: str | None = None,
    *,
    connection: Any = None,
    **kwargs: Any,
) -> None:
    """Append every change as a row (values..., time, diff) — the update-log
    shape (reference postgres.write)."""
    executor = _executor(postgres_settings, connection)

    def make_writer(column_names):
        return PsqlWriter(
            executor, PsqlUpdatesFormatter(table_name, column_names)
        )

    attach_writer(table, make_writer)


def write_snapshot(
    table: Table,
    postgres_settings: dict | None = None,
    table_name: str | None = None,
    primary_key: list[str] | None = None,
    *,
    connection: Any = None,
    **kwargs: Any,
) -> None:
    """Maintain ``table_name`` as the current snapshot: upsert on insert,
    DELETE on retraction (reference postgres.write_snapshot :113)."""
    if not primary_key:
        raise ValueError("write_snapshot needs primary_key=[...]")
    executor = _executor(postgres_settings, connection)

    def make_writer(column_names):
        return PsqlWriter(
            executor,
            PsqlSnapshotFormatter(table_name, primary_key, column_names),
        )

    attach_writer(table, make_writer)
