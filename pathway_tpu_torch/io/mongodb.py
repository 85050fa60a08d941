"""``pw.io.mongodb``: a table's update log written into a MongoDB collection.

Counterpart of ``pathway_tpu/io/mongodb.py``: one document a change (the row, ``time``
and ``diff``), a commit's documents in one ``insert`` command, through the built-in
OP_MSG client (``io/_mongo_wire.py``) or an injected ``client`` with
``insert_many(collection, documents)``."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.formats import DocumentFormatter
from pathway_tpu_torch.engine.storage import MongoWriter
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._utils import attach_writer


def write(
    table: Table,
    connection_string: str | None = None,
    database: str | None = None,
    collection: str | None = None,
    *,
    client: Any = None,
    **kwargs: Any,
) -> None:
    """Insert one document (row + time + diff) per change through the
    built-in wire client (``io/_mongo_wire.py``: own BSON codec + OP_MSG
    insert commands, one batch per commit). An injected ``client`` with
    ``insert_many(collection, docs)`` overrides it."""
    if client is None:
        from urllib.parse import urlparse

        from pathway_tpu_torch.io._mongo_wire import MongoWireClient

        if connection_string is None or database is None:
            raise ValueError(
                "pw.io.mongodb needs connection_string and database "
                "(or client=)"
            )
        parsed = urlparse(
            connection_string
            if "://" in connection_string
            else f"mongodb://{connection_string}"
        )
        client = MongoWireClient(
            parsed.hostname or "127.0.0.1",
            parsed.port or 27017,
            database=database,
        )

    def make_writer(column_names):
        return MongoWriter(client, collection, DocumentFormatter(column_names))

    attach_writer(table, make_writer)
