"""``pw.io.elasticsearch``: a table's update log indexed into Elasticsearch.

Counterpart of ``pathway_tpu/io/elasticsearch.py``: one document a change (the row,
``time`` and ``diff``), a commit's documents in one ``_bulk`` request of the built-in
HTTP client (``io/_es_wire.py``) with Basic, Bearer or ApiKey authorization
(:class:`ElasticSearchAuth`), or an injected ``client`` with ``index(index_name,
document)``."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.formats import DocumentFormatter
from pathway_tpu_torch.engine.storage import ElasticsearchWriter
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._utils import attach_writer


class ElasticSearchAuth:
    """Auth config holder (reference ElasticSearchAuth: basic/bearer/apikey)."""

    def __init__(self, kind: str, **params: Any) -> None:
        self.kind = kind
        self.params = params

    @classmethod
    def basic(cls, username: str, password: str) -> "ElasticSearchAuth":
        return cls("basic", username=username, password=password)

    @classmethod
    def bearer(cls, token: str) -> "ElasticSearchAuth":
        return cls("bearer", token=token)

    @classmethod
    def apikey(cls, apikey_id: str, apikey: str) -> "ElasticSearchAuth":
        return cls("apikey", apikey_id=apikey_id, apikey=apikey)


def write(
    table: Table,
    host: str | None = None,
    auth: ElasticSearchAuth | None = None,
    index_name: str | None = None,
    *,
    client: Any = None,
    **kwargs: Any,
) -> None:
    """Index one document (row + time + diff) per change through the
    built-in HTTP ``_bulk`` client (``io/_es_wire.py``: NDJSON frames,
    one bulk request per commit, Basic/Bearer/ApiKey auth). An injected
    ``client`` with ``index(index_name, document)`` overrides it."""
    if client is None:
        from pathway_tpu_torch.io._es_wire import (
            EsBulkClient,
            auth_header_apikey,
            auth_header_basic,
            auth_header_bearer,
        )

        if host is None:
            raise ValueError("pw.io.elasticsearch needs host (or client=)")
        auth_header = None
        if auth is not None:
            if auth.kind == "basic":
                auth_header = auth_header_basic(
                    auth.params["username"], auth.params["password"]
                )
            elif auth.kind == "bearer":
                auth_header = auth_header_bearer(auth.params["token"])
            elif auth.kind == "apikey":
                auth_header = auth_header_apikey(
                    auth.params["apikey_id"], auth.params["apikey"]
                )
            else:
                raise ValueError(f"unknown auth kind {auth.kind!r}")
        client = EsBulkClient(host, auth_header=auth_header)

    def make_writer(column_names):
        return ElasticsearchWriter(
            client, index_name, DocumentFormatter(column_names)
        )

    attach_writer(table, make_writer)
