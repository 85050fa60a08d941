"""``pw.io.bigquery``: a table's update log streamed into BigQuery.

Counterpart of ``pathway_tpu/io/bigquery.py``. :class:`RestBigQueryClient` speaks the
``tabledata.insertAll`` REST endpoint (each row with an ``insertId`` unique to the run,
BigQuery's deduplication handle) over ``io/_utils.py::post_json`` or an ``http_fn``; a
commit's rows go in one request. An injected ``client`` with ``insert_rows_json(table_id,
rows)`` takes its place; without either, google-cloud-bigquery is required."""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine.formats import DocumentFormatter
from pathway_tpu_torch.engine.value import Pointer
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._utils import attach_writer, require

BIGQUERY_API = "https://bigquery.googleapis.com/bigquery/v2"


class RestBigQueryClient:
    """Speaks the BigQuery ``tabledata.insertAll`` REST endpoint:
    ``POST {base}/projects/{p}/datasets/{d}/tables/{t}/insertAll`` with
    per-row ``insertId`` deduplication ids."""

    def __init__(
        self,
        project_id: str,
        api_base: str = BIGQUERY_API,
        access_token: str | None = None,
        http_fn: Callable[[str, dict], dict] | None = None,
    ) -> None:
        self.project_id = project_id
        self.api_base = api_base.rstrip("/")
        if http_fn is None:
            from pathway_tpu_torch.io._utils import post_json

            def http_fn(url: str, payload: dict) -> dict:
                return post_json(url, payload, token=access_token)

        self.http_fn = http_fn
        # insertIds are BigQuery's best-effort dedup handle and must be
        # globally unique: a restarted process reusing a counter would
        # have its first rows silently swallowed as "duplicates"
        import uuid

        self._run_id = uuid.uuid4().hex
        self._seq = 0

    def insert_rows_json(self, table_id: str, rows: list[dict]) -> None:
        dataset, _, table = table_id.partition(".")
        url = (
            f"{self.api_base}/projects/{self.project_id}/datasets/"
            f"{dataset}/tables/{table}/insertAll"
        )
        payload_rows = []
        for row in rows:
            self._seq += 1
            payload_rows.append(
                {"insertId": f"pw-{self._run_id}-{self._seq}", "json": row}
            )
        body = self.http_fn(
            url,
            {
                "kind": "bigquery#tableDataInsertAllRequest",
                "rows": payload_rows,
            },
        )
        errors = body.get("insertErrors")
        if errors:
            raise RuntimeError(f"bigquery insert errors: {errors}")


class _BigQueryWriter:
    def __init__(self, client: Any, table_id: str, formatter: DocumentFormatter):
        self.client = client
        self.table_id = table_id
        self.formatter = formatter
        self._batch: list[dict] = []

    def on_change(self, key: Pointer, values: tuple, time: int, diff: int) -> None:
        self._batch.append(self.formatter.format(key, values, time, diff))

    def on_time_end(self, time: int) -> None:
        if self._batch:
            self.client.insert_rows_json(self.table_id, self._batch)
            self._batch = []

    def on_end(self) -> None:
        self.on_time_end(-1)


def write(
    table: Table,
    dataset_name: str | None = None,
    table_name: str | None = None,
    service_user_credentials_file: str | None = None,
    *,
    client: Any = None,
    project_id: str | None = None,
    access_token: str | None = None,
    api_base: str = BIGQUERY_API,
    **kwargs: Any,
) -> None:
    """Stream the table's update log into BigQuery. Client resolution:
    explicit ``client=`` seam; else the built-in REST client when
    ``project_id=`` is given (with ``access_token=``/``api_base=``);
    else google-cloud-bigquery from the credentials file."""
    if client is None and project_id is not None:
        client = RestBigQueryClient(
            project_id, api_base=api_base, access_token=access_token
        )
    if client is None:
        bq = require("google.cloud.bigquery", "pw.io.bigquery")
        creds_client = bq.Client.from_service_account_json(
            service_user_credentials_file
        )

        class _Adapter:
            def insert_rows_json(self, table_id: str, rows: list) -> None:
                errors = creds_client.insert_rows_json(table_id, rows)
                if errors:
                    raise RuntimeError(f"bigquery insert errors: {errors}")

        client = _Adapter()
    table_id = f"{dataset_name}.{table_name}"

    def make_writer(column_names):
        return _BigQueryWriter(client, table_id, DocumentFormatter(column_names))

    attach_writer(table, make_writer)
