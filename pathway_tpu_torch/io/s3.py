"""``pw.io.s3``: the object-store connector.

Counterpart of ``pathway_tpu/io/s3.py``. The store is reached through a ``client`` with
``list_objects(prefix) -> [(key, etag)]`` and ``get_object(key) -> bytes`` (and
``put_object`` for writes): an injected one (``DictObjectStore`` in memory), or the
boto3 adapter that ``AwsS3Settings.create_client`` makes (boto3 must be installed;
without it the call raises ``ImportError``). ``read`` scans the objects under a key
prefix and parses each in ``csv``, ``json`` (JSON lines), ``plaintext`` (a row a line) or
``binary`` (a row an object); a rewritten object replaces its rows and a deleted one
retracts them. ``write`` puts one JSON-lines object a commit.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.connectors import (
    DsvParser,
    IdentityParser,
    JsonLinesFormatter,
    JsonLinesParser,
)
from pathway_tpu_torch.engine.storage import DictObjectStore, ObjectStoreReader, ObjectStoreWriter
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._utils import attach_writer, converter_for, input_table, require

__all__ = ["AwsS3Settings", "DictObjectStore", "read", "write"]


class AwsS3Settings:
    """A bucket and its credentials; ``create_client`` makes the boto3 adapter."""

    def __init__(
        self,
        bucket_name: str | None = None,
        access_key: str | None = None,
        secret_access_key: str | None = None,
        region: str | None = None,
        endpoint: str | None = None,
        with_path_style: bool = False,
    ) -> None:
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.region = region
        self.endpoint = endpoint
        self.with_path_style = with_path_style

    def create_client(self) -> Any:
        boto3 = require("boto3", "pw.io.s3")
        s3 = boto3.client(
            "s3",
            aws_access_key_id=self.access_key,
            aws_secret_access_key=self.secret_access_key,
            region_name=self.region,
            endpoint_url=self.endpoint,
        )
        bucket = self.bucket_name

        class _Adapter:
            def list_objects(self, prefix: str):
                out = []
                kwargs = {"Bucket": bucket, "Prefix": prefix}
                while True:  # a page holds at most 1,000 keys
                    resp = s3.list_objects_v2(**kwargs)
                    for item in resp.get("Contents", []):
                        out.append((item["Key"], item["ETag"]))
                    token = resp.get("NextContinuationToken")
                    if not token:
                        return out
                    kwargs["ContinuationToken"] = token

            def get_object(self, key: str) -> bytes:
                return s3.get_object(Bucket=bucket, Key=key)["Body"].read()

            def put_object(self, key: str, data) -> None:
                if isinstance(data, str):
                    data = data.encode("utf-8")
                s3.put_object(Bucket=bucket, Key=key, Body=data)

        return _Adapter()


def _client_of(aws_s3_settings: Any, client: Any) -> Any:
    if client is not None:
        return client
    if aws_s3_settings is None:
        raise ValueError("pass aws_s3_settings= or client=")
    return aws_s3_settings.create_client()


def read(
    path: str,
    *,
    aws_s3_settings: AwsS3Settings | None = None,
    format: str = "json",  # noqa: A002
    schema: schema_mod.SchemaMetaclass | None = None,
    mode: str = "streaming",
    client: Any = None,
    with_metadata: bool = False,
    persistent_id: str | None = None,
    **kwargs: Any,
) -> Table:
    """Scan the objects under the key prefix ``path`` and parse each in ``format``."""
    store = _client_of(aws_s3_settings, client)
    if format in ("plaintext", "binary", "plaintext_by_object"):
        schema = schema_mod.schema_from_types(data=bytes if format == "binary" else str)
    if schema is None:
        raise ValueError("schema= is required for csv/json formats")
    dtypes = schema.dtypes()
    binary = format == "binary"

    def make_parser(names):
        if format == "csv":
            return DsvParser(names, converters=[converter_for(dtypes[n]) for n in names])
        if format == "json":
            return JsonLinesParser(names)
        if format == "plaintext":
            return IdentityParser(split_lines=True)
        return IdentityParser(binary=binary, split_lines=False)

    return input_table(
        schema,
        lambda: ObjectStoreReader(store, path, mode=mode, binary=binary),
        make_parser,
        source_name=f"s3:{path}",
        with_metadata=with_metadata,
        persistent_id=persistent_id,
    )


def write(
    table: Table,
    path: str,
    *,
    aws_s3_settings: AwsS3Settings | None = None,
    format: str = "json",  # noqa: A002
    client: Any = None,
    **kwargs: Any,
) -> None:
    """Put one JSON-lines object a commit under ``path``."""
    if format != "json":
        raise ValueError(f"unsupported s3 write format {format!r}")
    store = _client_of(aws_s3_settings, client)
    attach_writer(
        table, lambda column_names: ObjectStoreWriter(store, path, JsonLinesFormatter(), column_names)
    )
