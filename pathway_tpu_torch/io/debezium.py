"""``pw.io.debezium``: read a Debezium change stream from a Kafka topic.

Counterpart of ``pathway_tpu/io/debezium.py``: the topic's envelopes go through
``engine/formats.py``'s :class:`DebeziumParser`; ``db_type="postgres"`` (before and
after images) gives a native stream of deletes and inserts, ``db_type="mongodb"``
(after images only) an upsert stream. Rows are keyed by the schema's primary-key
columns, read from the message key's payload."""

from __future__ import annotations

from typing import Any, Sequence

from pathway_tpu_torch.engine.formats import DebeziumParser
from pathway_tpu_torch.engine.storage import MessageQueueReader
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._utils import input_table


def read(
    rdkafka_settings: dict | None = None,
    topic_name: str | None = None,
    *,
    schema: schema_mod.SchemaMetaclass,
    db_type: str = "postgres",
    transport: Any = None,
    autocommit_duration_ms: int | None = 1500,
    persistent_id: str | None = None,
    **kwargs: Any,
) -> Table:
    """Consume a Debezium CDC topic. ``db_type``: 'postgres' (full
    before/after images -> native diffs) or 'mongodb' (after images only ->
    upsert stream). Keys come from the message-key payload using the
    schema's primary key columns."""
    if transport is None:
        from pathway_tpu_torch.io.kafka import _default_transport

        transport = _default_transport(rdkafka_settings or {}, topic_name)
    pk: Sequence[str] | None = schema.primary_key_columns() or None

    return input_table(
        schema,
        lambda: MessageQueueReader(transport),
        lambda names: DebeziumParser(names, key_field_names=pk, db_type=db_type),
        source_name=f"debezium:{topic_name}",
        persistent_id=persistent_id,
        autocommit_duration_ms=autocommit_duration_ms,
    )
