"""``pw.io.kafka``: read and write Kafka topics over the Kafka wire protocol.

Counterpart of ``pathway_tpu/io/kafka.py``. With ``transport=None`` (the default) a
connector reaches ``bootstrap.servers`` through the port's own client
(``io/_kafka_wire.py``: Metadata, Produce, Fetch and ListOffsets, RecordBatch v2 with
CRC32C), so no Kafka library is needed; an injected ``MessageTransport`` (such as
:class:`InMemoryTransport`) takes its place. Formats: ``raw`` and ``plaintext`` (one
``data`` column), ``json`` (the schema's columns) and ``avro`` (Confluent schema-registry
framing, :class:`SchemaRegistry`). With a primary key the stream is an upsert stream,
and a compacted topic's tombstone (a null value) deletes the row of its message key.
:func:`read_from_upstash` consumes through Upstash's Kafka REST API.
"""

from __future__ import annotations

import json as _json
import struct as _struct
from typing import Any, Callable, Sequence

from pathway_tpu_torch.engine.connectors import (
    INSERT,
    UPSERT,
    JsonLinesFormatter,
    Parser,
    ParsedEvent,
)
from pathway_tpu_torch.engine.storage import (
    InMemoryTransport,
    MessageQueueReader,
    MessageQueueWriter,
)
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._utils import attach_writer, input_table
from pathway_tpu_torch.io._kafka_wire import (  # noqa: F401 — re-exported API
    FakeKafkaBroker,
    KafkaWireClient,
    KafkaWireTransport,
)

__all__ = [
    "read",
    "write",
    "simple_read",
    "read_from_upstash",
    "InMemoryTransport",
    "FakeKafkaBroker",
    "KafkaWireTransport",
    "SchemaRegistry",
]


class _KafkaJsonParser(Parser):
    """value bytes -> JSON object -> schema columns; keyed by primary key
    columns when given (an upsert session), else plain inserts."""

    def __init__(
        self, column_names: Sequence[str], primary_key: Sequence[str] | None
    ) -> None:
        super().__init__(column_names)
        self.primary_key = list(primary_key) if primary_key else None
        self.session_type = "upsert" if self.primary_key else "native"

    def parse(self, payload: Any) -> list[ParsedEvent]:
        import json

        from pathway_tpu_torch.engine.value import Json

        msg_key, value = payload
        if value is None:
            # compacted-topic tombstone: with a primary key it deletes the
            # row whose key matches the message key (JSON-decoded when
            # possible, raw string otherwise)
            if not self.primary_key or msg_key is None:
                return []
            if isinstance(msg_key, bytes):
                msg_key = msg_key.decode("utf-8")
            try:
                decoded = json.loads(msg_key)
            except (ValueError, TypeError):
                decoded = msg_key
            if isinstance(decoded, dict):
                key = tuple(decoded.get(k) for k in self.primary_key)
            elif len(self.primary_key) == 1:
                key = (decoded,)
            else:
                raise ValueError(
                    "tombstone key must be a JSON object for a composite "
                    "primary key"
                )
            return [ParsedEvent(UPSERT, None, key=key)]
        if isinstance(value, bytes):
            value = value.decode("utf-8")
        obj = json.loads(value)
        values = tuple(
            Json(v) if isinstance(v, (dict, list)) else v
            for v in (obj.get(name) for name in self.column_names)
        )
        if self.primary_key:
            key = tuple(obj.get(k) for k in self.primary_key)
            return [ParsedEvent(UPSERT, values, key=key)]
        return [ParsedEvent(INSERT, values)]


class _KafkaRawParser(Parser):
    """value bytes -> single `data` column (format='raw'/'plaintext')."""

    def __init__(self, binary: bool) -> None:
        super().__init__(["data"])
        self.binary = binary

    def parse(self, payload: Any) -> list[ParsedEvent]:
        _key, value = payload
        if value is None:
            return []
        if self.binary and isinstance(value, str):
            value = value.encode("utf-8")
        if not self.binary and isinstance(value, bytes):
            value = value.decode("utf-8")
        return [ParsedEvent(INSERT, (value,))]


def _default_transport(
    rdkafka_settings: dict, topic: Any, mode: str = "streaming"
) -> KafkaWireTransport:
    bootstrap = rdkafka_settings.get("bootstrap.servers")
    if not bootstrap:
        raise ValueError(
            "rdkafka_settings['bootstrap.servers'] is required when no "
            "transport= is given"
        )
    if isinstance(topic, (list, tuple)):
        if len(topic) != 1:
            raise ValueError(
                "the wire transport reads one topic per connector; create "
                "one read() per topic"
            )
        topic = topic[0]
    if topic is None:
        raise ValueError("topic is required")
    start = rdkafka_settings.get("auto.offset.reset", "earliest")
    return KafkaWireTransport(
        bootstrap.split(",")[0], topic, mode=mode, start=start
    )


# -- Confluent-style schema registry ------------------------------------------


class SchemaRegistry:
    """Minimal Confluent schema-registry client (wire format: magic 0x00 +
    int32 schema id + Avro body). ``request_fn(method, url, payload|None) -> dict`` is
    injectable; the default uses urllib against ``url``."""

    def __init__(
        self,
        url: str,
        request_fn: Callable[[str, str, dict | None], dict] | None = None,
    ) -> None:
        self.url = url.rstrip("/")
        if request_fn is None:

            def request_fn(method: str, full_url: str, payload):
                if method == "POST":
                    from pathway_tpu_torch.io._utils import post_json

                    return post_json(
                        full_url,
                        payload,
                        timeout=30.0,
                        content_type=(
                            "application/vnd.schemaregistry.v1+json"
                        ),
                    )
                import urllib.request

                req = urllib.request.Request(full_url, method=method)
                with urllib.request.urlopen(req, timeout=30) as resp:
                    return _json.loads(resp.read().decode())

        self.request_fn = request_fn
        self._by_id: dict[int, Any] = {}

    def get_schema(self, schema_id: int) -> Any:
        got = self._by_id.get(schema_id)
        if got is None:
            body = self.request_fn(
                "GET", f"{self.url}/schemas/ids/{schema_id}", None
            )
            got = _json.loads(body["schema"])
            self._by_id[schema_id] = got
        return got

    def register(self, subject: str, schema: Any) -> int:
        body = self.request_fn(
            "POST",
            f"{self.url}/subjects/{subject}/versions",
            {"schema": _json.dumps(schema)},
        )
        schema_id = int(body["id"])
        self._by_id[schema_id] = schema
        return schema_id

    def decode_message(self, raw: bytes) -> Any:
        import io as _io

        from pathway_tpu_torch.io import _avro

        if not raw or raw[0] != 0:
            raise ValueError(
                "not a schema-registry framed message (magic byte != 0)"
            )
        (schema_id,) = _struct.unpack(">i", raw[1:5])
        schema = self.get_schema(schema_id)
        return _avro.decode(_io.BytesIO(raw[5:]), schema)

    def encode_message(self, schema_id: int, value: Any) -> bytes:
        import io as _io

        from pathway_tpu_torch.io import _avro

        out = _io.BytesIO()
        out.write(b"\x00")
        out.write(_struct.pack(">i", schema_id))
        _avro.encode(out, self.get_schema(schema_id), value)
        return out.getvalue()


_AVRO_TYPES = {
    "INT": "long",
    "FLOAT": "double",
    "BOOL": "boolean",
    "STR": "string",
    "BYTES": "bytes",
}


def _avro_schema_of(schema: schema_mod.SchemaMetaclass, name: str) -> dict:
    fields = []
    for col, dtype in dict(schema.dtypes()).items():
        base = dtype.strip_optional()
        avro_t: Any = _AVRO_TYPES.get(str(base), "string")
        if dtype.is_optional():
            avro_t = ["null", avro_t]
        fields.append({"name": col, "type": avro_t})
    return {"type": "record", "name": name, "fields": fields}


class _KafkaAvroParser(Parser):
    """Schema-registry framed Avro value -> schema columns."""

    def __init__(
        self,
        column_names: Sequence[str],
        primary_key: Sequence[str] | None,
        registry: SchemaRegistry,
    ) -> None:
        super().__init__(column_names)
        self.primary_key = list(primary_key) if primary_key else None
        self.session_type = "upsert" if self.primary_key else "native"
        self.registry = registry

    def parse(self, payload: Any) -> list[ParsedEvent]:
        msg_key, value = payload
        if value is None:
            # tombstone: decode the message key exactly like the JSON
            # parser so int / composite primary keys retract correctly
            if not self.primary_key or msg_key is None:
                return []
            if isinstance(msg_key, bytes):
                msg_key = msg_key.decode()
            try:
                decoded = _json.loads(msg_key)
            except (ValueError, TypeError):
                decoded = msg_key
            if isinstance(decoded, dict):
                key = tuple(decoded.get(k) for k in self.primary_key)
            elif len(self.primary_key) == 1:
                key = (decoded,)
            else:
                raise ValueError(
                    "tombstone key must be a JSON object for a composite "
                    "primary key"
                )
            return [ParsedEvent(UPSERT, None, key=key)]
        obj = self.registry.decode_message(value)
        values = tuple(obj.get(name) for name in self.column_names)
        if self.primary_key:
            key = tuple(obj.get(k) for k in self.primary_key)
            return [ParsedEvent(UPSERT, values, key=key)]
        return [ParsedEvent(INSERT, values)]


class _AvroRegistryFormatter:
    """Row -> schema-registry framed Avro message (write side)."""

    def __init__(self, registry: SchemaRegistry, schema_id: int) -> None:
        self.registry = registry
        self.schema_id = schema_id

    def format(self, key, values, column_names, time, diff):
        obj = {name: v for name, v in zip(column_names, values)}
        obj["time"] = time
        obj["diff"] = diff
        return self.registry.encode_message(self.schema_id, obj)


def read(
    rdkafka_settings: dict | None = None,
    topic: str | list[str] | None = None,
    *,
    schema: schema_mod.SchemaMetaclass | None = None,
    format: str = "raw",  # noqa: A002
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    primary_key: Sequence[str] | None = None,
    transport: Any = None,
    schema_registry: SchemaRegistry | None = None,
    persistent_id: str | None = None,
    **kwargs: Any,
) -> Table:
    """Read a topic. ``format``: 'raw'/'plaintext' (single ``data``
    column), 'json' (schema columns; with ``primary_key`` the stream is
    an upsert stream: later messages for a key replace earlier ones), or
    'avro' (schema-registry framed messages, needs ``schema_registry=``).
    ``mode='static'`` reads to the topic end offset and finishes."""
    if transport is None:
        transport = _default_transport(rdkafka_settings or {}, topic, mode)

    if format in ("raw", "plaintext"):
        schema = schema_mod.schema_from_types(
            data=bytes if format == "raw" else str
        )
        make_parser = lambda names: _KafkaRawParser(binary=format == "raw")  # noqa: E731
    elif format == "json":
        if schema is None:
            raise ValueError("format='json' needs schema=")
        pk = primary_key or schema.primary_key_columns() or None
        make_parser = lambda names: _KafkaJsonParser(names, pk)  # noqa: E731
    elif format == "avro":
        if schema is None:
            raise ValueError("format='avro' needs schema=")
        if schema_registry is None:
            raise ValueError("format='avro' needs schema_registry=")
        pk = primary_key or schema.primary_key_columns() or None
        make_parser = lambda names: _KafkaAvroParser(  # noqa: E731
            names, pk, schema_registry
        )
    else:
        raise ValueError(f"unknown kafka format {format!r}")

    return input_table(
        schema,
        lambda: MessageQueueReader(transport),
        make_parser,
        source_name=f"kafka:{topic}",
        persistent_id=persistent_id,
        autocommit_duration_ms=autocommit_duration_ms,
    )


def simple_read(
    server: str, topic: str, *, transport: Any = None, **kwargs: Any
) -> Table:
    """A raw read of ``topic`` from ``server``."""
    return read(
        {"bootstrap.servers": server}, topic, transport=transport, **kwargs
    )


def write(
    table: Table,
    rdkafka_settings: dict | None = None,
    topic_name: str | None = None,
    *,
    format: str = "json",  # noqa: A002
    key: str | None = None,
    transport: Any = None,
    schema_registry: SchemaRegistry | None = None,
    **kwargs: Any,
) -> None:
    """Produce one message per change. ``format='json'`` emits the row +
    time + diff as JSON; ``format='avro'`` registers the table schema
    under ``{topic}-value`` and emits schema-registry framed Avro."""
    if transport is None:
        transport = _default_transport(rdkafka_settings or {}, topic_name)
    if format == "json":
        formatter: Any = JsonLinesFormatter()
    elif format == "avro":
        if schema_registry is None:
            raise ValueError("format='avro' needs schema_registry=")
        avro_schema = _avro_schema_of(
            table.schema, (topic_name or "table") + "_value"
        )
        avro_schema["fields"] += [
            {"name": "time", "type": "long"},
            {"name": "diff", "type": "long"},
        ]
        schema_id = schema_registry.register(
            f"{topic_name or 'table'}-value", avro_schema
        )
        formatter = _AvroRegistryFormatter(schema_registry, schema_id)
    else:
        raise ValueError(f"unsupported kafka write format {format!r}")

    def make_writer(column_names):
        key_index = column_names.index(key) if key else None
        return MessageQueueWriter(
            transport, formatter, column_names, key_index=key_index
        )

    attach_writer(table, make_writer)


def read_from_upstash(
    endpoint: str,
    username: str,
    password: str,
    topic: str,
    *,
    consumer_group: str = "pathway-group",
    instance_name: str = "pathway-instance",
    schema: schema_mod.SchemaMetaclass | None = None,
    format: str = "raw",  # noqa: A002
    autocommit_duration_ms: int | None = 1500,
    primary_key: Sequence[str] | None = None,
    request_fn: Callable[[str, dict], list] | None = None,
    **kwargs: Any,
) -> Table:
    """Consume a topic through the Upstash Kafka REST API: repeated POSTs to
    ``{endpoint}/consume/{group}/{instance}/{topic}`` with basic auth;
    each response item is ``{"key","value","offset","partition",...}``.
    ``request_fn(url, headers) -> list`` is injectable for offline use."""
    from pathway_tpu_torch.engine.storage import Message

    if request_fn is None:

        def request_fn(url: str, headers: dict) -> list:  # pragma: no cover
            import urllib.request

            req = urllib.request.Request(url, method="POST", headers=headers)
            with urllib.request.urlopen(req, timeout=60) as resp:
                return _json.loads(resp.read().decode())

    import base64

    auth = base64.b64encode(f"{username}:{password}".encode()).decode()
    url = (
        f"{endpoint.rstrip('/')}/consume/{consumer_group}/"
        f"{instance_name}/{topic}"
    )
    headers = {"Authorization": f"Basic {auth}"}

    # an injected request_fn may carry a ``finished`` callable to end the
    # stream (tests / bounded replays); the real REST consume never ends
    finished_fn = getattr(request_fn, "finished", None)

    class _UpstashTransport:
        def poll_messages(self) -> list:
            out = []
            for item in request_fn(url, headers):
                value = item.get("value")
                if isinstance(value, str):
                    value = value.encode()
                msg_key = item.get("key")
                if isinstance(msg_key, str):
                    msg_key = msg_key.encode()
                out.append(
                    Message(
                        value,
                        key=msg_key,
                        topic=item.get("topic", topic),
                        partition=item.get("partition", 0),
                        offset=item.get("offset", 0),
                    )
                )
            return out

        def finished(self) -> bool:
            return bool(finished_fn()) if finished_fn is not None else False

    return read(
        None,
        topic,
        schema=schema,
        format=format,
        autocommit_duration_ms=autocommit_duration_ms,
        primary_key=primary_key,
        transport=_UpstashTransport(),
        **kwargs,
    )
