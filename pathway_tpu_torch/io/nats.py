"""``pw.io.nats``: read and write a NATS subject.

Counterpart of ``pathway_tpu/io/nats.py``: the same engine seam as ``pw.io.kafka``,
with ``io/_nats_wire.py``'s :class:`NatsTransport` (INFO/CONNECT handshake, PUB/SUB/MSG
frames, token or user/password auth) as the default transport; an injected
``transport=`` takes its place. ``uri`` is ``nats://[user:pass@]host:port``, or
``nats://<token>@host:port``."""

from __future__ import annotations

from typing import Any
from urllib.parse import urlparse

from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import kafka as _kafka


def _wire_transport(
    uri: str | None, topic: str | None, subscribe: bool = True
) -> Any:
    from pathway_tpu_torch.io._nats_wire import NatsTransport

    if uri is None or topic is None:
        raise ValueError("pw.io.nats needs uri and topic")
    parsed = urlparse(uri if "://" in uri else f"nats://{uri}")
    user = parsed.username or None
    password = parsed.password or None
    token = None
    if user is not None and password is None:
        # nats://<token>@host — bare userinfo is a token (nats.io URLs)
        token, user = user, None
    return NatsTransport(
        parsed.hostname or "127.0.0.1",
        parsed.port or 4222,
        topic,
        token=token,
        user=user,
        password=password,
        subscribe=subscribe,
    )


def read(
    uri: str | None = None,
    topic: str | None = None,
    *,
    schema: schema_mod.SchemaMetaclass | None = None,
    format: str = "json",  # noqa: A002
    transport: Any = None,
    **kwargs: Any,
) -> Table:
    """Read a NATS subject: SUB over the wire
    client; ``uri`` accepts ``nats://[user:pass@]host:port``."""
    if transport is None:
        transport = _wire_transport(uri, topic)
    return _kafka.read(
        None, topic, schema=schema, format=format, transport=transport, **kwargs
    )


def write(
    table: Table,
    uri: str | None = None,
    topic: str | None = None,
    *,
    transport: Any = None,
    **kwargs: Any,
) -> None:
    """Publish a table's update stream to a NATS subject: PUB frames over
    the wire client."""
    if transport is None:
        transport = _wire_transport(uri, topic, subscribe=False)
    _kafka.write(table, None, topic, transport=transport, **kwargs)
