"""``pw.io``: the python connector, subscribe, the file connectors (``fs``, ``csv``,
``jsonlines``, ``plaintext``, ``null``) and the in-process connectors: ``http`` (the REST
ingress, the polling reader and the writer), ``logstash``, ``sqlite``, the object stores
(``s3``, ``minio``, ``s3_csv``, ``pyfilesystem``, ``gdrive``), ``deltalake``, the
input synchronization groups, and the message buses: ``kafka`` and ``redpanda`` over the
Kafka wire, ``debezium``, ``nats`` and ``pubsub``. The databases, Iceberg and Airbyte
raise ``NotImplementedError`` naming the ROADMAP item that ports them (item 15)."""

from pathway_tpu_torch.internals.unported import module_getattr
from pathway_tpu_torch.io import (
    csv,
    debezium,
    deltalake,
    fs,
    gdrive,
    http,
    jsonlines,
    kafka,
    logstash,
    minio,
    nats,
    null,
    plaintext,
    pubsub,
    pyfilesystem,
    python,
    redpanda,
    s3,
    s3_csv,
    sqlite,
)
from pathway_tpu_torch.io._subscribe import subscribe
from pathway_tpu_torch.io._synchronization import register_input_synchronization_group

__all__ = [
    "csv",
    "debezium",
    "deltalake",
    "fs",
    "gdrive",
    "http",
    "jsonlines",
    "kafka",
    "logstash",
    "minio",
    "nats",
    "null",
    "plaintext",
    "pubsub",
    "pyfilesystem",
    "python",
    "redpanda",
    "register_input_synchronization_group",
    "s3",
    "s3_csv",
    "sqlite",
    "subscribe",
]

#: the reference's connector modules (``pathway_tpu/io/``) not ported yet
CONNECTORS = ("airbyte", "bigquery", "elasticsearch", "iceberg", "mongodb", "postgres", "slack")

__getattr__ = module_getattr(__name__, dict.fromkeys(CONNECTORS, "15: the other connectors"))
