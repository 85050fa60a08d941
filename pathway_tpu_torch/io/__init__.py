"""``pw.io``: the python connector, subscribe, the file connectors (``fs``, ``csv``,
``jsonlines``, ``plaintext``, ``null``) and the in-process connectors: ``http`` (the REST
ingress, the polling reader and the writer), ``logstash``, ``sqlite``, the object stores
(``s3``, ``minio``, ``s3_csv``, ``pyfilesystem``, ``gdrive``), ``deltalake``, the
input synchronization groups, and the message buses: ``kafka`` and ``redpanda`` over the
Kafka wire, ``debezium``, ``nats`` and ``pubsub``, the databases (``postgres``,
``mongodb``, ``elasticsearch``, ``bigquery``, ``slack``) and the lakehouse (``iceberg``,
``airbyte``): every connector of the reference's ``pw.io``."""

from pathway_tpu_torch.io import (
    airbyte,
    bigquery,
    csv,
    debezium,
    deltalake,
    elasticsearch,
    fs,
    gdrive,
    http,
    iceberg,
    jsonlines,
    kafka,
    logstash,
    minio,
    mongodb,
    nats,
    null,
    plaintext,
    postgres,
    pubsub,
    pyfilesystem,
    python,
    redpanda,
    s3,
    s3_csv,
    slack,
    sqlite,
)
from pathway_tpu_torch.io._subscribe import subscribe
from pathway_tpu_torch.io._synchronization import register_input_synchronization_group

__all__ = [
    "airbyte",
    "bigquery",
    "csv",
    "debezium",
    "deltalake",
    "elasticsearch",
    "fs",
    "gdrive",
    "http",
    "iceberg",
    "jsonlines",
    "kafka",
    "logstash",
    "minio",
    "mongodb",
    "nats",
    "null",
    "plaintext",
    "postgres",
    "pubsub",
    "pyfilesystem",
    "python",
    "redpanda",
    "register_input_synchronization_group",
    "s3",
    "s3_csv",
    "slack",
    "sqlite",
    "subscribe",
]

#: the reference's connector modules (``pathway_tpu/io/``) not ported yet: none
CONNECTORS: tuple[str, ...] = ()
