"""``pw.io``: the python connector, subscribe, the file connectors (``fs``, ``csv``,
``jsonlines``, ``plaintext``, ``null``) and the in-process connectors: ``http`` (the REST
ingress, the polling reader and the writer), ``logstash``, ``sqlite``, the object stores
(``s3``, ``minio``, ``s3_csv``, ``pyfilesystem``, ``gdrive``), ``deltalake`` and the
input synchronization groups. The message buses and databases raise
``NotImplementedError`` naming the ROADMAP item that ports them (item 15)."""

from pathway_tpu_torch.internals.unported import module_getattr
from pathway_tpu_torch.io import (
    csv,
    deltalake,
    fs,
    gdrive,
    http,
    jsonlines,
    logstash,
    minio,
    null,
    plaintext,
    pyfilesystem,
    python,
    s3,
    s3_csv,
    sqlite,
)
from pathway_tpu_torch.io._subscribe import subscribe
from pathway_tpu_torch.io._synchronization import register_input_synchronization_group

__all__ = [
    "csv",
    "deltalake",
    "fs",
    "gdrive",
    "http",
    "jsonlines",
    "logstash",
    "minio",
    "null",
    "plaintext",
    "pyfilesystem",
    "python",
    "register_input_synchronization_group",
    "s3",
    "s3_csv",
    "sqlite",
    "subscribe",
]

#: the reference's connector modules (``pathway_tpu/io/``) not ported yet
CONNECTORS = (
    "airbyte", "bigquery", "debezium", "elasticsearch", "iceberg", "kafka", "mongodb",
    "nats", "postgres", "pubsub", "redpanda", "slack",
)

__getattr__ = module_getattr(__name__, dict.fromkeys(CONNECTORS, "15: the other connectors"))
