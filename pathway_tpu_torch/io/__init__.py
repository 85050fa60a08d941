"""``pw.io``: the python connector, subscribe, and the file connectors (``fs``,
``csv``, ``jsonlines``, ``plaintext``, ``null``). The other connectors raise
``NotImplementedError`` naming the ROADMAP item that ports them (item 15)."""

from pathway_tpu_torch.internals.unported import module_getattr
from pathway_tpu_torch.io import csv, fs, jsonlines, null, plaintext, python
from pathway_tpu_torch.io._subscribe import subscribe

__all__ = ["csv", "fs", "jsonlines", "null", "plaintext", "python", "subscribe"]

#: the reference's connector modules (``pathway_tpu/io/``) not ported yet
CONNECTORS = (
    "airbyte", "bigquery", "debezium", "deltalake", "elasticsearch", "gdrive", "http",
    "iceberg", "kafka", "logstash", "minio", "mongodb", "nats", "postgres", "pubsub",
    "pyfilesystem", "redpanda", "s3", "s3_csv", "slack", "sqlite",
)

__getattr__ = module_getattr(__name__, dict.fromkeys(
    (*CONNECTORS, "register_input_synchronization_group"),
    "15: the other connectors",
))
