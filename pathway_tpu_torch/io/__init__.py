"""``pw.io``: the python connector and subscribe. The other connectors raise
``NotImplementedError`` naming the ROADMAP item that ports them (item 15)."""

from pathway_tpu_torch.internals.unported import module_getattr
from pathway_tpu_torch.io import python
from pathway_tpu_torch.io._subscribe import subscribe

__all__ = ["python", "subscribe"]

#: the reference's connector modules (``pathway_tpu/io/``) but ``python``
CONNECTORS = (
    "airbyte", "bigquery", "csv", "debezium", "deltalake", "elasticsearch", "fs",
    "gdrive", "http", "iceberg", "jsonlines", "kafka", "logstash", "minio", "mongodb",
    "nats", "null", "plaintext", "postgres", "pubsub", "pyfilesystem", "redpanda", "s3",
    "s3_csv", "slack", "sqlite",
)

__getattr__ = module_getattr(__name__, dict.fromkeys(
    (*CONNECTORS, "register_input_synchronization_group"),
    "15: the other connectors",
))
