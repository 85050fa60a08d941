"""``pw.io.redpanda``: Redpanda speaks the Kafka protocol, so this is ``pw.io.kafka``
under Redpanda's name (counterpart of ``pathway_tpu/io/redpanda.py``)."""

from pathway_tpu_torch.io.kafka import read, simple_read, write  # noqa: F401

__all__ = ["read", "simple_read", "write"]
