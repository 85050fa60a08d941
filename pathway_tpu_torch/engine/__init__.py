"""The engine: values and keys, delta batches, expressions, lazy device rows, the
operator graph and its scheduler, connectors, and the as-of-now KNN index on the card
with its operator."""

from pathway_tpu_torch.engine.external_index import (
    DeviceKnnIndex,
    ExternalIndexNode,
    HostKnnIndex,
)

__all__ = ["DeviceKnnIndex", "ExternalIndexNode", "HostKnnIndex"]
