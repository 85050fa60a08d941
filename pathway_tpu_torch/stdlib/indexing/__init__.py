"""Indexing: ``DataIndex`` over the KNN index on the card."""

from pathway_tpu_torch.stdlib.indexing.data_index import (
    BruteForceKnnFactory,
    DataIndex,
    DeviceKnnFactory,
    HostKnnFactory,
    InnerIndexFactory,
)

__all__ = [
    "BruteForceKnnFactory",
    "DataIndex",
    "DeviceKnnFactory",
    "HostKnnFactory",
    "InnerIndexFactory",
]
