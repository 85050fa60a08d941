"""Indexing: ``DataIndex`` over the KNN index on the card."""

from pathway_tpu_torch.stdlib.indexing.data_index import (
    DataIndex,
    DeviceKnnFactory,
    HostKnnFactory,
    InnerIndexFactory,
)

__all__ = ["DataIndex", "DeviceKnnFactory", "HostKnnFactory", "InnerIndexFactory"]
