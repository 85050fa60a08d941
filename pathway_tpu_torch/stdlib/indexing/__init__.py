"""Indexing: ``DataIndex`` over the KNN index on the card, the host BM25 index, and
reciprocal-rank fusion of several indexes (``HybridIndex``)."""

from pathway_tpu_torch.stdlib.indexing.bm25 import TantivyBM25Factory
from pathway_tpu_torch.stdlib.indexing.data_index import (
    BruteForceKnnFactory,
    DataIndex,
    DeviceKnnFactory,
    HostKnnFactory,
    InnerIndexFactory,
)
from pathway_tpu_torch.stdlib.indexing.hybrid_index import HybridIndex

__all__ = [
    "BruteForceKnnFactory",
    "DataIndex",
    "DeviceKnnFactory",
    "HostKnnFactory",
    "HybridIndex",
    "InnerIndexFactory",
    "TantivyBM25Factory",
]
