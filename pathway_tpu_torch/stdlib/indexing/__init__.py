"""Indexing: ``DataIndex`` over the KNN index on the card (``USearchKnnFactory`` names
the same index), the host BM25 index, and reciprocal-rank fusion of several indexes
(``HybridIndex``). ``LshKnnFactory`` raises ``NotImplementedError`` naming its ROADMAP
item."""

from pathway_tpu_torch.internals.unported import module_getattr
from pathway_tpu_torch.stdlib.indexing.bm25 import TantivyBM25Factory
from pathway_tpu_torch.stdlib.indexing.data_index import (
    BruteForceKnnFactory,
    DataIndex,
    DeviceKnnFactory,
    HostKnnFactory,
    InnerIndexFactory,
)
from pathway_tpu_torch.stdlib.indexing.hybrid_index import HybridIndex
from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import USearchKnnFactory

__all__ = [
    "BruteForceKnnFactory",
    "DataIndex",
    "DeviceKnnFactory",
    "HostKnnFactory",
    "HybridIndex",
    "InnerIndexFactory",
    "TantivyBM25Factory",
    "USearchKnnFactory",
]


__getattr__ = module_getattr(__name__, {
    "LshKnnFactory": "8: the rest of the package (the stdlib's ml, LshKnnFactory)",
})
