"""Nearest-neighbour index factories by the reference's names.

Counterpart of ``pathway_tpu/stdlib/indexing/nearest_neighbors.py``:
``USearchKnnFactory`` is ``BruteForceKnnFactory`` (the exact index on the card answers
for the USearch index, as it does in the JAX package). The pure-dataflow
``LshKnnFactory`` is not ported yet (ROADMAP queue 1 item 8).
"""

from pathway_tpu_torch.stdlib.indexing.data_index import BruteForceKnnFactory

USearchKnnFactory = BruteForceKnnFactory
