"""The standard library: retrieval indexes (``stdlib.indexing``), ``stateful``'s
``deduplicate``, the temporal operators (``stdlib.temporal``) and the graph algorithms
over ``pw.iterate`` (``stdlib.graphs``). Its other modules raise ``NotImplementedError``
naming the ROADMAP item that ports them."""

from pathway_tpu_torch.internals.unported import module_getattr
from pathway_tpu_torch.stdlib import graphs, indexing, stateful, temporal

__all__ = ["graphs", "indexing", "stateful", "temporal"]

__getattr__ = module_getattr(__name__, dict.fromkeys(
    ("ml", "ordered", "statistical", "utils", "viz"), "8: the rest of the package (the stdlib)"
))
