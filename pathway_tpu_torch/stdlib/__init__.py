"""The standard library: retrieval indexes (``stdlib.indexing``) and ``stateful``'s
``deduplicate``. Its other modules raise ``NotImplementedError`` naming the ROADMAP item
that ports them."""

from pathway_tpu_torch.internals.unported import module_getattr
from pathway_tpu_torch.stdlib import indexing, stateful

__all__ = ["indexing", "stateful"]

__getattr__ = module_getattr(__name__, {
    **dict.fromkeys(("graphs", "ml", "ordered", "statistical", "utils", "viz"),
            "8: the rest of the package (the stdlib)"),
    "temporal": "11: the other node types and table operations (the temporal operators)",
})
