"""Exchange elision: mark the provably redundant producer -> consumer edges.

Counterpart of ``pathway_tpu/optimize/elide.py``. The oracle is
:func:`pathway_tpu_torch.analysis.shards.redundant_edges`. Marks are computed on the
post-pushdown, pre-fusion graph (pushdown only narrows Expression and StaticSource
producers, whose out-specs do not depend on arity), and fusion only renames edges:

- an edge into a chain head moves to the fused tail (the tail inherits the head's input
  port and its ``("key",)`` arrival rule);
- an edge inside a chain leaves the runtime set: the exchange it crossed has been fused
  away (it still counts in ``optimizer_stats()["exchanges_elided"]``).

The sharded and distributed schedulers (``engine/sharded.py``,
``engine/distributed.py``) read the returned ``(producer_index, consumer_index, port)``
set at delivery time, as the JAX package's do. The one-worker scheduler has no
exchange, so there the marks reach only the optimizer's fingerprint and stats.
"""

from __future__ import annotations

from pathway_tpu_torch.analysis.shards import redundant_edges


def plan(scope, n_shared: int) -> set[tuple[int, int, int]]:
    """Elidable edges on the primary scope, restricted to the shared node region."""
    marks = set()
    for prod, cons, port, _rule in redundant_edges(scope):
        if prod < n_shared and cons < n_shared:
            marks.add((prod, cons, port))
    return marks


def remap_through_fusion(
    marks: set[tuple[int, int, int]], chains: list[list[int]]
) -> set[tuple[int, int, int]]:
    """Rewrite pre-fusion marks into the post-fusion runtime set."""
    member_chain: dict[int, int] = {}
    for ci, chain in enumerate(chains):
        for idx in chain:
            member_chain[idx] = ci
    out = set()
    for prod, cons, port in marks:
        pc = member_chain.get(prod)
        cc = member_chain.get(cons)
        if pc is not None and cc is not None and pc == cc:
            continue  # inside one chain: fused away entirely
        if cc is not None:
            # only the head receives external input; the edge now lands on the tail
            cons = chains[cc][-1]
        if pc is not None and prod != chains[pc][-1]:
            continue  # interior producers no longer emit
        out.add((prod, cons, port))
    return out
