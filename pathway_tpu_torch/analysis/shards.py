"""Shard preservation: which exchange edges provably move no rows.

Counterpart of ``pathway_tpu/analysis/shards.py``'s model (lines 39-139 there). Under
sharded execution every producer -> consumer edge goes through an exchange governed by
``engine/sharded.py::partition_rule``. A node's output partitioning is a set of specs,
each the normalized form of a partition rule:

- ``("key",)``       rows live on ``_shard_of(row_key)``
- ``("cols", cols)`` rows live on ``_shard_of(tuple(row[c] for c in cols))``
- ``("col", c)``     rows live on ``_shard_of(row[c])``

An exchange into a consumer whose rule is already in the producer's set moves no rows:
:func:`redundant_edges` lists those edges, the optimizer's exchange-elision oracle. On
one card the marks reach only the optimizer's fingerprint and stats. The analyzer's
findings (``run_pass``, PWA201/PWA202) are not ported yet (ROADMAP queue 1 item 8).

Soundness, as in the reference: groupby output keys hash the by-values under the
groupby's own salt, so its output is cols-partitioned on its leading by-columns, not
key-partitioned; join output carries both sides' key values, so both specs hold for an
inner join, and only the surviving side's for a left or right join; a node whose
arrival rule is ``("pin",)`` emits everything from worker 0.
"""

from __future__ import annotations

from pathway_tpu_torch.engine import graph as g
from pathway_tpu_torch.engine.sharded import partition_rule
from pathway_tpu_torch.internals.unported import module_getattr

Spec = tuple


def _norm(rule: tuple) -> Spec:
    if rule[0] == "cols":
        return ("cols", tuple(rule[1]))
    return tuple(rule)


def _passthrough(node: g.Node) -> bool:
    """Same keys, same column positions in = out."""
    return isinstance(
        node,
        (
            g.FilterNode,
            g.KeyFilterNode,
            g.OverrideUniverseNode,
            g._RemoveErrorsNode,
            g.DeduplicateNode,
        ),
    )


def out_specs(node: g.Node) -> set[Spec]:
    """Partitioning properties of ``node``'s output batches."""
    arrival = _norm(partition_rule(node, 0))
    if arrival[0] == "pin":
        return set()
    if isinstance(node, (g.StaticSource, g.InputSession)):
        # sources are read whole on worker 0 and enter the exchange unpartitioned
        return set()
    if isinstance(node, g.GroupbyNode):
        # output rows land on the worker owning their by-values, the leading columns
        return {("cols", tuple(range(len(node.by_cols))))}
    if isinstance(node, g.JoinNode):
        la = node.inputs[0].arity
        specs = {("cols", tuple(node.left_on))}
        specs.add(("cols", tuple(la + c for c in node.right_on)))
        if node.kind != g.JoinKind.INNER:
            # padded rows carry None in the missing side's key columns yet live on
            # the surviving side's worker: only that side's spec holds
            specs = (
                {("cols", tuple(node.left_on))}
                if node.kind == g.JoinKind.LEFT
                else {("cols", tuple(la + c for c in node.right_on))}
                if node.kind == g.JoinKind.RIGHT
                else set()
            )
        return specs
    if _passthrough(node):
        return {arrival}
    if isinstance(
        node,
        (
            g.ExpressionNode,
            g.BatchApplyNode,
            g.ConcatNode,
            g.ZipNode,
            g.UpdateRowsNode,
            g.UpdateCellsNode,
        ),
    ):
        # keys are preserved and the column layout changes: only a key-based arrival
        # property survives
        return {arrival} if arrival == ("key",) else set()
    # rekeying, lookup and unknown kinds: nothing provable
    return set()


def redundant_edges(scope: g.Scope) -> list[tuple[int, int, int, Spec]]:
    """Every exchange edge that provably moves no rows, as ``(producer_index,
    consumer_index, port, rule)``: the exchange-elision oracle of
    ``pathway_tpu_torch.optimize``."""
    specs: dict[int, set[Spec]] = {node.index: out_specs(node) for node in scope.nodes}
    edges: list[tuple[int, int, int, Spec]] = []
    for node in scope.nodes:
        produced = specs[node.index]
        if not produced:
            continue
        for consumer, port in node.consumers:
            rule = _norm(partition_rule(consumer, port))
            if rule[0] == "pin":
                continue
            if rule in produced:
                edges.append((node.index, consumer.index, port, rule))
    return edges


__getattr__ = module_getattr(__name__, dict.fromkeys(
    ("run_pass",), "8: the rest of the package (the static analyzer)"
))
