"""Where each operator's input rows would live under sharded execution.

Counterpart of ``pathway_tpu/engine/sharded.py``'s :func:`partition_rule` (lines 86-140
there), the one classification of how entries entering a consumer pick their worker.
The port reads it on one card: the shard-preservation model
(``analysis/shards.py``) derives the optimizer's exchange-elision marks from it. The
sharded scheduler, its partitioner closures and the exchange routing are not ported
yet (ROADMAP queue 1 item 14): those names raise ``NotImplementedError``, and
``pw.run`` raises on ``threads`` or ``processes`` above 1.

The row transformers' ``RecomputeNode``, which the reference pins to worker 0, is not
ported yet either (item 8), so it is absent from the pinned kinds below.
"""

from __future__ import annotations

from pathway_tpu_torch.engine.graph import (
    DeduplicateNode,
    ErrorLogNode,
    GroupbyNode,
    IxNode,
    JoinNode,
    Node,
    SortNode,
    SubscribeNode,
)
from pathway_tpu_torch.internals.unported import module_getattr


def partition_rule(consumer: Node, port: int) -> tuple:
    """How entries entering ``consumer`` on ``port`` pick their worker:

    - ``("pin",)``        everything to worker 0 (a globally stateful operator)
    - ``("key",)``        by row key
    - ``("cols", cols)``  by ``hash(tuple(row[c] for c in cols))``
    - ``("col", c)``      by the bare value ``row[c]`` (c None = constant)
    """
    from pathway_tpu_torch.engine import temporal as _temporal
    from pathway_tpu_torch.engine.external_index import ExternalIndexNode
    from pathway_tpu_torch.engine.iterate import IterateNode

    if isinstance(consumer, GroupbyNode):
        return ("cols", list(consumer.by_cols))
    if isinstance(consumer, DeduplicateNode):
        return ("cols", list(consumer.instance_cols))
    if isinstance(consumer, JoinNode):
        return ("cols", list(consumer.left_on if port == 0 else consumer.right_on))
    if isinstance(consumer, SortNode):
        return ("col", consumer.instance_col)
    if isinstance(consumer, IxNode):
        return ("col", consumer.key_col) if port == 0 else ("key",)
    if isinstance(
        consumer,
        (
            SubscribeNode,
            ErrorLogNode,
            ExternalIndexNode,
            IterateNode,
            _temporal.GradualBroadcastNode,  # needs the threshold triplet
            _temporal.BufferNode,
            _temporal.ForgetNode,
            _temporal.FreezeNode,
            _temporal.SessionAssignNode,
            _temporal.IntervalJoinNode,
            _temporal.AsofJoinNode,
            _temporal.AsofNowJoinNode,
        ),
    ):
        return ("pin",)  # global state: pin to worker 0
    return ("key",)


__getattr__ = module_getattr(__name__, dict.fromkeys(
    ("ShardedScheduler", "partitioner", "EXCHANGE_STATS", "batch_shards",
     "columnar_shards", "entry_shards", "shards_of_values"),
    "14: the sharded and distributed runners",
))
