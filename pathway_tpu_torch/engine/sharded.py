"""Workers in one process: key-sharded replicas of one graph, pumped in lockstep.

Counterpart of ``pathway_tpu/engine/sharded.py``. Every logical worker owns a full
engine :class:`Scope` built from the same program (as Pathway re-runs the graph logic
on each worker); the :class:`ShardedScheduler` propagates all of them commit by commit
on one thread. When an operator on worker w emits a batch for consumer B, the batch is
split by B's co-location key and each part is pushed to B's replica on the worker that
owns it:

- groupby and deduplicate: by the grouping or instance values;
- join: each side by its join-key columns;
- ix: the lookups to the owner of the row they point at;
- subscribe, the error log, the external index, iterate and the temporal operators:
  everything to worker 0 (their state is global);
- everything else: by row key.

Sources are read whole on worker 0 and enter the exchange there. The delivery planes
are the reference's: an edge the optimizer proved redundant skips routing, a pinned
consumer takes the whole batch on worker 0, a columnar batch may move through the
device collective (``engine/collective_exchange.py``) or else is split by a host
gather, and a row batch by its entries. ``routing.EXCHANGE_STATS`` counts each
decision once. The row transformers'
``RecomputeNode``, which the reference pins to worker 0, is not ported yet (item 8),
so it is absent from the pinned kinds below.
"""

from __future__ import annotations

import os
import threading
import time as _walltime
from typing import Callable, Sequence

import numpy as np

from pathway_tpu_torch.engine import collective_exchange as _collective
from pathway_tpu_torch.engine import device_pipeline
from pathway_tpu_torch.engine.batch import DeltaBatch, columnarize_entries
from pathway_tpu_torch.engine.device import VECTOR_THRESHOLD
from pathway_tpu_torch.engine.graph import (
    DeduplicateNode,
    ErrorLogNode,
    GroupbyNode,
    InputSession,
    IxNode,
    JoinNode,
    Node,
    OperatorStats,
    Scope,
    SortNode,
    StaticSource,
    SubscribeNode,
)
from pathway_tpu_torch.engine.routing import (
    EXCHANGE_STATS,
    _shard_of,
    batch_shards,
    columnar_shards,
    entry_shards,
    shards_of_values,
)
from pathway_tpu_torch.engine.value import Pointer
from pathway_tpu_torch.internals import metrics as _metrics
from pathway_tpu_torch.internals import tracing as _tracing

__all__ = ["EXCHANGE_STATS", "ShardedScheduler", "partition_rule", "partitioner"]

Entry = tuple


def _verify_elision() -> bool:
    """``PATHWAY_TPU_VERIFY_ELISION=1``: route every elided delivery again and check
    that the whole batch already lives on its worker (the optimizer's safety net)."""
    return os.environ.get("PATHWAY_TPU_VERIFY_ELISION") == "1"


def _assert_colocated(consumer: Node, port: int, out: DeltaBatch, worker: int, n: int) -> None:
    shards = batch_shards(partition_rule(consumer, port), out, n)
    if shards is not None and len(shards) and not (shards == worker).all():
        raise AssertionError(
            f"elided exchange into {consumer.name}#{consumer.index} "
            f"(port {port}) moved rows off worker {worker}"
        )


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



def partitioner(consumer: Node, port: int, n_workers: int) -> Callable[[Pointer, tuple], int] | None:
    """The per-row form of :func:`partition_rule`: ``(key, row) -> worker``, or None
    for a pinned consumer (worker 0)."""
    rule = partition_rule(consumer, port)
    kind = rule[0]
    if kind == "pin":
        return None
    if kind == "cols":
        cols = rule[1]

        def by_cols(key: Pointer, row: tuple) -> int:
            return _shard_of(tuple(row[c] for c in cols), n_workers)

        return by_cols
    if kind == "col":
        col = rule[1]

        def by_col(key: Pointer, row: tuple) -> int:
            return _shard_of(row[col] if col is not None else None, n_workers)

        return by_col

    def by_key(key: Pointer, row: tuple) -> int:
        return _shard_of(key, n_workers)

    return by_key


class ShardedScheduler:
    """The lockstep commit pump over N replicas of one graph.

    Worker 0's scope may carry extra trailing nodes (the sinks attach there only); the
    others must build the same operator sequence, or construction raises.
    ``optimize=True`` runs ``optimize_scopes`` over every scope, which rewrites them
    alike and returns the exchange edges to elide. ``probe=True`` keeps per-operator
    stats summed over the workers in ``self.stats`` (the monitor reads them from
    another thread, so inserts take ``_stats_lock``) and sets the
    ``pathway_queue_depth`` gauge on each sweep. A traced commit's spans carry the
    worker as ``shard``."""

    def __init__(self, scopes: Sequence[Scope], probe: bool = False, optimize: bool = True) -> None:
        self.scopes = list(scopes)
        self.n = len(self.scopes)
        for scope in self.scopes:
            # a replica's ``current`` holds a key shard: the state-peeking operators
            # read their own mirrors
            scope.sharded = True
        self.time = 0
        self.probe = probe
        self._stats_lock = threading.Lock()
        #: node index -> OperatorStats summed over the workers
        self.stats: dict[int, OperatorStats] = {}  # guarded-by: self._stats_lock
        if probe:
            self._queue_gauge = _metrics.REGISTRY.gauge(
                "pathway_queue_depth",
                "operators with pending delta batches (backpressure)",
            )
        sigs = [[type(node).__name__ for node in scope.nodes] for scope in self.scopes]
        for w, sig in enumerate(sigs[1:], start=1):
            if sigs[0][: len(sig)] != sig:
                raise ValueError(
                    f"worker {w} scope diverged: the graph logic must build "
                    "the identical operator sequence on every worker"
                )
        #: (producer, consumer, port) edges that provably move no rows
        self._elided: set = set()
        if optimize:
            from pathway_tpu_torch.optimize import optimize_scopes

            self._elided = optimize_scopes(self.scopes)
        #: (consumer index, port) -> its partition rule
        self._rules: dict[tuple[int, int], tuple] = {}

    @property
    def scope(self) -> Scope:
        """Worker 0's scope, the superset (the monitor reads it)."""
        return self.scopes[0]

    def _rule(self, consumer: Node, port: int) -> tuple:
        key = (consumer.index, port)
        rule = self._rules.get(key)
        if rule is None:
            rule = self._rules[key] = partition_rule(consumer, port)
        return rule

    def _columnar_shards(self, consumer: Node, port: int, out: DeltaBatch):
        return columnar_shards(self._rule(consumer, port), out.columns, self.n)

    def _deliver(self, worker: int, producer: Node, out: DeltaBatch) -> None:
        """Split ``out`` for each consumer and push each part to the consumer's replica
        on the worker that owns it. The consumers are read from worker 0's scope.

        The planes, in the order they are decided (each adds one to one plane's counter
        and to ``repartitions``): 1. an elided edge pushes the batch to ``worker``'s
        replica unrouted; 2. a pinned consumer takes the whole batch on worker 0; 3. a
        columnar batch may move through the device collective, whose decline falls
        through to 4. the host gather split; 5. a row batch splits by its entries."""
        elided = self._elided
        for consumer, port in self.scopes[0].nodes[producer.index].consumers:
            if (producer.index, consumer.index, port) in elided:
                if _verify_elision():
                    _assert_colocated(consumer, port, out, worker, self.n)
                EXCHANGE_STATS["elided"] += 1
                EXCHANGE_STATS["repartitions"] += 1
                self.scopes[worker].nodes[consumer.index].push(port, out)
                continue
            rule = self._rule(consumer, port)
            if rule[0] == "pin":
                EXCHANGE_STATS["host_deliveries"] += 1
                EXCHANGE_STATS["repartitions"] += 1
                self.scopes[0].nodes[consumer.index].push(port, out)
                continue
            if out._entries is None and out.columns is not None:
                shards = self._columnar_shards(consumer, port, out)
                if shards is not None:
                    cparts = _collective.exchange(
                        consumer.index, out.columns, shards, self.n, consumer=consumer
                    )
                    plane = "host_deliveries" if cparts is None else "collective_deliveries"
                    EXCHANGE_STATS[plane] += 1
                    EXCHANGE_STATS["repartitions"] += 1
                    for w in range(self.n):
                        if cparts is not None:
                            cols = cparts[w]
                            if cols is None:
                                continue
                        else:
                            idx = np.flatnonzero(shards == w)
                            if not len(idx):
                                continue
                            cols = out.columns.gather(idx)
                        part = DeltaBatch.from_columns(
                            cols,
                            consolidated=out._consolidated,
                            insert_only=out._insert_only,
                        )
                        part._raw_insert_only = out._raw_insert_only
                        self.scopes[w].nodes[consumer.index].push(port, part)
                    continue
            EXCHANGE_STATS["host_deliveries"] += 1
            EXCHANGE_STATS["repartitions"] += 1
            parts: list[list[Entry]] = [[] for _ in range(self.n)]
            for e, w in zip(out.entries, entry_shards(rule, out.entries, self.n)):
                parts[w].append(e)
            for w, entries in enumerate(parts):
                if entries:
                    batch = DeltaBatch(entries)
                    batch._consolidated = out._consolidated
                    self.scopes[w].nodes[consumer.index].push(port, batch)

    def _stats_of(self, node: Node) -> OperatorStats:
        st = self.stats.get(node.index)
        if st is None:
            with self._stats_lock:
                st = self.stats.setdefault(node.index, OperatorStats())
        return st

    def propagate(self, time: int) -> None:
        probe = self.probe
        trace = _tracing.current()
        timed = probe or trace is not None
        while True:
            busy_nodes = 0
            for w, scope in enumerate(self.scopes):
                for node in scope.nodes:
                    if not node.has_pending():
                        continue
                    busy_nodes += 1
                    if timed:
                        t0 = _walltime.perf_counter()
                    out = node.process(time)
                    if out is None:
                        out = DeltaBatch()
                    # deferred as the one-worker scheduler does: an eager apply would
                    # turn columnar batches into rows before the exchange routes them
                    node._defer_state(out)
                    if trace is not None:
                        trace.span(
                            getattr(node, "name", None) or type(node).__name__,
                            "sink" if isinstance(node, SubscribeNode) else "op",
                            t0,
                            _walltime.perf_counter(),
                            node=node.index,
                            shard=w,
                        )
                    if probe:
                        st = self._stats_of(node)
                        st.time_spent += _walltime.perf_counter() - t0
                        st.batches += 1
                        st.last_time = time
                        cols = out.columns
                        if cols is not None:
                            if cols.diffs is None:
                                st.insertions += cols.n
                            else:
                                pos = int((cols.diffs > 0).sum())
                                st.insertions += pos
                                st.deletions += cols.n - pos
                        else:
                            for _k, _r, d in out.consolidate():
                                if d > 0:
                                    st.insertions += 1
                                else:
                                    st.deletions += 1
                    if out:
                        self._deliver(w, node, out)
            if probe:
                self._queue_gauge.value = float(busy_nodes)
            if busy_nodes:
                continue
            flushed = False
            for scope in self.scopes:
                for node in scope.nodes:
                    if isinstance(node, ErrorLogNode):
                        batch = node.flush_buffer()
                        if batch:
                            node.push(0, batch)
                            flushed = True
            if not flushed:
                break
        for scope in self.scopes:
            for node in scope.nodes:
                node.on_time_end(time)
        device_pipeline.commit_boundary(time)

    def commit(self, statics: bool = True) -> int:
        """One commit over every worker: the static sources' rows (in the first commit,
        unless ``statics`` is False) and every input session's buffer, all read on
        worker 0 and routed from there."""
        for w, scope in enumerate(self.scopes):
            for node in scope.nodes:
                if isinstance(node, StaticSource):
                    # every replica holds the same static rows; worker 0 emits them and
                    # the exchange spreads them
                    batch = node.initial_batch() if (w == 0 and statics) else None
                    if w != 0 and statics:
                        node._emitted = True
                    if batch:
                        self._route_source(node, batch)
                elif isinstance(node, InputSession):
                    batch = node.flush()
                    if batch:
                        self._route_source(node, batch.consolidate())
        time = self.time
        self.propagate(time)
        self.time += 1
        return time

    def run_static(self) -> None:
        """Batch mode, as a stream with no connector: the static commit, then the end."""
        self.commit()
        self.finish()

    def _route_source(self, node: Node, batch: DeltaBatch) -> None:
        """A source's batch, read whole on worker 0, enters the exchange there. Its
        state keeps two rules: worker 0's replica holds the whole source state (so
        upserts and removals resolve against all of it and retract rows whose shard
        lives elsewhere), and a replica w > 0 holds its row-key shard (so a consumer
        that peeks at its input's state finds the rows whose parts it receives)."""
        if batch._entries is not None and len(batch) >= VECTOR_THRESHOLD:
            # a bulk commit enters the exchange as arrays, so the routes below run
            # the vectorized functions
            cbatch = columnarize_entries(batch.consolidate())
            if cbatch is not None:
                batch = cbatch
        replica0 = self.scopes[0].nodes[node.index]
        replica0._defer_state(batch)
        if self.n > 1:
            shards = None
            if batch._entries is None and batch.columns is not None:
                shards = columnar_shards(("key",), batch.columns, self.n)
            if shards is not None:
                for w in range(1, self.n):
                    idx = np.flatnonzero(shards == w)
                    if len(idx):
                        self.scopes[w].nodes[node.index]._defer_state(
                            DeltaBatch.from_columns(
                                batch.columns.gather(idx), consolidated=batch._consolidated
                            )
                        )
            else:
                parts: list[list[Entry]] = [[] for _ in range(self.n)]
                key_shards = shards_of_values([e[0] for e in batch.entries], self.n)
                for e, w in zip(batch.entries, key_shards):
                    parts[w].append(e)
                for w in range(1, self.n):
                    if parts[w]:
                        self.scopes[w].nodes[node.index]._defer_state(DeltaBatch(parts[w]))
        self._deliver(0, replica0, batch)

    def finish(self) -> None:
        """The last commit, the end hooks (their batches propagated as one more
        commit), the device pipeline's drain, and the sinks' teardown."""
        self.commit()
        for scope in self.scopes:
            for node in scope.nodes:
                node.on_end()
        if any(n.has_pending() for s in self.scopes for n in s.nodes):
            self.propagate(self.time)
            self.time += 1
        device_pipeline.drain()
        for scope in self.scopes:
            for node in scope.nodes:
                node.close()

    def merged_state(self, index: int) -> dict[Pointer, tuple]:
        """The union of one operator's state over the workers."""
        out: dict[Pointer, tuple] = {}
        for scope in self.scopes:
            out.update(scope.nodes[index].current)
        return out
