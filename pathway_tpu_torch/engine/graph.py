"""Engine graph: operator nodes, the Scope API that builds them, and the commit
scheduler.

Counterpart of ``pathway_tpu/engine/graph.py``, for the operators the streaming-RAG
pipeline runs: input sessions, per-row expressions, batched UDF application, key
filters (restrict), zips of same-universe tables, subscribe sinks, error logs and error
removal. Tables are keyed update streams processed per commit: every operator consumes
consolidated delta batches at time ``t`` and emits output deltas at ``t``; the device
work (UDF micro-batches, vector search) happens inside the operators. The scheduler
ends each commit in the device pipeline's commit boundary
(``engine.device_pipeline.commit_boundary``), which stages the commit's device batches
for completion on its own thread, or completes them inline under
``PATHWAY_TPU_ASYNC_DEVICE=0``. ``Scheduler(probe=True)`` keeps per-operator counts
and times (:class:`OperatorStats`).

Joins, groupby, sort, flatten, deduplicate, ix, update rows and cells, iterate and the
temporal operators are not ported yet (ROADMAP queue 1, "the other node types").
"""

from __future__ import annotations

import itertools
import time as _walltime
from typing import Any, Callable, Sequence

from pathway_tpu_torch.engine import device_pipeline
from pathway_tpu_torch.engine.batch import DeltaBatch, apply_batch_to_state
from pathway_tpu_torch.engine.expression import EngineExpression, EvalContext
from pathway_tpu_torch.engine.value import (
    ERROR,
    Pointer,
    hash_values,
    is_error,
    rows_differ,
)
from pathway_tpu_torch.internals import metrics as _metrics


class Node:
    """An operator in the engine graph."""

    def __init__(self, scope: "Scope", inputs: Sequence["Node"], arity: int) -> None:
        self.scope = scope
        self.inputs = list(inputs)
        self.arity = arity
        self.index = len(scope.nodes)
        scope.nodes.append(self)
        self.consumers: list[tuple[Node, int]] = []
        self.pending: dict[int, list[DeltaBatch]] = {}
        self._state: dict[Pointer, tuple] = {}
        self._state_lag: list[DeltaBatch] = []
        self._state_lag_rows = 0
        self.name: str = type(self).__name__
        self.trace: Any = None
        for port, inp in enumerate(self.inputs):
            inp.consumers.append((self, port))

    # A node's ``current`` (key -> row) is needed only when something reads it (a
    # retraction arriving here, a consumer that peeks at its input's state, a test):
    # output batches are kept and applied on first read. The rows cap bounds memory
    # for long streams whose state nobody reads.

    _STATE_LAG_MAX_ROWS = 1 << 21

    @property
    def current(self) -> dict[Pointer, tuple]:
        if self._state_lag:
            lag, self._state_lag = self._state_lag, []
            self._state_lag_rows = 0
            for batch in lag:
                apply_batch_to_state(self._state, batch.consolidate())
        return self._state

    @current.setter
    def current(self, value: dict[Pointer, tuple]) -> None:
        self._state = value
        self._state_lag = []
        self._state_lag_rows = 0

    def _defer_state(self, batch: DeltaBatch) -> None:
        """Queue an output batch for application to ``current`` on its next read."""
        if batch:
            self._state_lag.append(batch)
            self._state_lag_rows += len(batch)
            if self._state_lag_rows > self._STATE_LAG_MAX_ROWS:
                self.current  # noqa: B018 — drain via the property

    # -- scheduler interface ------------------------------------------------

    def has_pending(self) -> bool:
        return bool(self.pending)

    def take(self, port: int) -> DeltaBatch:
        return self.take_raw(port).consolidate()

    def take_raw(self, port: int) -> DeltaBatch:
        batches = self.pending.pop(port, None)
        if not batches:
            return DeltaBatch()
        if len(batches) == 1:
            return batches[0]
        merged = DeltaBatch()
        for b in batches:
            merged.extend(b)
        return merged

    def push(self, port: int, batch: DeltaBatch) -> None:
        if batch:
            self.pending.setdefault(port, []).append(batch)

    def process(self, time: int) -> DeltaBatch:
        raise NotImplementedError

    def on_time_end(self, time: int) -> None:
        pass

    def on_end(self) -> None:
        pass

    def close(self) -> None:
        """Final teardown, after the settlement commit that follows ``on_end``."""

    def report(self, key: Pointer | None, message: str) -> None:
        self.scope.report_error(self, key, message)


class InputSession(Node):
    """Mutable input: connectors push inserts, removes and upserts, then commit. In
    upsert mode an insert for an existing key retracts the previous row first."""

    def __init__(self, scope: "Scope", arity: int, upsert: bool = False):
        super().__init__(scope, [], arity)
        self.upsert = upsert
        self._buffer: list[tuple[Pointer, tuple | None, int]] = []
        self._has_rowless_removals = False

    def insert(self, key: Pointer, row: tuple) -> None:
        self._buffer.append((key, row, 1))

    def remove(self, key: Pointer, row: tuple | None = None) -> None:
        self._buffer.append((key, row, -1))
        if row is None:
            self._has_rowless_removals = True

    def flush(self) -> DeltaBatch | None:
        if not self._buffer:
            return None
        if not self.upsert and not self._has_rowless_removals:
            # plain inserts, or removals that carry their row: no overlay needed
            out = DeltaBatch(self._buffer)
            self._buffer = []
            return out
        state = self.current
        out = DeltaBatch()
        # overlay of keys touched this commit: key -> row | None (absent row)
        overlay: dict[Pointer, tuple | None] = {}

        def effective(key: Pointer) -> tuple | None:
            if key in overlay:
                return overlay[key]
            return state.get(key)

        if self.upsert:
            for key, row, diff in self._buffer:
                prev = effective(key)
                if diff > 0:
                    if prev is not None:
                        out.append(key, prev, -1)
                    out.append(key, row, 1)
                    overlay[key] = row
                elif prev is not None:
                    out.append(key, prev, -1)
                    overlay[key] = None
        else:
            for key, row, diff in self._buffer:
                if diff < 0 and row is None:
                    row = effective(key)
                    if row is None:
                        continue
                if diff > 0:
                    overlay[key] = row
                elif effective(key) == row:
                    overlay[key] = None
                out.append(key, row, diff)  # type: ignore[arg-type]
        self._buffer.clear()
        self._has_rowless_removals = False
        return out.consolidate()

    def process(self, time: int) -> DeltaBatch:
        return self.take_raw(0)  # pass-through: consumers consolidate


class ExpressionNode(Node):
    """Per-row expression evaluation (select). Deletions are retracted from
    ``current`` rather than evaluated again, which keeps nondeterministic outputs
    consistent between insert and delete."""

    def __init__(
        self,
        scope: "Scope",
        source: Node,
        expressions: Sequence[EngineExpression],
    ) -> None:
        super().__init__(scope, [source], len(expressions))
        self.expressions = list(expressions)

    def process(self, time: int) -> DeltaBatch:
        batch = self.take(0)
        out = DeltaBatch()
        ctx = EvalContext()
        if not batch._insert_only:
            state = self.current
            for key, _row, diff in batch:
                if diff < 0:
                    prev = state.get(key)
                    if prev is not None:
                        out.append(key, prev, diff)
        for key, row, diff in batch:
            if diff > 0:
                new_row = tuple(expr.evaluate(key, row, ctx) for expr in self.expressions)
                out.append(key, new_row, diff)
        for key, message in ctx.errors:
            self.report(key, message)
        return out


class BatchApplyNode(Node):
    """Batched UDF execution over the argument table (arity 1 output): all rows
    inserted in a commit go to ``rows_fn`` at once, and the executor decides how to
    run them (device micro-batches for the embedder). Deletions retract the kept
    value, so nondeterministic UDF outputs always cancel."""

    def __init__(
        self,
        scope: "Scope",
        source: Node,
        rows_fn: Callable[[list], list],
        arg_cols: Sequence[int],
        propagate_none: bool = False,
    ) -> None:
        super().__init__(scope, [source], 1)
        self.rows_fn = rows_fn
        self.arg_cols = list(arg_cols)
        self.propagate_none = propagate_none

    def process(self, time: int) -> DeltaBatch:
        batch = self.take(0)
        out = DeltaBatch()
        state = self.current
        for key, _row, diff in batch:
            if diff < 0:
                prev = state.get(key)
                if prev is not None:
                    out.append(key, prev, diff)
        pending: list[tuple[Pointer, tuple, int]] = []
        for key, row, diff in batch:
            if diff <= 0:
                continue
            args = tuple(row[c] for c in self.arg_cols)
            if any(is_error(a) for a in args):
                self.report(key, "error value in UDF argument")
                out.append(key, (ERROR,), diff)
                continue
            if self.propagate_none and any(a is None for a in args):
                out.append(key, (None,), diff)
                continue
            pending.append((key, args, diff))
        if pending:
            try:
                results = self.rows_fn([args for _k, args, _d in pending])
            except Exception as e:  # noqa: BLE001 — whole-batch failure
                results = [(False, e)] * len(pending)
            for (key, _args, diff), (ok, value) in zip(pending, results):
                if ok:
                    out.append(key, (value,), diff)
                else:
                    self.report(key, f"UDF error: {value!r}")
                    out.append(key, (ERROR,), diff)
        return out


class KeyFilterNode(Node):
    """intersect / subtract / restrict: keep the rows whose keys are (or are not) in
    other tables' key sets."""

    def __init__(
        self, scope: "Scope", source: Node, others: Sequence[Node], mode: str
    ) -> None:
        super().__init__(scope, [source, *others], source.arity)
        assert mode in ("intersect", "subtract", "restrict")
        self.mode = mode

    def _member_in(self, key: Pointer, other_states: list[dict]) -> bool:
        if self.mode == "subtract":
            return not any(key in s for s in other_states)
        return all(key in s for s in other_states)

    def process(self, time: int) -> DeltaBatch:
        source = self.inputs[0]
        src_batch = self.take(0)
        # membership deltas from the other sides
        affected: set[Pointer] = set()
        for port in range(1, len(self.inputs)):
            for key, _row, _diff in self.take(port):
                affected.add(key)
        out = DeltaBatch()
        handled: set[Pointer] = set()
        for key, _row, _diff in src_batch:
            handled.add(key)
        state = self.current
        others = [o.current for o in self.inputs[1:]]
        src_state = source.current if affected else None
        # keys whose membership may flip (and are not already being updated)
        for key in affected - handled:
            row = src_state.get(key)
            was = key in state
            now = row is not None and self._member_in(key, others)
            if was and not now:
                out.append(key, state[key], -1)
            elif not was and now and row is not None:
                out.append(key, row, 1)
        for key, row, diff in src_batch:
            if diff < 0:
                if key in state:
                    out.append(key, state[key], -1)
            elif self._member_in(key, others):
                out.append(key, row, 1)
        return out.consolidate()


class InputMirrors:
    """Input-state access for operators that peek at their inputs' state. A scope on
    one worker reads each input's complete ``current`` directly; the sharded scopes
    that need own mirrors are not ported yet."""

    def _input_state(self, port: int) -> dict:
        return self.inputs[port].current


class ZipNode(InputMirrors, Node):
    """Zip same-universe tables into one storage (column concatenation): a row is
    emitted once every input holds the key."""

    def __init__(self, scope: "Scope", sources: Sequence[Node]) -> None:
        super().__init__(scope, list(sources), sum(s.arity for s in sources))

    def _combined(self, key: Pointer) -> tuple | None:
        parts = []
        for port in range(len(self.inputs)):
            row = self._input_state(port).get(key)
            if row is None:
                return None
            parts.append(row)
        return tuple(v for part in parts for v in part)

    def process(self, time: int) -> DeltaBatch:
        affected: set[Pointer] = set()
        for port in range(len(self.inputs)):
            for key, _row, _diff in self.take(port):
                affected.add(key)
        out = DeltaBatch()
        state = self.current
        for key in affected:
            old = state.get(key)
            new = self._combined(key)
            if old is not None and rows_differ(old, new):
                out.append(key, old, -1)
            if new is not None and rows_differ(old, new):
                out.append(key, new, 1)
        return out


class SubscribeNode(Node):
    """Sink: per-row callbacks and time/end notifications (subscribe_table)."""

    def __init__(
        self,
        scope: "Scope",
        source: Node,
        on_change: Callable[[Pointer, tuple, int, int], None] | None = None,
        on_time_end: Callable[[int], None] | None = None,
        on_end: Callable[[], None] | None = None,
        skip_errors: bool = True,
    ) -> None:
        super().__init__(scope, [source], source.arity)
        self._on_change = on_change
        self._on_time_end = on_time_end
        self._on_end = on_end
        self.skip_errors = skip_errors

    def process(self, time: int) -> DeltaBatch:
        batch = self.take(0)
        for key, row, diff in batch:
            if self.skip_errors and any(is_error(v) for v in row):
                self.report(key, "error value in output row")
                continue
            if self._on_change is not None:
                self._on_change(key, row, time, diff)
        return batch

    def on_time_end(self, time: int) -> None:
        if self._on_time_end is not None:
            self._on_time_end(time)

    def close(self) -> None:
        # the user's on_end fires after the settlement commit, so rows injected by
        # upstream on_end hooks were already delivered through on_change
        if self._on_end is not None:
            self._on_end()


class ErrorLogNode(Node):
    """Error log as an engine table of ``(message,)`` rows."""

    def __init__(self, scope: "Scope") -> None:
        super().__init__(scope, [], 1)
        self._counter = itertools.count()
        self.buffered: list[tuple[Pointer, tuple, int]] = []

    def log(self, message: str) -> None:
        key = hash_values((next(self._counter), message), salt=b"errlog")
        self.buffered.append((key, (message,), 1))

    def flush_buffer(self) -> DeltaBatch | None:
        if not self.buffered:
            return None
        out = DeltaBatch(self.buffered)
        self.buffered = []
        return out

    def process(self, time: int) -> DeltaBatch:
        return self.take(0)


class _RemoveErrorsNode(Node):
    def __init__(self, scope: "Scope", source: Node) -> None:
        super().__init__(scope, [source], source.arity)

    def process(self, time: int) -> DeltaBatch:
        batch = self.take(0)
        out = DeltaBatch()
        state = self.current
        for key, row, diff in batch:
            if diff < 0:
                if key in state:
                    out.append(key, state[key], -1)
                continue
            if any(is_error(v) for v in row):
                continue
            out.append(key, row, diff)
        return out


class Scope:
    """Makes the engine graph's nodes and owns them; tables are node handles and
    columns tuple positions."""

    def __init__(self) -> None:
        self.nodes: list[Node] = []
        self.error_log_default = ErrorLogNode(self)
        self._error_log_stack: list[ErrorLogNode] = [self.error_log_default]

    # -- error plumbing -----------------------------------------------------

    def report_error(self, node: Node, key: Pointer | None, message: str) -> None:
        trace = f" at {node.trace}" if node.trace else ""
        # nodes built inside `with pw.local_error_log()` carry their own log
        log = getattr(node, "error_log", None) or self._error_log_stack[-1]
        log.log(f"{node.name}{trace}: {message}")

    def error_log(self) -> ErrorLogNode:
        return ErrorLogNode(self)

    # -- tables and operators -----------------------------------------------

    def input_session(self, arity: int, upsert: bool = False) -> InputSession:
        return InputSession(self, arity, upsert=upsert)

    def expression_table(
        self, table: Node, expressions: Sequence[EngineExpression]
    ) -> Node:
        return ExpressionNode(self, table, expressions)

    def zip_tables(self, tables: Sequence[Node]) -> Node:
        if len(tables) == 1:
            return tables[0]
        return ZipNode(self, tables)

    def batch_apply_table(
        self,
        table: Node,
        rows_fn: Callable[[list], list],
        arg_cols: Sequence[int],
        propagate_none: bool = False,
    ) -> Node:
        return BatchApplyNode(self, table, rows_fn, arg_cols, propagate_none)

    def intersect_tables(self, table: Node, others: Sequence[Node]) -> Node:
        return KeyFilterNode(self, table, others, "intersect")

    def subtract_table(self, table: Node, other: Node) -> Node:
        return KeyFilterNode(self, table, [other], "subtract")

    def restrict_table(self, table: Node, universe: Node) -> Node:
        return KeyFilterNode(self, table, [universe], "restrict")

    def subscribe_table(
        self,
        table: Node,
        on_change: Callable[[Pointer, tuple, int, int], None] | None = None,
        on_time_end: Callable[[int], None] | None = None,
        on_end: Callable[[], None] | None = None,
        skip_errors: bool = True,
    ) -> SubscribeNode:
        return SubscribeNode(
            self, table, on_change, on_time_end, on_end, skip_errors=skip_errors
        )

    def remove_errors_from_table(self, table: Node) -> Node:
        return _RemoveErrorsNode(self, table)


class OperatorStats:
    """Per-operator probe counters: rows inserted and deleted by the operator's
    output, its batches, the seconds inside ``process()`` and the last commit that
    touched it."""

    __slots__ = ("insertions", "deletions", "batches", "time_spent", "last_time")

    def __init__(self) -> None:
        self.insertions = 0
        self.deletions = 0
        self.batches = 0
        self.time_spent = 0.0  # seconds inside process()
        self.last_time: int | None = None

    def snapshot(self) -> dict:
        return {
            "insertions": self.insertions,
            "deletions": self.deletions,
            "batches": self.batches,
            "time_spent": self.time_spent,
            "last_time": self.last_time,
        }


class Scheduler:
    """Topological commit-batch pump. All deltas at one logical time are processed as
    a unit; ``propagate`` loops until quiescent, so same-time feedback (error logs)
    settles within the commit, and then hands the commit's device batches to the
    device pipeline.

    ``probe=True`` collects per-operator stats into ``self.stats`` (node index ->
    :class:`OperatorStats`) and sets the ``pathway_queue_depth`` gauge to the number of
    operators with pending batches on each sweep.
    """

    def __init__(self, scope: Scope, probe: bool = False) -> None:
        self.scope = scope
        self.time = 0
        self.probe = probe
        self.stats: dict[int, OperatorStats] = {}
        if probe:
            self._queue_gauge = _metrics.REGISTRY.gauge(
                "pathway_queue_depth",
                "operators with pending delta batches (backpressure)",
            )

    def _stats_of(self, node: Node) -> OperatorStats:
        st = self.stats.get(node.index)
        if st is None:
            st = self.stats[node.index] = OperatorStats()
        return st

    def propagate(self, time: int) -> None:
        scope = self.scope
        probe = self.probe
        while True:
            dirty = [n for n in scope.nodes if n.has_pending()]
            if probe:
                self._queue_gauge.value = float(len(dirty))
            if not dirty:
                # flush error-log buffers; may create new pending work
                flushed = False
                for node in scope.nodes:
                    if isinstance(node, ErrorLogNode):
                        batch = node.flush_buffer()
                        if batch:
                            node.push(0, batch)
                            flushed = True
                if not flushed:
                    break
                continue
            for node in scope.nodes:
                if not node.has_pending():
                    continue
                if probe:
                    t0 = _walltime.perf_counter()
                out = node.process(time)
                if out is None:
                    out = DeltaBatch()
                # consumers consolidate in take(); state applies lazily
                node._defer_state(out)
                if probe:
                    st = self._stats_of(node)
                    st.time_spent += _walltime.perf_counter() - t0
                    st.batches += 1
                    st.last_time = time
                    # consolidate for counting: a raw batch may carry net-zero churn
                    for _k, _r, d in out.consolidate():
                        if d > 0:
                            st.insertions += 1
                        else:
                            st.deletions += 1
                if out:
                    for consumer, port in node.consumers:
                        consumer.push(port, out)
        for node in scope.nodes:
            node.on_time_end(time)
        device_pipeline.commit_boundary(time)

    def _end_nodes(self) -> None:
        """Run the on_end hooks; they may inject final batches, propagated as one more
        commit; then tear the sinks down."""
        for node in self.scope.nodes:
            node.on_end()
        if any(n.has_pending() for n in self.scope.nodes):
            self.propagate(self.time)
            self.time += 1
        device_pipeline.drain()
        for node in self.scope.nodes:
            node.close()

    def commit(self) -> int:
        """Streaming mode: flush all input sessions as one commit."""
        for node in self.scope.nodes:
            if isinstance(node, InputSession):
                batch = node.flush()
                if batch:
                    node.push(0, batch)
        time = self.time
        self.propagate(time)
        self.time += 1
        return time

    def finish(self) -> None:
        self.commit()
        self._end_nodes()
