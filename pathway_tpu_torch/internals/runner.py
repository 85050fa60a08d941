"""GraphRunner: lowers the lazy Table graph onto the engine scope and runs it.

Counterpart of ``GraphRunner`` in ``pathway_tpu/internals/runner.py``: it builds the
specs that the sinks reach, flattens columns into engine tuple positions, compiles the
expression DSL to engine expressions, and runs the scheduler: one static commit when
no connector feeds the graph, else the streaming loop over the connectors. It lowers
static and connector-backed input tables, ``select`` (UDF columns included),
``filter``, ``groupby_reduce``, ``join_select``, ``concat``, ``update_rows``,
``update_cells``, ``reindex``, ``intersect``, ``subtract``, ``restrict``,
``override_universe``, ``flatten``, ``sort``, ``deduplicate``, ``ix``,
``remove_errors``, error logs, the as-of-now external index, the temporal operators
(``buffer``, ``forget``, ``freeze``, ``session_assign``, ``gradual_broadcast`` and the
``interval_join``, ``asof_join`` and ``asof_now_join`` specs) and ``pw.iterate``'s
``iterate_param``, ``iterate_result`` and ``table_transform``. The row transformers'
spec raises ``NotImplementedError`` naming its ROADMAP item (queue 1 item 8).
:class:`ShardedGraphRunner` runs workers in one process and
:class:`DistributedGraphRunner` in several, over the TCP mesh.
"""

from __future__ import annotations

import os
import time as _time
from typing import TYPE_CHECKING, Any, Callable, Sequence

from pathway_tpu_torch.engine import device_pipeline
from pathway_tpu_torch.engine import expression as eex
from pathway_tpu_torch.engine import temporal
from pathway_tpu_torch.engine.external_index import ExternalIndexNode
from pathway_tpu_torch.engine.graph import Node, Scheduler, Scope
from pathway_tpu_torch.engine.iterate import IterateNode
from pathway_tpu_torch.engine.persistence import (
    FileBackend,
    OperatorSnapshotManager,
    PersistentDriver,
)
from pathway_tpu_torch.engine.reducers import ReducerKind, make_reducer
from pathway_tpu_torch.engine.value import Pointer
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as pex
from pathway_tpu_torch.internals.desugaring import substitute
from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.internals import metrics as _metrics
from pathway_tpu_torch.internals import profiling as _profiling
from pathway_tpu_torch.internals import timeseries as _timeseries
from pathway_tpu_torch.internals import tracing as _tracing
from pathway_tpu_torch.internals.udfs.caches import set_udf_cache_root
from pathway_tpu_torch.internals.udfs.executors import make_kw_fn as _make_kw_fn
from pathway_tpu_torch.internals.udfs.executors import stop_event_loop
from pathway_tpu_torch.internals.universe import solver
from pathway_tpu_torch.persistence import PersistenceMode

if TYPE_CHECKING:
    from pathway_tpu_torch.internals.table import Table


class Layout:
    """Maps (table_id, column_name) -> tuple position in a storage node."""

    def __init__(self) -> None:
        self.columns: dict[tuple[int, str], int] = {}
        self.key_tables: set[int] = set()  # tables whose id == storage key
        self.id_columns: dict[int, int] = {}  # table_id -> position of its id col

    def position(self, ref: ColumnReference) -> int | None:
        if ref.name == "id":
            return self.id_columns.get(ref.table._id)
        return self.columns.get((ref.table._id, ref.name))


_CAST_NAMES = {
    dt.INT: "Int",
    dt.FLOAT: "Float",
    dt.BOOL: "Bool",
    dt.STR: "String",
}


#: ingest-to-sink latency, observed once per commit, weighted by the rows the commit
#: delivered to the subscribe sinks
_INGEST_LATENCY = _metrics.REGISTRY.histogram(
    "pathway_ingest_to_sink_latency_seconds",
    "end-to-end ingest->sink latency stamped per delta batch",
)
#: the series the sink nodes bump (engine/graph.py SubscribeNode)
_OUT_ROWS = _metrics.REGISTRY.counter("pathway_output_rows_total")


def _take_ingest_stamp(drivers: list) -> tuple[float | None, list[str]]:
    """Pop the oldest pending-row stamp across the connector drivers (``InputDriver.poll``
    sets it when rows enter a session); the commit that follows delivers those rows,
    closing the latency window. Also returns the names of the sources whose stamps were
    popped: the trace's ``ingest-wait`` span carries them."""
    best = None
    sources: list[str] = []
    for d in drivers:
        inner = getattr(d, "driver", d)
        stamp = getattr(inner, "first_pending_wall", None)
        if stamp is not None:
            inner.first_pending_wall = None
            name = getattr(inner, "source_name", None)
            if name:
                sources.append(str(name))
            if best is None or stamp < best:
                best = stamp
    return best, sources


def _observe_commit_latency(stamp: float | None, commit_started: float, rows_before: float) -> None:
    """Stamp the latency histogram with this commit's sink-row delta. Rows without an
    ingest stamp fall back to the commit's start, so the histogram's count always
    equals the rows the sinks produced."""
    rows = int(_OUT_ROWS.value - rows_before)
    if rows <= 0:
        return
    origin = stamp if stamp is not None else commit_started
    _INGEST_LATENCY.observe_n(max(0.0, _time.monotonic() - origin), rows)


def _pump_drivers(
    drivers: list, on_data: Callable[[], Any], on_idle: Callable[[], Any] | None = None
) -> None:
    """The streaming poll loop: poll every connector driver, let rows gather in the
    input sessions, and call ``on_data()`` (which commits) when a driver's autocommit
    deadline expires or a driver finishes; back off exponentially when idle, calling
    ``on_idle()`` after each idle sleep (the mesh coordinator's liveness checks, pings
    and rescale requests).

    The autocommit window (``autocommit_duration_ms`` on each connector) keeps
    commits coarse: committing on every poll turns a fast feed into thousands of tiny
    commits whose fixed cost (scheduler sweep, device dispatch, the commit boundary)
    dwarfs the rows' work. Data waits at most the window; a 0-window connector (the
    queries) pulls the commit forward at once."""
    live = list(drivers)
    idle_spins = 0
    pending = False  # rows sit in input sessions awaiting a commit
    deadline = 0.0
    while live:
        produced = False
        flush_now = False
        for d in list(live):
            status = d.poll()
            if status == "done":
                live.remove(d)
                produced = True
                flush_now = True  # stream end surfaces immediately
                # a driver's last poll can drain rows AND report the end in one
                # call: those rows are in the session now, so a commit must follow
                pending = True
            elif status == "data":
                produced = True
                ac_deadline = _time.monotonic() + d.effective_autocommit_s()
                deadline = min(deadline, ac_deadline) if pending else ac_deadline
                pending = True
        if pending and (flush_now or _time.monotonic() >= deadline):
            on_data()
            pending = False
            idle_spins = 0
            continue
        if produced:
            idle_spins = 0
            continue  # keep draining the feed until the window closes
        if pending:
            # nothing new this sweep: sleep out (a slice of) the window
            _time.sleep(min(max(deadline - _time.monotonic(), 0.0), 0.001))
            continue
        idle_spins += 1
        _time.sleep(min(0.001 * idle_spins, 0.05))
        if on_idle is not None:
            on_idle()


class GraphRunner:
    def __init__(
        self,
        scope: Scope | None = None,
        persistence_config: Any = None,
        attach_drivers: bool = True,
    ) -> None:
        self.scope = scope if scope is not None else Scope()
        #: False on the sharded runner's replicas w > 0: their connector tables build
        #: the input session only (worker 0 reads, and the exchange spreads the rows),
        #: and their as-of-now index operators no index
        self.attach_drivers = attach_drivers
        #: ``pw.persistence.Config`` or None; its backend's root also holds the UDFs'
        #: disk caches
        self.persistence = persistence_config
        if persistence_config is not None:
            self._wire_udf_cache(persistence_config)
        #: the run's OperatorSnapshotManager under operator persistence (its write and
        #: restore times and sizes), else None
        self.snapshot_manager: OperatorSnapshotManager | None = None
        self.nodes: dict[int, Node] = {}
        self.drivers: list[Any] = []  # connector drivers (streaming mode)
        self._local_logs: dict[int, Node] = {}  # local error logs by id
        #: run the scheduler with per-operator probe stats (``pw.run`` sets it when
        #: process metrics are asked for)
        self.probe_stats = False
        #: the run's ``StatsMonitor`` (``internals/monitoring.py``), or None; ``pw.run``
        #: sets it when a dashboard, the HTTP endpoint or the timeseries loop reads it
        self.monitor: Any = None
        #: the rows of ``pw.iterate``'s parameter tables, by slot, in an inner run
        self.iterate_params: list[list[tuple[Pointer, tuple]]] | None = None
        self.scheduler: Scheduler | None = None

    def _sync_monitor_connectors(self) -> None:
        """Copy each connector driver's counters onto the monitor's connector rows
        (a second driver with the same source name gets the suffix ``#1``, and so on,
        so their counters do not fight)."""
        if self.monitor is None:
            return
        seen: dict[str, int] = {}
        for d in self.drivers:
            inner = getattr(d, "driver", d)
            name = getattr(inner, "source_name", None)
            if name is None:
                continue
            n = seen.get(name, 0)
            seen[name] = n + 1
            if n:
                name = f"{name}#{n}"
            st = self.monitor.connector(name)
            st.entries = getattr(inner, "entries_total", 0)
            st.batches = getattr(inner, "batches_total", 0)
            wall = getattr(inner, "last_entry_wall", None)
            if wall is not None:
                st.last_entry_at = wall
            st.finished = getattr(inner, "done", False)

    def _on_monitor_commit(self, time: int, commit_started: float) -> None:
        if self.monitor is not None:
            self._sync_monitor_connectors()
            self.monitor.on_commit(time, commit_started)

    @staticmethod
    def _wire_udf_cache(config: Any) -> None:
        """Route the default ``DiskCache`` of UDFs under a filesystem backend's root
        (every persistence mode; ``UDF_CACHING`` does only this)."""
        backend = getattr(config, "backend", None)
        if isinstance(backend, FileBackend):
            set_udf_cache_root(os.path.join(backend.root, "udf-cache"))

    def _operator_snapshot_manager(self) -> OperatorSnapshotManager | None:
        if self.persistence is None or (
            getattr(self.persistence, "persistence_mode", None)
            != PersistenceMode.OPERATOR_PERSISTING
        ):
            return None
        return OperatorSnapshotManager(
            self.persistence.backend, getattr(self.persistence, "snapshot_interval_ms", 0)
        )

    # -- expression compilation --------------------------------------------

    def compile(self, expression: ColumnExpression, layout: Layout) -> eex.EngineExpression:
        override = getattr(expression, "_engine_override", None)
        if override is not None:
            return override  # a reducer's output position (groupby post-projection)
        c = lambda e: self.compile(e, layout)  # noqa: E731
        if isinstance(expression, ColumnReference):
            if expression.name == "id":
                pos = layout.id_columns.get(expression.table._id)
                if pos is not None:
                    return eex.ColumnRef(pos)
                if expression.table._id in layout.key_tables:
                    return eex.KeyRef()
                raise ValueError(
                    f"cannot reference {expression!r} in this context"
                )
            pos = layout.position(expression)
            if pos is None:
                raise ValueError(
                    f"column {expression!r} is not available in this context"
                )
            return eex.ColumnRef(pos)
        if isinstance(expression, pex.ColumnConstExpression):
            return eex.Const(expression._value)
        if isinstance(expression, pex.BinaryOpExpression):
            return eex.Binary(expression._op, c(expression._left), c(expression._right))
        if isinstance(expression, pex.UnaryOpExpression):
            return eex.Unary(expression._op, c(expression._arg))
        if isinstance(expression, pex.BooleanExpression):
            return eex.BooleanChain(expression._op, [c(a) for a in expression._args])
        if isinstance(expression, pex.IsNoneExpression):
            return eex.IsNone(c(expression._arg), expression._negated)
        if isinstance(expression, pex.IfElseExpression):
            return eex.IfElse(
                c(expression._cond), c(expression._then), c(expression._otherwise)
            )
        if isinstance(expression, pex.CoalesceExpression):
            return eex.Coalesce([c(a) for a in expression._args])
        if isinstance(expression, pex.RequireExpression):
            return eex.Require(c(expression._value), [c(d) for d in expression._deps])
        if isinstance(expression, pex.ApplyExpression):
            args = [c(a) for a in expression._args]
            kw_names = list(expression._kwargs.keys())
            args += [c(expression._kwargs[k]) for k in kw_names]
            fn = _make_kw_fn(expression._fn, len(expression._args), kw_names)
            return eex.Apply(
                fn,
                args,
                propagate_none=expression._propagate_none,
                deterministic=expression._deterministic,
            )
        if isinstance(expression, pex.CastExpression):
            target = _CAST_NAMES.get(expression._dtype.strip_optional())
            if target is None:
                return c(expression._arg)
            return eex.Cast(c(expression._arg), target)
        if isinstance(expression, pex.DeclareTypeExpression):
            return c(expression._arg)
        if isinstance(expression, pex.ConvertExpression):
            return eex.Convert(c(expression._arg), expression._target, expression._unwrap)
        if isinstance(expression, pex.UnwrapExpression):
            return eex.Unwrap(c(expression._arg))
        if isinstance(expression, pex.FillErrorExpression):
            return eex.FillError(c(expression._arg), c(expression._fallback))
        if isinstance(expression, pex.MakeTupleExpression):
            return eex.MakeTuple([c(a) for a in expression._args])
        if isinstance(expression, pex.GetExpression):
            return eex.SequenceGet(
                c(expression._arg),
                c(expression._index),
                c(expression._default) if expression._default is not None else None,
                expression._checked,
            )
        if isinstance(expression, pex.PointerExpression):
            return eex.PointerFrom(
                [c(a) for a in expression._args],
                c(expression._instance) if expression._instance is not None else None,
            )
        if isinstance(expression, pex.BatchApplyExpression):
            raise NotImplementedError(
                "async/batched UDF calls are only supported as top-level "
                "select columns"
            )
        if isinstance(expression, pex.ReducerExpression):
            raise ValueError("reducers are only allowed inside .reduce(...)")
        raise NotImplementedError(f"cannot compile expression {expression!r}")

    # -- storage ------------------------------------------------------------

    def storage_for(
        self, base: "Table", expressions: Sequence[ColumnExpression]
    ) -> tuple[Node, Layout]:
        """Build a storage node exposing ``base``'s columns plus any columns
        of other (universe-related) tables referenced by ``expressions``."""
        tables: dict[int, "Table"] = {base._id: base}
        for e in expressions:
            for ref in e._dependencies():
                t = ref.table
                if t._id not in tables:
                    if not solver.query_related(base._universe, t._universe):
                        raise ValueError(
                            f"column {ref!r} belongs to a table with an unrelated "
                            f"universe; join or use with_universe_of first"
                        )
                    tables[t._id] = t
        ordered = [base] + [t for tid, t in sorted(tables.items()) if tid != base._id]
        nodes = [self.build(t) for t in ordered]
        storage = self.scope.zip_tables(nodes)
        layout = Layout()
        offset = 0
        for t in ordered:
            for i, name in enumerate(t._column_names):
                layout.columns[(t._id, name)] = offset + i
            layout.key_tables.add(t._id)
            offset += len(t._column_names)
        return storage, layout

    def base_layout(self, table: "Table") -> Layout:
        layout = Layout()
        for i, name in enumerate(table._column_names):
            layout.columns[(table._id, name)] = i
        layout.key_tables.add(table._id)
        return layout

    # -- lowering -----------------------------------------------------------

    def _error_log_node(self, log_id):
        if log_id is None:
            return self.scope.error_log_default
        node = self._local_logs.get(log_id)
        if node is None:
            node = self._local_logs[log_id] = self.scope.error_log()
        return node

    def build(self, table: "Table") -> Node:
        if table._id in self.nodes:
            return self.nodes[table._id]
        node = self._build(table)
        log_id = getattr(table, "_error_log_id", None)
        if log_id is not None:
            node.error_log = self._error_log_node(log_id)
        node.name = f"{table._spec.kind}<{table._name}>"
        node.trace = table._trace
        self.nodes[table._id] = node
        return node

    def _project(self, node: Node, positions: Sequence[int]) -> Node:
        return self.scope.expression_table(node, [eex.ColumnRef(i) for i in positions])

    def _build(self, table: "Table") -> Node:
        spec = table._spec
        kind = spec.kind
        scope = self.scope

        if kind == "error_log":
            return self._error_log_node(spec.params.get("log_id"))

        if kind == "static":
            return scope.static_table(spec.params["rows"], len(table._column_names))

        if kind == "input":
            # connector-backed table: the io layer supplies an attach function
            node, driver = spec.params["attach"](scope, make_driver=self.attach_drivers)
            if not self.attach_drivers:
                return node
            sync_group = spec.params.get("sync_group")
            if sync_group is not None:
                # io/_synchronization.py: membership is per run
                sync_group.ensure_run(id(self))
                driver.sync_group = sync_group
                driver.sync_col = table._column_names.index(spec.params["sync_column"])
                sync_group.register(driver)
            persistent_id = spec.params.get("persistent_id")
            if (
                persistent_id is not None
                and self.persistence is not None
                and self.persistence.persistence_mode == PersistenceMode.PERSISTING
            ):
                driver = PersistentDriver(driver, self.persistence.backend, persistent_id)
            self.drivers.append(driver)
            return node

        if kind == "select":
            exprs = spec.params["exprs"]
            expr_list = list(exprs.values())
            storage, layout = self.storage_for(spec.inputs[0], expr_list)
            if not any(isinstance(e, pex.BatchApplyExpression) for e in expr_list):
                return scope.expression_table(
                    storage, [self.compile(e, layout) for e in expr_list]
                )
            return self._build_select_with_udfs(expr_list, storage, layout)

        if kind == "filter":
            base = spec.inputs[0]
            cond = spec.params["condition"]
            storage, layout = self.storage_for(base, [cond])
            n = len(base._column_names)
            pre = scope.expression_table(
                storage,
                [self.compile(ColumnReference(base, name), layout) for name in base._column_names]
                + [self.compile(cond, layout)],
            )
            return self._project(scope.filter_table(pre, n), range(n))

        if kind == "remove_errors":
            return scope.remove_errors_from_table(self.build(spec.inputs[0]))

        if kind == "groupby_reduce":
            return self._build_groupby(table)

        if kind == "join_select":
            return self._build_join(table)

        if kind == "concat":
            aligned = [self._aligned(t, table._column_names) for t in spec.inputs]
            return scope.concat_tables(aligned)

        if kind == "update_rows":
            orig, updates = spec.inputs
            return scope.update_rows_table(
                self.build(orig), self._aligned(updates, table._column_names)
            )

        if kind == "update_cells":
            orig, updates = spec.inputs
            update_cols = [
                updates._column_names.index(name) if name in updates._column_names else -1
                for name in table._column_names
            ]
            return scope.update_cells_table(self.build(orig), self.build(updates), update_cols)

        if kind == "reindex":
            base = spec.inputs[0]
            new_id = spec.params["new_id"]
            storage, layout = self.storage_for(base, [new_id])
            n = len(base._column_names)
            pre = scope.expression_table(
                storage,
                [self.compile(ColumnReference(base, name), layout) for name in base._column_names]
                + [self.compile(new_id, layout)],
            )
            return self._project(scope.reindex_table(pre, n), range(n))

        if kind == "intersect":
            base, *others = spec.inputs
            return scope.intersect_tables(self.build(base), [self.build(o) for o in others])

        if kind == "subtract":
            base, other = spec.inputs
            return scope.subtract_table(self.build(base), self.build(other))

        if kind == "restrict":
            base, other = spec.inputs
            return scope.restrict_table(self.build(base), self.build(other))

        if kind == "override_universe":
            base, other = spec.inputs
            return scope.override_table_universe(self.build(base), self.build(other))

        if kind == "flatten":
            base = spec.inputs[0]
            return scope.flatten_table(
                self.build(base),
                base._column_names.index(spec.params["column"]),
                with_origin=spec.params.get("origin_id") is not None,
            )

        if kind == "sort":
            base = spec.inputs[0]
            key_expr = spec.params["key"]
            inst_expr = spec.params["instance"]
            exprs = [key_expr] + ([inst_expr] if inst_expr is not None else [])
            storage, layout = self.storage_for(base, exprs)
            pre = scope.expression_table(storage, [self.compile(e, layout) for e in exprs])
            return scope.sort_table(pre, 0, 1 if inst_expr is not None else None)

        if kind == "deduplicate":
            # the base's columns, then the value and the instance expressions
            base = spec.inputs[0]
            value = spec.params["value"]
            instance = spec.params["instance"]
            storage, layout = self.storage_for(base, [value, *instance])
            n = len(base._column_names)
            pre_exprs = [
                self.compile(ColumnReference(base, name), layout) for name in base._column_names
            ]
            pre_exprs += [self.compile(e, layout) for e in (value, *instance)]
            dedup = scope.deduplicate(
                scope.expression_table(storage, pre_exprs),
                value_col=n,
                instance_cols=list(range(n + 1, n + 1 + len(instance))),
                acceptor=spec.params["acceptor"],
            )
            return self._project(dedup, range(n))

        if kind == "ix":
            keys_table, source = spec.inputs
            return scope.ix_table(
                self.build(keys_table),
                self.build(source),
                keys_table._column_names.index("_pw_ix_key"),
                optional=spec.params.get("optional", False),
            )

        if kind == "external_index":
            data_t, query_t = spec.inputs
            data_node = self.build(data_t)
            query_node = self.build(query_t)
            data_prep = scope.expression_table(
                data_node,
                [self.compile(spec.params["index_expr"], self.base_layout(data_t))],
            )
            query_layout = self.base_layout(query_t)
            q_exprs = [self.compile(spec.params["query_expr"], query_layout)]
            limit_col = None
            if spec.params["limit_expr"] is not None:
                q_exprs.append(self.compile(spec.params["limit_expr"], query_layout))
                limit_col = 1
            query_prep = scope.expression_table(query_node, q_exprs)
            return ExternalIndexNode(
                scope,
                data_prep,
                query_prep,
                # the node is pinned to worker 0 (engine/sharded.py::partition_rule): a
                # replica w > 0 builds no index, which may hold device memory
                spec.params["factory"]() if self.attach_drivers else None,
                index_col=0,
                query_col=0,
                k=spec.params["k"],
                limit_col=limit_col,
            )

        if kind in ("buffer", "forget", "freeze"):
            cls = {
                "buffer": temporal.BufferNode,
                "forget": temporal.ForgetNode,
                "freeze": temporal.FreezeNode,
            }[kind]
            return cls(
                scope,
                self.build(spec.inputs[0]),
                spec.params["threshold_col"],
                spec.params["time_col"],
            )

        if kind == "gradual_broadcast":
            # the threshold table is the (lower, value, upper) select of
            # Table._gradual_broadcast
            base, triplet = spec.inputs
            return temporal.GradualBroadcastNode(scope, self.build(base), self.build(triplet))

        if kind == "session_assign":
            return temporal.SessionAssignNode(
                scope,
                self.build(spec.inputs[0]),
                spec.params["time_col"],
                spec.params["instance_col"],
                spec.params["max_gap"],
            )

        if kind in ("interval_join", "asof_join", "asof_now_join"):
            return self._build_temporal_join(table)

        if kind == "iterate_param":
            if self.iterate_params is None:
                raise ValueError("iterate parameter table used outside pw.iterate")
            return scope.static_table(
                self.iterate_params[spec.params["slot"]], len(table._column_names)
            )

        if kind == "table_transform":
            fn = spec.params["fn"]
            return IterateNode(
                scope,
                [self.build(spec.inputs[0])],
                len(table._column_names),
                lambda states, _fn=fn: _fn(states[0]),
            )

        if kind == "iterate_result":
            engine = spec.params["engine"]
            name = spec.params["name"]
            return IterateNode(
                scope,
                [self.build(t) for t in spec.inputs],
                len(table._column_names),
                lambda states, _engine=engine, _name=name: _engine.compute_all(states)[_name],
            )

        raise NotImplementedError(
            f"table operation {kind!r} is not ported yet "
            "(ROADMAP queue 1 item 8: the rest of the package)"
        )

    def _aligned(self, t: "Table", names: Sequence[str]) -> Node:
        """``t``'s columns in the order of ``names`` (concat and update_rows take
        same-named columns in any order)."""
        layout = self.base_layout(t)
        return self.scope.expression_table(
            self.build(t), [self.compile(ColumnReference(t, name), layout) for name in names]
        )

    def _build_groupby(self, table: "Table") -> Node:
        spec = table._spec
        base = spec.inputs[0]
        by_refs: list[ColumnReference] = spec.params["by"]
        exprs: dict[str, ColumnExpression] = spec.params["exprs"]
        scope = self.scope

        # the distinct reducer nodes over all output expressions
        reducer_nodes: list[pex.ReducerExpression] = []

        def collect(e: ColumnExpression) -> None:
            if isinstance(e, pex.ReducerExpression):
                if not any(e is r for r in reducer_nodes):
                    reducer_nodes.append(e)
                return
            for child in e._children():
                collect(child)

        for e in exprs.values():
            collect(e)

        arg_exprs = [a for r in reducer_nodes for a in r._args]
        storage, layout = self.storage_for(base, [*by_refs, *arg_exprs])
        pre_exprs: list[eex.EngineExpression] = [self.compile(b, layout) for b in by_refs]
        nb = len(by_refs)
        reducer_descr = []
        pos = nb
        for r in reducer_nodes:
            arg_cols = list(range(pos, pos + len(r._args)))
            pre_exprs.extend(self.compile(a, layout) for a in r._args)
            pos += len(r._args)
            if r._kind in (ReducerKind.ARG_MIN, ReducerKind.ARG_MAX):
                # (value, row id) pairs
                pre_exprs.append(eex.KeyRef())
                arg_cols = [arg_cols[0], pos]
                pos += 1
            reducer_descr.append((make_reducer(r._kind, **r._options), arg_cols))

        grouped = scope.group_by_table(
            scope.expression_table(storage, pre_exprs),
            by_cols=list(range(nb)),
            reducers=reducer_descr,
            set_id=spec.params["set_id"],
            instance_last=spec.params.get("instance_last", False),
        )

        # post-projection: reducer nodes -> group-row positions, by refs too
        post_layout = Layout()
        post_layout.columns.update({(b.table._id, b.name): i for i, b in enumerate(by_refs)})

        def replace(e: ColumnExpression) -> ColumnExpression | None:
            for i, r in enumerate(reducer_nodes):
                if e is r:
                    marker = pex.ColumnConstExpression(None)
                    marker._engine_override = eex.ColumnRef(nb + i)  # type: ignore[attr-defined]
                    return marker
            return None

        return scope.expression_table(
            grouped,
            [self.compile(substitute(e, replace), post_layout) for e in exprs.values()],
        )

    def _build_join(self, table: "Table") -> Node:
        spec = table._spec
        left, right = spec.inputs
        on = spec.params["on"]
        exprs: dict[str, ColumnExpression] = spec.params["exprs"]
        scope = self.scope
        llayout = self.base_layout(left)
        rlayout = self.base_layout(right)
        nl = len(left._column_names)
        nr = len(right._column_names)
        k = len(on)
        # each side's prep row: its columns, its id where the output reads it, then the
        # join-key values (an id column is a column of Pointer objects, which keeps the
        # prep off the columnar evaluator)
        ids_read = {
            ref.table._id for e in exprs.values() for ref in e._dependencies() if ref.name == "id"
        }
        lid = [eex.KeyRef()] if left._id in ids_read else []
        rid = [eex.KeyRef()] if right._id in ids_read else []
        left_prep = scope.expression_table(
            self.build(left),
            [eex.ColumnRef(i) for i in range(nl)]
            + lid
            + [self.compile(le, llayout) for le, _re in on],
        )
        right_prep = scope.expression_table(
            self.build(right),
            [eex.ColumnRef(i) for i in range(nr)]
            + rid
            + [self.compile(re_, rlayout) for _le, re_ in on],
        )
        id_spec = spec.params.get("id_spec")
        if id_spec is not None and id_spec[1] is not None:
            # name -> column index in the side's prep row
            side, name = id_spec
            id_spec = (side, (left if side == "left" else right)._column_names.index(name))
        nli, nri = nl + len(lid), nr + len(rid)
        joined = scope.join_tables(
            left_prep,
            right_prep,
            left_on=list(range(nli, nli + k)),
            right_on=list(range(nri, nri + k)),
            kind=spec.params["how"],
            id_spec=id_spec,
        )
        combined = Layout()
        for i, name in enumerate(left._column_names):
            combined.columns[(left._id, name)] = i
        if lid:
            combined.id_columns[left._id] = nl
        off = nli + k
        for i, name in enumerate(right._column_names):
            combined.columns[(right._id, name)] = off + i
        if rid:
            combined.id_columns[right._id] = off + nr
        return scope.expression_table(
            joined, [self.compile(e, combined) for e in exprs.values()]
        )

    def _build_temporal_join(self, table: "Table") -> Node:
        """The interval, asof and asof-now joins. Each side's prep row is its columns,
        its id, its time (interval and asof) and its equality values; several equalities
        of an interval or asof join fold into one tuple-valued instance column."""
        spec = table._spec
        kind = spec.kind
        left, right = spec.inputs
        on = spec.params["on"]
        how = spec.params["how"]
        exprs: dict[str, ColumnExpression] = spec.params["exprs"]
        scope = self.scope
        nl = len(left._column_names)
        nr = len(right._column_names)
        k = len(on)
        has_time = kind in ("interval_join", "asof_join")
        fold = has_time and k > 1

        def prep(base: "Table", side: int, time_expr: Any) -> Node:
            layout = self.base_layout(base)
            n = len(base._column_names)
            extras: list[eex.EngineExpression] = [eex.KeyRef()]
            if time_expr is not None:
                extras.append(self.compile(time_expr, layout))
            # the side by index: a self-join has the same table on both sides
            compiled = [self.compile(pair[side], layout) for pair in on]
            if fold:
                extras.append(eex.MakeTuple(compiled))
            else:
                extras.extend(compiled)
            return scope.expression_table(
                self.build(base), [eex.ColumnRef(i) for i in range(n)] + extras
            )

        left_prep = prep(left, 0, spec.params.get("left_time") if has_time else None)
        right_prep = prep(right, 1, spec.params.get("right_time") if has_time else None)
        t_off = 1 if has_time else 0
        k_extras = 1 if fold else k
        l_inst = list(range(nl + 1 + t_off, nl + 1 + t_off + k_extras))
        r_inst = list(range(nr + 1 + t_off, nr + 1 + t_off + k_extras))
        if kind == "interval_join":
            node = temporal.IntervalJoinNode(
                scope, left_prep, right_prep,
                left_time_col=nl + 1, right_time_col=nr + 1,
                lower_bound=spec.params["lower_bound"], upper_bound=spec.params["upper_bound"],
                left_instance_col=l_inst[0] if k else None,
                right_instance_col=r_inst[0] if k else None,
                kind=how,
            )
        elif kind == "asof_join":
            node = temporal.AsofJoinNode(
                scope, left_prep, right_prep,
                left_time_col=nl + 1, right_time_col=nr + 1,
                left_instance_col=l_inst[0] if k else None,
                right_instance_col=r_inst[0] if k else None,
                direction=spec.params["direction"],
                kind=how,
            )
        else:
            node = temporal.AsofNowJoinNode(scope, left_prep, right_prep, l_inst, r_inst, kind=how)
        combined = Layout()
        for i, name in enumerate(left._column_names):
            combined.columns[(left._id, name)] = i
        combined.id_columns[left._id] = nl
        off = nl + 1 + t_off + k_extras
        for i, name in enumerate(right._column_names):
            combined.columns[(right._id, name)] = off + i
        combined.id_columns[right._id] = off + nr
        return scope.expression_table(node, [self.compile(e, combined) for e in exprs.values()])

    def _build_select_with_udfs(
        self,
        expr_list: list[ColumnExpression],
        storage: Node,
        layout: Layout,
    ) -> Node:
        """Select with UDF (BatchApply) columns: plain columns evaluate in one
        expression node; each UDF column becomes a BatchApplyNode over the
        same prep node; results zip back together in output order.

        UDF calls nested inside other expressions are rejected — the engine
        batches them per commit, so they must be whole select columns
        (matching the reference's async_apply_table contract,
        src/engine/dataflow.rs:1757)."""
        scope = self.scope

        def check_no_nested(e: ColumnExpression) -> None:
            for child in e._children():
                if isinstance(child, pex.BatchApplyExpression):
                    raise NotImplementedError(
                        "async/batched UDF calls must be top-level select "
                        "columns, not nested inside other expressions"
                    )
                check_no_nested(child)

        pre_exprs: list[eex.EngineExpression] = []
        plan: list[tuple[str, Any]] = []
        for e in expr_list:
            check_no_nested(e)
            if isinstance(e, pex.BatchApplyExpression):
                arg_positions = []
                for a in (*e._args, *e._kwargs.values()):
                    pre_exprs.append(self.compile(a, layout))
                    arg_positions.append(len(pre_exprs) - 1)
                plan.append(("batch", (e, arg_positions)))
            else:
                pre_exprs.append(self.compile(e, layout))
                plan.append(("plain", len(pre_exprs) - 1))
        pre = scope.expression_table(storage, pre_exprs)
        parts: list[Node] = [pre]
        col_map: list[int] = []
        offset = len(pre_exprs)
        for tag, payload in plan:
            if tag == "plain":
                col_map.append(payload)
            else:
                e, arg_positions = payload
                node = scope.batch_apply_table(
                    pre, e._rows_fn, arg_positions, e._propagate_none
                )
                node.name = f"udf<{e._name}>"
                parts.append(node)
                col_map.append(offset)
                offset += 1
        zipped = scope.zip_tables(parts)
        return self._project(zipped, col_map)

    # -- execution ----------------------------------------------------------

    def attach_sinks(self) -> None:
        """Build and attach every registered sink (the ``pw.run`` path)."""
        from pathway_tpu_torch.internals import parse_graph

        for sink in parse_graph.G.sinks:
            driver = sink.attach(self.scope, self.build(sink.table))
            if driver is not None:
                self.drivers.append(driver)

    def _wants_probe(self) -> bool:
        monitor = self.monitor
        return self.probe_stats or (
            monitor is not None and getattr(monitor, "wants_operator_stats", True)
        )

    def _make_scheduler(self) -> Any:
        return Scheduler(self.scope, probe=self._wants_probe())

    @property
    def _snapshot_target(self) -> Any:
        """The scope whose state the operator snapshots keep (the sharded runner: its
        replicas)."""
        return self.scope

    def run(self) -> Any:
        """Run to completion: with no connector, one static commit and the end;
        otherwise the static tables' rows as a first commit (time 0, empty when there
        is no static table), the streaming loop (poll the drivers, commit, until all of
        them report done), then the final commit and the sinks' end hooks. The
        scheduler stays on ``self.scheduler``, where its probe stats are read. The async
        UDFs' event-loop thread is stopped when the run ends or raises.

        Under persistence, the journals replay first, as a commit of their own; or the
        operator snapshot is restored and the clock resumes after its commit time. A
        commit's journal segments and snapshot are cut only once the device pipeline
        has completed that commit (``drain_until``), and the run ends with a last
        journal flush and a snapshot.

        Each streamed commit is offered to the tracer (``TRACER.begin`` / ``end``, its
        time zero the connectors' oldest pending row), stamps the ingest-to-sink
        latency histogram with the rows it delivered and records a ``commit`` flight
        event; the traces are exported when the stream ends.

        With a monitor (``self.monitor``), the scheduler probes every operator when
        the monitor wants operator stats, and the static commit and each streamed
        commit update the monitor's connector rows and commit count."""
        monitor = self.monitor
        sched = self._make_scheduler()
        self.scheduler = sched
        target = self._snapshot_target
        if monitor is not None:
            monitor.scheduler = sched
        try:
            if not self.drivers:
                t0 = _time.monotonic()
                sched.run_static()
                self._on_monitor_commit(0, t0)
                return sched
            persistent = [d for d in self.drivers if isinstance(d, PersistentDriver)]
            for driver in persistent:
                driver.replay()
            if persistent:
                # the replayed events as a commit of their own, so the state downstream
                # is rebuilt even if no new input arrives
                sched.commit(statics=False)
            self.snapshot_manager = snapshot_mgr = self._operator_snapshot_manager()
            if snapshot_mgr is not None:
                restored_time = snapshot_mgr.restore(target, self.drivers)
                if restored_time is not None:
                    # sink times stay monotonic across the restart
                    sched.time = max(sched.time, restored_time + 1)
            # the static tables' rows (if any), so streamed commits count from 1 on a
            # fresh start, as in the JAX engine
            sched.commit()

            def on_data() -> None:
                commit_started = _time.monotonic()
                stamp, sources = _take_ingest_stamp(self.drivers)
                rows_before = _OUT_ROWS.value
                ctx = _tracing.TRACER.begin(sched.time, origin_mono=stamp, sources=sources)
                time = sched.commit()
                _observe_commit_latency(stamp, commit_started, rows_before)
                _metrics.FLIGHT.record("commit", time=time)
                if ctx is not None:
                    _tracing.TRACER.end(time)
                if persistent or snapshot_mgr is not None:
                    # exactly once: the checkpoint of commit N waits for N's staged
                    # device work
                    device_pipeline.drain_until(time)
                for driver in persistent:
                    driver.on_commit(time)
                if snapshot_mgr is not None:
                    snapshot_mgr.on_commit(target, self.drivers, time)
                self._on_monitor_commit(time, commit_started)

            _pump_drivers(self.drivers, on_data)
            sched.finish()
            _tracing.TRACER.export()
            for driver in persistent:
                driver.on_commit(sched.time)
            if snapshot_mgr is not None:
                snapshot_mgr.snapshot(target, self.drivers, sched.time)
            return sched
        finally:
            stop_event_loop()

    def capture(self, *tables: "Table") -> list[dict[Pointer, tuple]]:
        """Run the graph that ``tables`` reach and return each one's final state."""
        nodes = [self.build(t) for t in tables]
        for node in nodes:
            # capture reads node state with no SubscribeNode: the graph optimizer must
            # treat these as observed (no fusion into a placeholder, no narrowing)
            node._pw_observed = True
        self.run()
        return [node.snapshot() for node in nodes]


class ShardedGraphRunner(GraphRunner):
    """N logical workers in one process, each with a replica of the graph; batches move
    between the replicas by co-location key (``engine/sharded.py``).

    The connectors poll on worker 0, whose rows the exchange spreads; the sinks attach
    on worker 0 only, after every shared node. :meth:`GraphRunner.run` drives it over
    the sharded scheduler, with worker 0's drivers, and the operator snapshots keep
    one state per worker; the free tier's worker cap is checked first."""

    def __init__(self, n_workers: int, persistence_config: Any = None) -> None:
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        from pathway_tpu_torch.internals.license import check_worker_count

        check_worker_count(n_workers)
        self.workers = [
            GraphRunner(persistence_config=persistence_config, attach_drivers=(i == 0))
            for i in range(n_workers)
        ]
        self.n = n_workers
        super().__init__(self.workers[0].scope, persistence_config)
        # the inputs read on worker 0
        self.drivers = self.workers[0].drivers

    def build(self, table: "Table") -> list[Node]:
        return [w.build(table) for w in self.workers]

    def _make_scheduler(self) -> Any:
        from pathway_tpu_torch.engine.sharded import ShardedScheduler

        return ShardedScheduler([w.scope for w in self.workers], probe=self._wants_probe())

    @property
    def _snapshot_target(self) -> Any:
        return [w.scope for w in self.workers]

    def capture(self, *tables: "Table") -> list[dict[Pointer, tuple]]:
        """Run the graph that ``tables`` reach and return each one's final state,
        merged over the workers."""
        replicas = [self.build(t) for t in tables]
        for reps in replicas:
            for node in reps:
                # read with no SubscribeNode: the optimizer leaves them intact
                node._pw_observed = True
        sched = self.run()
        return [sched.merged_state(reps[0].index) for reps in replicas]

    def attach_sinks(self) -> None:
        _attach_sinks_on_primary(self.workers)


def _attach_sinks_on_primary(workers: list, attach: bool = True) -> int:
    """Build every registered sink's table on every worker (so the replicas stay
    aligned by node index), then attach the sinks on worker 0's scope, whose sink nodes
    come after every shared node: nodes past the shared graph exist on worker 0 only.
    ``attach=False`` (a follower process of a mesh) builds the tables and attaches
    nothing. Returns the shared graph's length."""
    from pathway_tpu_torch.internals import parse_graph

    sinks = list(parse_graph.G.sinks)
    nodes = [workers[0].build(s.table) for s in sinks]
    for w in workers[1:]:
        for s in sinks:
            w.build(s.table)
    n_shared = len(workers[0].scope.nodes)
    if attach:
        for sink, node in zip(sinks, nodes):
            driver = sink.attach(workers[0].scope, node)
            if driver is not None:
                workers[0].drivers.append(driver)
    return n_shared


class DistributedGraphRunner:
    """Workers in several processes: the same program runs in ``processes``
    processes, which exchange key-sharded batches over the TCP mesh
    (``engine/distributed.py``); counterpart of ``DistributedGraphRunner`` in
    ``pathway_tpu/internals/runner.py``.

    Every process holds ``threads`` local replicas of the graph; total workers =
    threads x processes. Process 0 is the coordinator: the connector drivers poll
    there, the input journal and the sinks live there, and it broadcasts the commit
    and finish commands. Every process keeps the persistence config and, under
    ``OPERATOR_PERSISTING``, its own snapshot manager
    (``operator-snapshot-p<id>``, a ring of 3 commits), so the mesh can roll back to
    a commit all of them hold. A follower's replicas build no connector driver and no
    external index (the index operator is pinned to worker 0 of process 0).

    Under ``PATHWAY_TPU_RECOVER=1`` with operator snapshots, a lost follower is
    restarted by the supervisor and the mesh rolls back to its snapshot; a lost
    leader is replaced through an election among the survivors. Otherwise a lost peer
    fail-stops the run. ``PATHWAY_TPU_RESHARD=<old count>`` makes the process a
    one-shot helper that re-shards a quiesced mesh's snapshots for ``processes``
    processes and exits (``MeshSupervisor.rescale``)."""

    def __init__(
        self,
        threads: int,
        processes: int,
        process_id: int,
        first_port: int = 10000,
        persistence_config: Any = None,
    ) -> None:
        if processes < 2:
            raise ValueError("DistributedGraphRunner needs processes >= 2")
        if not 0 <= process_id < processes:
            raise ValueError(
                f"PATHWAY_PROCESS_ID={process_id} out of range for {processes} processes"
            )
        from pathway_tpu_torch.internals.license import check_worker_count

        check_worker_count(threads * processes)
        self.threads = threads
        self.processes = processes
        self.process_id = process_id
        self.first_port = first_port
        self.persistence = persistence_config
        primary = process_id == 0
        self.workers = [
            GraphRunner(
                persistence_config=persistence_config if primary else None,
                attach_drivers=primary and i == 0,
            )
            for i in range(threads)
        ]
        self.monitor: Any = None
        self.probe_stats = False
        self.scheduler: Any = None
        self._epoch = 0

    def build(self, table: "Table") -> list[Node]:
        return [w.build(table) for w in self.workers]

    def attach_sinks(self) -> None:
        """Build every sink's table on every local replica (the node indices agree
        across processes); attach the sinks on process 0 only."""
        self.n_shared = _attach_sinks_on_primary(self.workers, attach=self.process_id == 0)

    def run(self) -> Any:
        from pathway_tpu_torch.engine.distributed import DistributedScheduler, MeshTransport

        if os.environ.get("PATHWAY_TPU_RESHARD"):
            return self._reshard_snapshots(int(os.environ["PATHWAY_TPU_RESHARD"]))
        transport = MeshTransport(self.process_id, self.processes, self.first_port)
        try:
            sched = DistributedScheduler(
                [w.scope for w in self.workers],
                self.process_id,
                self.processes,
                transport,
                n_shared=getattr(self, "n_shared", len(self.workers[0].scope.nodes)),
                # followers always probe: the snapshots they piggyback carry per-operator
                # series for the leader's /metrics
                probe=(
                    self.monitor is not None
                    and getattr(self.monitor, "wants_operator_stats", True)
                )
                or self.probe_stats
                or self.process_id != 0,
            )
            self.scheduler = sched
            if self.monitor is not None:
                self.monitor.scheduler = sched
                # the leader's endpoint renders the followers' snapshots as they arrive
                self.monitor.mesh_snapshots = sched.mesh_metrics
            if self.process_id == 0:
                sched.announce_topology()
                self._coordinate(sched, transport)
            else:
                sched.receive_topology()
                self._follow(sched, transport)
            return sched
        finally:
            transport.close()
            stop_event_loop()

    # -- rescale -------------------------------------------------------------

    def _reshard_snapshots(self, old_processes: int) -> None:
        """Re-shard the mesh's per-process operator snapshots from ``old_processes``
        to ``self.processes`` processes, in a helper process between the quiesced old
        mesh and the relaunched new one. The graph is built (the program ran up to
        ``pw.run``), and the optimizer plan the mesh applies is applied here too, so
        the node classes match the snapshots' signatures. Prints the report as a
        ``PATHWAY_RESHARD_JSON`` line for the supervisor."""
        import json as _json

        from pathway_tpu_torch.engine.persistence import reshard_process_snapshots
        from pathway_tpu_torch.optimize import optimize_scopes

        if self.persistence is None:
            raise RuntimeError(
                "PATHWAY_TPU_RESHARD requires persistence "
                "(PersistenceMode.OPERATOR_PERSISTING)"
            )
        scopes = [w.scope for w in self.workers]
        n_shared = getattr(self, "n_shared", len(scopes[0].nodes))
        protected = set()
        for node in scopes[0].nodes[:n_shared]:
            for consumer, _port in node.consumers:
                if consumer.index >= n_shared:
                    protected.add(node.index)
        optimize_scopes(scopes, n_shared=n_shared, protected=protected)
        report = reshard_process_snapshots(
            self.persistence.backend,
            old_processes,
            self.processes,
            self.threads,
            scopes,
            n_shared=n_shared,
        )
        _metrics.FLIGHT.record("reshard", **report)
        print("PATHWAY_RESHARD_JSON " + _json.dumps(report), flush=True)
        return None

    # -- fault tolerance ----------------------------------------------------

    def _note_epoch(self) -> None:
        _metrics.REGISTRY.gauge(
            "pathway_mesh_epoch",
            "current mesh recovery epoch (bumped by every recovery or "
            "leader election; frames from older epochs are fenced)",
        ).set(self._epoch)

    def _report_rescale_metrics(self) -> None:
        """A leader relaunched by ``MeshSupervisor.rescale`` carries the supervisor's
        rescale stamps in its environment: report them on this process's registry, so
        the leader's ``/metrics`` shows the rescale history."""
        try:
            rescales = int(os.environ.get("PATHWAY_TPU_RESCALED", "0"))
        except ValueError:
            rescales = 0
        if rescales <= 0:
            return
        _metrics.REGISTRY.counter(
            "pathway_mesh_rescales_total",
            "completed N->M mesh rescales (quiesce + re-shard + relaunch)",
        ).inc(rescales)
        try:
            wall = float(os.environ.get("PATHWAY_TPU_RESCALE_WALL_S", ""))
        except ValueError:
            wall = None
        if wall is not None:
            _metrics.REGISTRY.histogram(
                "pathway_mesh_rescale_seconds",
                "wall time of the most recent rescale, quiesce request to relaunch",
                buckets=(0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0),
            ).observe(wall)

    def _snapshot_manager(self) -> OperatorSnapshotManager | None:
        """This process's operator snapshot manager, or None without
        ``OPERATOR_PERSISTING``: each process snapshots its own replicas under a name
        of its own and keeps a ring of 3 commits."""
        if self.persistence is None or (
            getattr(self.persistence, "persistence_mode", None)
            != PersistenceMode.OPERATOR_PERSISTING
        ):
            return None
        return OperatorSnapshotManager(
            self.persistence.backend,
            getattr(self.persistence, "snapshot_interval_ms", 0),
            name=f"operator-snapshot-p{self.process_id}",
            retain=3,
        )

    @staticmethod
    def _recovery_enabled(snapshot_mgr: Any) -> bool:
        """Recovery needs both ``PATHWAY_TPU_RECOVER`` and operator snapshots;
        everything else fail-stops."""
        return snapshot_mgr is not None and os.environ.get(
            "PATHWAY_TPU_RECOVER", ""
        ).lower() in ("1", "true", "yes")

    @staticmethod
    def _recover_deadline() -> float:
        try:
            return max(1.0, float(os.environ.get("PATHWAY_TPU_RECOVER_DEADLINE", "60")))
        except ValueError:
            return 60.0

    @staticmethod
    def _fault_plan() -> Any:
        if not os.environ.get("PATHWAY_TPU_FAULT_PLAN"):
            return None
        from pathway_tpu_torch.engine.faults import active_plan

        return active_plan()

    @staticmethod
    def _request_kill(peer: int) -> None:
        """Ask the MeshSupervisor (if one launched this mesh) to SIGKILL a peer
        suspected hung, so its death and restart take over; without a supervisor the
        caller fail-stops at the re-establish deadline."""
        sup_dir = os.environ.get("PATHWAY_TPU_SUPERVISOR_DIR")
        if not sup_dir:
            return
        try:
            with open(os.path.join(sup_dir, f"kill-{peer}"), "w") as fh:
                fh.write(str(os.getpid()))
        except OSError:
            pass

    @staticmethod
    def _rewind_sinks(to_time: int) -> None:
        """Truncate the file sinks past the rollback point, so the commits driven
        again land once. Callback sinks (``pw.io.subscribe``) cannot rewind: they see
        the commits driven again at least once."""
        from pathway_tpu_torch.engine.connectors import FILE_WRITERS

        for writer in list(FILE_WRITERS):
            writer.rewind_to(to_time)

    def _recover_mesh(
        self, sched: Any, transport: Any, snapshot_mgr: Any, dead_peer: int, drivers: list
    ) -> None:
        """The leader's recovery: park the survivors, have the dead worker restarted
        (by the supervisor), re-mesh, run the handshake again, roll every process back
        to the restarted worker's snapshot and resync the links."""
        t0 = _time.monotonic()
        self._epoch += 1
        epoch = self._epoch
        self._note_epoch()
        _metrics.FLIGHT.record("peer_dead", peer=dead_peer, time=sched.time, epoch=epoch)
        _metrics.FLIGHT.dump(f"peer {dead_peer} lost (leader view)")
        # after the dump, which names the trace in flight; the dead incarnation's
        # snapshot and spans leave the aggregated /metrics
        _tracing.TRACER.drop()
        sched.mesh_metrics.pop(dead_peer, None)
        sched.trace_peer_spans.pop(dead_peer, None)
        _profiling.PROFILER.prune(dead=(dead_peer,))
        _timeseries.STORE.prune_workers(dead={str(dead_peer)})
        _metrics.FLIGHT.record("recovery_start", peer=dead_peer, epoch=epoch)
        deadline = self._recover_deadline()
        for peer in sorted(sched._outbox):
            if peer == dead_peer or peer in transport.dead_peers:
                continue
            transport.send(peer, ("cmd", "recover", dead_peer, epoch))
        # a hung (not dead) worker must die before its restart can bind the port
        self._request_kill(dead_peer)
        detect_s = _time.monotonic() - t0
        transport.reestablish(dead_peer, deadline=deadline)
        sched.reannounce_to(dead_peer)
        frame = transport.recv(dead_peer, timeout=deadline)
        if not (isinstance(frame, tuple) and frame and frame[0] == "rejoin"):
            raise RuntimeError(
                f"process 0: expected the restarted worker {dead_peer}'s rejoin frame, "
                f"got {frame!r}"
            )
        rejoin_time = int(frame[1])
        if rejoin_time < 0:
            raise RuntimeError(
                f"process 0: restarted worker {dead_peer} has no operator snapshot to "
                "resume from (it died before its first commit boundary); cold-starting "
                "one worker of a warm mesh would diverge state — fail-stop"
            )
        transport.broadcast(("cmd", "rollback", rejoin_time, epoch))
        sched.rollback(rejoin_time, snapshot_mgr, drivers)
        self._rewind_sinks(rejoin_time)
        sched.resync(epoch)
        _metrics.REGISTRY.counter(
            "pathway_mesh_recoveries_total",
            "mesh-wide recoveries completed after a worker loss",
        ).inc(1)
        _metrics.FLIGHT.record(
            "recovery_done",
            peer=dead_peer,
            epoch=epoch,
            to_time=rejoin_time,
            detect_s=round(detect_s, 6),
            wall_s=round(_time.monotonic() - t0, 6),
        )
        _metrics.FLIGHT.dump(f"peer {dead_peer} recovered (leader view)")

    # -- the two run loops --------------------------------------------------

    def _coordinate(self, sched: Any, transport: Any) -> None:
        from pathway_tpu_torch.engine.distributed import RECV_TIMEOUT, PeerLostError

        w0 = self.workers[0]
        drivers = list(w0.drivers)
        persistent = [d for d in drivers if isinstance(d, PersistentDriver)]
        for d in persistent:
            d.replay()
        snapshot_mgr = self._snapshot_manager()
        recovery = self._recovery_enabled(snapshot_mgr)
        fault_plan = self._fault_plan()
        self._report_rescale_metrics()
        common = -1
        if snapshot_mgr is not None:
            # the startup rejoin: every follower's latest snapshot time, the whole mesh
            # rolled back to the oldest, then a barrier (a cold start takes the same
            # path with -1). The rejoin frames carry each survivor's epoch: a leader
            # restarted after a failover resumes above them, or the survivors' fences
            # would reject its rollback as a zombie's.
            times = [snapshot_mgr.latest_time()]
            peer_epochs = [0]
            for peer in sorted(sched._outbox):
                frame = transport.recv(peer)
                if not (isinstance(frame, tuple) and frame and frame[0] == "rejoin"):
                    raise RuntimeError(
                        f"process 0: expected peer {peer}'s rejoin frame, got {frame!r}"
                    )
                times.append(frame[1])
                peer_epochs.append(int(frame[2]) if len(frame) >= 3 else 0)
            common = min((t if t is not None else -1) for t in times)
            self._epoch = max([self._epoch] + peer_epochs) + 1
            self._note_epoch()
            transport.broadcast(("cmd", "rollback", common, self._epoch))
            sched.fence.admit("rollback", self._epoch)
            sched.rollback(common, snapshot_mgr, drivers)
            # the resumed sink files may hold commits newer than the last common
            # snapshot (a cold restart lost them)
            self._rewind_sinks(common)
            sched.resync(self._epoch)
        quiesce_path = None
        sup_dir = os.environ.get("PATHWAY_TPU_SUPERVISOR_DIR")
        if sup_dir and snapshot_mgr is not None:
            quiesce_path = os.path.join(sup_dir, "quiesce")

        def maybe_quiesce(committed_time: int | None) -> None:
            """A rescale request from the supervisor: stop at a commit boundary, take
            a snapshot of it on every process and exit with the quiesce code."""
            if quiesce_path is None or not os.path.exists(quiesce_path):
                return
            from pathway_tpu_torch.engine.supervisor import EXIT_QUIESCED

            try:
                if committed_time is None:
                    # an idle stream: every polled row is committed, so the state is
                    # the last commit's (an empty commit here would shift the later
                    # commit times off the uninterrupted run's)
                    committed_time = sched.time - 1
                transport.broadcast(("cmd", "quiesce", committed_time))
            except PeerLostError:
                # a peer died mid-quiesce: recovery runs, and the marker stays for
                # the next boundary
                return
            snapshot_mgr.snapshot(sched.scopes, drivers, committed_time)
            _metrics.FLIGHT.record("quiesce", time=committed_time, process=self.process_id)
            _metrics.FLIGHT.dump("quiesced for rescale")
            raise SystemExit(EXIT_QUIESCED)

        if common < 0:
            # a fresh start: the barrier commit (static sources) is time 0. A mesh
            # resumed from a common snapshot skips it, or every later commit time
            # would shift off the uninterrupted run's.
            transport.broadcast(("cmd", "commit"))
            barrier_time = sched.commit_local()
            if snapshot_mgr is not None:
                # followers snapshot every commit, this one too; so does the leader,
                # or a worker lost before the first data commit would roll back to a
                # boundary the leader cannot restore
                device_pipeline.drain_until(barrier_time)
                snapshot_mgr.on_commit(sched.scopes, drivers, barrier_time)
        last_sign_of_life = _time.monotonic()

        def on_data() -> None:
            nonlocal last_sign_of_life
            started = _time.monotonic()
            try:
                transport.raise_if_peer_dead()
                stamp, sources = _take_ingest_stamp(drivers)
                rows_before = _OUT_ROWS.value
                # begun before the broadcast: the context rides the first round's
                # frames, so the followers adopt it at the commit's start
                ctx = _tracing.TRACER.begin(sched.time, origin_mono=stamp, sources=sources)
                transport.broadcast(("cmd", "commit"))
                time = sched.commit_local()
            except PeerLostError as exc:
                if not recovery or exc.peer is None or exc.peer == 0:
                    raise
                self._recover_mesh(sched, transport, snapshot_mgr, exc.peer, drivers)
                return  # the rolled-back commit is driven again at the next poll
            if ctx is not None:
                _tracing.TRACER.end(time, peer_spans=dict(sched.trace_peer_spans))
                sched.trace_peer_spans.clear()
            _observe_commit_latency(stamp, started, rows_before)
            if persistent or snapshot_mgr is not None:
                # exactly once: the checkpoint of commit N waits for N's device work
                device_pipeline.drain_until(time)
            for d in persistent:
                d.on_commit(time)
            if snapshot_mgr is not None:
                snapshot_mgr.on_commit(sched.scopes, drivers, time)
            if fault_plan is not None:
                fault_plan.on_commit(self.process_id, time)
            if self.monitor is not None:
                w0.monitor = self.monitor
                w0._sync_monitor_connectors()
                self.monitor.on_commit(time, started)
            last_sign_of_life = started
            maybe_quiesce(time)

        # pings must come well inside the followers' receive timeout
        ping_every = min(30.0, RECV_TIMEOUT / 2.0)

        def on_idle() -> None:
            nonlocal last_sign_of_life
            try:
                transport.raise_if_peer_dead()
            except PeerLostError as exc:
                if not recovery or exc.peer is None or exc.peer == 0:
                    raise
                self._recover_mesh(sched, transport, snapshot_mgr, exc.peer, drivers)
                last_sign_of_life = _time.monotonic()
                return
            maybe_quiesce(None)
            if _time.monotonic() - last_sign_of_life > ping_every:
                transport.broadcast(("cmd", "ping"))
                last_sign_of_life = _time.monotonic()

        _pump_drivers(drivers, on_data, on_idle)
        transport.broadcast(("cmd", "finish"))
        sched.finish_local()
        _tracing.TRACER.export()  # the leader holds the assembled mesh traces
        for d in persistent:
            d.on_commit(sched.time)
        if snapshot_mgr is not None:
            snapshot_mgr.snapshot(sched.scopes, drivers, sched.time)

    def _follow(self, sched: Any, transport: Any) -> None:
        from pathway_tpu_torch.engine.distributed import PeerLostError

        snapshot_mgr = self._snapshot_manager()
        recovery = self._recovery_enabled(snapshot_mgr)
        fault_plan = self._fault_plan()
        deadline = self._recover_deadline()
        if snapshot_mgr is not None:
            latest = snapshot_mgr.latest_time()
            transport.send(0, ("rejoin", latest if latest is not None else -1, self._epoch))
        while True:
            try:
                frame = transport.recv(0)
            except PeerLostError:
                # the leader died or hung: dump forensics and, with recovery on, elect
                # an interim leader and rejoin the restarted one
                self._leader_failover(sched, transport, snapshot_mgr)
                continue
            kind = frame[0]
            if kind != "cmd":
                raise RuntimeError(
                    f"process {self.process_id}: expected a coordinator command, got "
                    f"{kind!r}"
                )
            cmd = frame[1]
            if cmd == "ping":
                # answered, so the leader's suspicion clock sees an idle live follower
                transport.heartbeat(0)
                continue
            if cmd == "commit":
                try:
                    time = sched.commit_local()
                except PeerLostError as exc:
                    if exc.peer == 0 or 0 in transport.dead_peers:
                        self._leader_failover(sched, transport, snapshot_mgr)
                        continue
                    if not recovery or exc.peer is None:
                        raise
                    try:
                        self._park_for_recovery(sched, transport, exc.peer)
                    except PeerLostError as parked:
                        # the leader died while this survivor waited for its command
                        if parked.peer == 0 or 0 in transport.dead_peers:
                            self._leader_failover(sched, transport, snapshot_mgr)
                        else:
                            raise
                    continue
                if snapshot_mgr is not None:
                    # exactly once: this worker's snapshot of commit N waits for N's
                    # device work
                    device_pipeline.drain_until(time)
                    snapshot_mgr.on_commit(sched.scopes, [], time)
                if fault_plan is not None:
                    fault_plan.on_commit(self.process_id, time)
            elif cmd == "recover":
                # a peer died and this follower was idle (a parked one consumed the
                # command already); the fence makes duplicates no-ops
                if not sched.fence.admit("recover", frame[3]):
                    continue
                dead = frame[2]
                _metrics.FLIGHT.record("peer_dead", peer=dead, time=sched.time, epoch=frame[3])
                _metrics.FLIGHT.dump(f"peer {dead} lost (survivor view)")
                transport.reestablish(dead, deadline=deadline)
                _metrics.FLIGHT.record("recovery_remesh", peer=dead, epoch=frame[3])
            elif cmd == "rollback":
                # a rollback run twice would deadlock in resync: a zombie's or a
                # duplicated command is fenced
                if not sched.fence.admit("rollback", frame[3]):
                    continue
                self._epoch = max(self._epoch, int(frame[3]))
                self._note_epoch()
                sched.rollback(frame[2], snapshot_mgr, [])
                sched.resync(frame[3])
            elif cmd == "quiesce":
                from pathway_tpu_torch.engine.supervisor import EXIT_QUIESCED

                if snapshot_mgr is not None:
                    snapshot_mgr.snapshot(sched.scopes, [], frame[2])
                _metrics.FLIGHT.record("quiesce", time=frame[2], process=self.process_id)
                _metrics.FLIGHT.dump("quiesced for rescale")
                raise SystemExit(EXIT_QUIESCED)
            elif cmd == "finish":
                sched.finish_local()
                if snapshot_mgr is not None:
                    snapshot_mgr.snapshot(sched.scopes, [], sched.time)
                return
            else:
                raise RuntimeError(f"unknown coordinator command {cmd!r}")

    def _leader_failover(self, sched: Any, transport: Any, snapshot_mgr: Any) -> None:
        """A follower's response to losing the leader (process 0).

        Every survivor dumps its flight ring first. With recovery off, that is all:
        fail-stop, and the supervisor reports ``EXIT_LEADER_LOST``. With recovery on,
        the survivors elect the lowest live rank as interim leader
        (:func:`elect_leader`, epoch-stamped); it asks the supervisor to kill the old
        leader (a hung one must die before its successor can bind the port) and
        gathers the survivors' metrics snapshots. Everyone then re-meshes toward the
        restarted process 0, runs the topology handshake again and sends an
        epoch-stamped rejoin; the restarted leader rolls the mesh back to the last
        common commit above the survivors' epoch, so a frame a zombie ex-leader
        flushes is fenced. A survivor lost during the window fail-stops at the
        election deadline."""
        from pathway_tpu_torch.engine.distributed import PeerLostError, elect_leader

        recovery = self._recovery_enabled(snapshot_mgr)
        last_seen = getattr(transport, "last_seen", {}).get(0)
        _metrics.FLIGHT.record(
            "leader_dead",
            process=self.process_id,
            time=sched.time,
            epoch=self._epoch,
            recovery=recovery,
            detect_s=None if last_seen is None else round(_time.monotonic() - last_seen, 6),
        )
        _metrics.FLIGHT.dump("leader (process 0) lost")
        _tracing.TRACER.drop()  # after the dump, which names the trace
        if not recovery:
            raise PeerLostError(
                f"process {self.process_id}: leader (process 0) lost and recovery is "
                "disabled — fail-stop (flight ring dumped)",
                peer=0,
            )
        t0 = _time.monotonic()
        deadline = self._recover_deadline()
        end = t0 + deadline
        survivors = sorted(
            p for p in range(self.processes) if p != 0 and p not in transport.dead_peers
        )
        epoch = self._epoch + 1
        interim = elect_leader(survivors)
        others = [p for p in survivors if p != self.process_id]
        latest = snapshot_mgr.latest_time()
        latest = -1 if latest is None else latest
        if self.process_id == interim:
            # the interim leader aggregates /metrics from a clean slate
            sched.prune_mesh_metrics(dead=(0,))
            for peer in others:
                transport.send(peer, ("elect", epoch, interim))
            rejoin_times = [latest]
            for peer in others:
                # the survivor's ack, past any round or abort debris on the link
                while True:
                    remaining = max(0.1, end - _time.monotonic())
                    frame = transport.recv(peer, timeout=remaining)
                    if (
                        isinstance(frame, tuple)
                        and len(frame) >= 4
                        and frame[0] == "elect-ack"
                        and frame[1] == epoch
                    ):
                        break
                rejoin_times.append(frame[2])
                if frame[3] is not None:
                    peer_profile = frame[3].pop("__profile__", None)
                    if peer_profile is not None:
                        _profiling.PROFILER.absorb(peer, peer_profile)
                    sched.mesh_metrics[peer] = frame[3]
            self._request_kill(0)
            _metrics.REGISTRY.counter(
                "pathway_mesh_elections_total",
                "leader elections completed after losing process 0",
            ).inc(1)
            _metrics.REGISTRY.histogram(
                "pathway_mesh_election_seconds",
                "leader-loss detection to election-complete wall time",
                buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0),
            ).observe(_time.monotonic() - t0)
            _metrics.FLIGHT.record(
                "election_done",
                interim=interim,
                epoch=epoch,
                survivors=survivors,
                rollback_target=min(rejoin_times),
                wall_s=round(_time.monotonic() - t0, 6),
            )
        else:
            while True:
                remaining = end - _time.monotonic()
                if remaining <= 0:
                    raise PeerLostError(
                        f"process {self.process_id}: no election from interim leader "
                        f"{interim} within {deadline:g}s of losing the leader — "
                        "fail-stop",
                        peer=interim,
                    )
                try:
                    frame = transport.recv(interim, timeout=min(remaining, 1.0))
                except PeerLostError:
                    if interim in transport.dead_peers:
                        raise  # the interim died too
                    continue  # a poll timeout: wait on
                if (
                    isinstance(frame, tuple)
                    and len(frame) >= 3
                    and frame[0] == "elect"
                    and frame[1] > self._epoch
                ):
                    epoch = int(frame[1])
                    break
            transport.send(interim, ("elect-ack", epoch, latest, sched._metrics_snapshot()))
        self._epoch = epoch
        self._note_epoch()
        sched.fence.admit("elect", epoch)
        # re-mesh toward the restarted process 0 and run the startup handshake again;
        # the follow loop takes the rollback from there
        transport.reestablish(0, deadline=max(1.0, end - _time.monotonic()))
        sched.receive_topology()
        transport.send(0, ("rejoin", latest, self._epoch))
        _metrics.FLIGHT.record(
            "leader_failover_done",
            process=self.process_id,
            epoch=self._epoch,
            wall_s=round(_time.monotonic() - t0, 6),
        )
        _metrics.FLIGHT.dump("leader failover complete")

    def _park_for_recovery(self, sched: Any, transport: Any, dead_peer: int) -> None:
        """A survivor whose peer died mid-commit: dump forensics, then wait on the
        leader's link (with backoff, within the deadline) for its recover command and
        re-mesh toward the restarted worker; the follow loop takes the rollback."""
        import random as _random

        from pathway_tpu_torch.engine.distributed import PeerLostError

        _metrics.FLIGHT.record("peer_dead", peer=dead_peer, time=sched.time)
        _metrics.FLIGHT.dump(f"peer {dead_peer} lost (survivor view)")
        _tracing.TRACER.drop()  # after the dump, which names the trace
        _metrics.FLIGHT.record("recovery_parked", peer=dead_peer)
        deadline = self._recover_deadline()
        end = _time.monotonic() + deadline
        wait = 0.05
        frame = sched._pending_recover
        sched._pending_recover = None
        while True:
            if frame is not None:
                if (
                    isinstance(frame, tuple)
                    and len(frame) >= 4
                    and frame[0] == "cmd"
                    and frame[1] == "recover"
                ):
                    # a recover of an epoch already handled is fenced; a fresh one
                    # advances the fence, so the idle path does not run it again
                    if sched.fence.admit("recover", frame[3]):
                        break
                    frame = None
                    continue
                frame = None  # commit or round debris of the aborted exchange
            remaining = end - _time.monotonic()
            if remaining <= 0:
                raise PeerLostError(
                    f"process {self.process_id}: no recovery command within "
                    f"{deadline:g}s of losing peer {dead_peer} — fail-stop",
                    peer=dead_peer,
                )
            try:
                frame = transport.recv(0, timeout=min(remaining, wait))
            except PeerLostError:
                if 0 in transport.dead_peers:
                    raise  # the leader itself is gone
                frame = None  # a poll timeout: wait on
            wait = min(wait * 2, 1.0) * (0.75 + 0.5 * _random.random())
        transport.reestablish(frame[2], deadline=deadline)
        _metrics.FLIGHT.record("recovery_remesh", peer=frame[2], epoch=frame[3])
