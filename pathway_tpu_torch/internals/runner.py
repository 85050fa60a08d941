"""GraphRunner: lowers the lazy Table graph onto the engine scope and runs it.

Counterpart of ``GraphRunner`` in ``pathway_tpu/internals/runner.py``: it builds the
specs that the sinks reach, flattens columns into engine tuple positions, compiles the
expression DSL to engine expressions, and runs the scheduler: one static commit when
no connector feeds the graph, else the streaming loop over the connectors. It lowers
static and connector-backed input tables, ``select`` (UDF columns included),
``filter``, ``groupby_reduce``, ``join_select``, ``concat``, ``update_rows``,
``update_cells``, ``reindex``, ``intersect``, ``subtract``, ``restrict``,
``override_universe``, ``flatten``, ``sort``, ``deduplicate``, ``ix``,
``remove_errors``, error logs and the as-of-now external index; any other table
operation raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import time as _time
from typing import TYPE_CHECKING, Any, Callable, Sequence

from pathway_tpu_torch.engine import expression as eex
from pathway_tpu_torch.engine.external_index import ExternalIndexNode
from pathway_tpu_torch.engine.graph import Node, Scheduler, Scope
from pathway_tpu_torch.engine.reducers import ReducerKind, make_reducer
from pathway_tpu_torch.engine.value import Pointer
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as pex
from pathway_tpu_torch.internals.desugaring import substitute
from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.internals.udfs.executors import make_kw_fn as _make_kw_fn
from pathway_tpu_torch.internals.udfs.executors import stop_event_loop
from pathway_tpu_torch.internals.universe import solver

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


def _pump_drivers(drivers: list, on_data: Callable[[], Any]) -> None:
    """The streaming poll loop: poll every connector driver, let rows gather in the
    input sessions, and call ``on_data()`` (which commits) when a driver's autocommit
    deadline expires or a driver finishes; back off exponentially when idle.

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


class GraphRunner:
    def __init__(self, scope: Scope | None = None) -> None:
        self.scope = scope if scope is not None else Scope()
        self.nodes: dict[int, Node] = {}
        self.drivers: list[Any] = []  # connector drivers (streaming mode)
        self._local_logs: dict[int, Node] = {}  # local error logs by id
        #: run the scheduler with per-operator probe stats (``pw.run`` sets it when
        #: process metrics are asked for)
        self.probe_stats = False
        self.scheduler: Scheduler | None = None

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
            node, driver = spec.params["attach"](scope)
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
                spec.params["factory"](),
                index_col=0,
                query_col=0,
                k=spec.params["k"],
                limit_col=limit_col,
            )

        raise NotImplementedError(
            f"table operation {kind!r} is not ported yet "
            "(ROADMAP queue 1 item 11: the other node types and table operations)"
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
        # each side's prep row: its columns, its id, then the join-key values
        left_prep = scope.expression_table(
            self.build(left),
            [eex.ColumnRef(i) for i in range(nl)]
            + [eex.KeyRef()]
            + [self.compile(le, llayout) for le, _re in on],
        )
        right_prep = scope.expression_table(
            self.build(right),
            [eex.ColumnRef(i) for i in range(nr)]
            + [eex.KeyRef()]
            + [self.compile(re_, rlayout) for _le, re_ in on],
        )
        id_spec = spec.params.get("id_spec")
        if id_spec is not None and id_spec[1] is not None:
            # name -> column index in the side's prep row
            side, name = id_spec
            id_spec = (side, (left if side == "left" else right)._column_names.index(name))
        joined = scope.join_tables(
            left_prep,
            right_prep,
            left_on=list(range(nl + 1, nl + 1 + k)),
            right_on=list(range(nr + 1, nr + 1 + k)),
            kind=spec.params["how"],
            id_spec=id_spec,
        )
        combined = Layout()
        for i, name in enumerate(left._column_names):
            combined.columns[(left._id, name)] = i
        combined.id_columns[left._id] = nl
        off = nl + 1 + k
        for i, name in enumerate(right._column_names):
            combined.columns[(right._id, name)] = off + i
        combined.id_columns[right._id] = off + nr
        return scope.expression_table(
            joined, [self.compile(e, combined) for e in exprs.values()]
        )

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

    def run(self) -> Scheduler:
        """Run to completion: with no connector, one static commit and the end;
        otherwise the static tables' rows as a first commit (time 0, empty when there
        is no static table), the streaming loop (poll
        the drivers, commit, until all of them report done), then the final commit and
        the sinks' end hooks. The scheduler stays on ``self.scheduler``, where its
        probe stats are read. The async UDFs' event-loop thread is stopped when the run
        ends or raises."""
        sched = Scheduler(self.scope, probe=self.probe_stats)
        self.scheduler = sched
        try:
            if not self.drivers:
                sched.run_static()
                return sched
            # the static tables' rows (if any) at time 0, so streamed commits count
            # from 1, as in the JAX engine
            sched.commit()
            _pump_drivers(self.drivers, sched.commit)
            sched.finish()
            return sched
        finally:
            stop_event_loop()

    def capture(self, *tables: "Table") -> list[dict[Pointer, tuple]]:
        """Run the graph that ``tables`` reach and return each one's final state."""
        nodes = [self.build(t) for t in tables]
        self.run()
        return [node.snapshot() for node in nodes]
