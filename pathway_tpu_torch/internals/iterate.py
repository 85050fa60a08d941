"""``pw.iterate``: fixed-point iteration over the Table API.

Counterpart of ``pathway_tpu/internals/iterate.py``. The body is called once with
parameter tables, which captures its graph. Each run of the fixed point binds the
parameters to the current state, runs the captured graph statically in a scope of its
own, feeds the results back and repeats until they stop changing or
``iteration_limit`` rounds have run (``engine/iterate.py::IterateNode`` drives it).

The tables the body reads that depend on no parameter (``edges`` in PageRank, or any
table a connector feeds) are computed once by the outer graph: they are inputs of the
iteration's node, and each round binds their current state. The JAX package rebuilds
them inside every round instead, where a connector's table is empty.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

from pathway_tpu_torch.engine.graph import Scheduler
from pathway_tpu_torch.internals.expression import ColumnExpression
from pathway_tpu_torch.internals.runner import GraphRunner
from pathway_tpu_torch.internals.table import Table, TableSpec


def _spec_tables(table: Table) -> list[Table]:
    """The tables ``table``'s operator reads: its inputs and the tables its
    expressions refer to."""
    spec = table._spec
    out = list(spec.inputs)
    if spec.kind == "static":
        return out

    def walk(v: Any) -> None:
        if isinstance(v, ColumnExpression):
            out.extend(ref.table for ref in v._dependencies())
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)

    walk(spec.params)
    return out


def _captured_tables(results: Iterable[Table], params: Iterable[Table]) -> list[Table]:
    """The largest tables the results read that depend on no parameter, in the order
    first met."""
    param_ids = {t._id for t in params}
    depends: dict[int, bool] = {}

    def depends_on_param(t: Table) -> bool:
        got = depends.get(t._id)
        if got is None:
            depends[t._id] = False  # a cycle cannot reach a parameter through itself
            got = t._id in param_ids or any(map(depends_on_param, _spec_tables(t)))
            depends[t._id] = got
        return got

    captured: dict[int, Table] = {}
    seen: set[int] = set()

    def visit(t: Table) -> None:
        if t._id in seen:
            return
        seen.add(t._id)
        if not depends_on_param(t):
            captured.setdefault(t._id, t)
            return
        for d in _spec_tables(t):
            visit(d)

    for t in results:
        visit(t)
    return list(captured.values())


class _IterationEngine:
    def __init__(
        self,
        func: Callable,
        outer: dict[str, Table],
        iteration_limit: int | None,
    ) -> None:
        self.outer_names = list(outer)
        self.limit = iteration_limit
        # the parameter tables, bound to the state of each round
        self.params: dict[str, Table] = {
            name: Table(
                TableSpec("iterate_param", [], {"slot": slot}),
                t.column_names(),
                {n: t._dtypes[n] for n in t.column_names()},
                name=f"iterate_param_{name}",
            )
            for slot, (name, t) in enumerate(outer.items())
        }
        result = func(**self.params)
        if isinstance(result, Table):
            result = {"result": result}
        elif not isinstance(result, dict):
            result = dict(result._asdict()) if hasattr(result, "_asdict") else dict(result)
        self.results: dict[str, Table] = result
        #: the returned names fed back into the next round
        self.feedback = [n for n in self.results if n in self.params]
        #: the tables the outer graph computes for the body (module docstring)
        self.captured = _captured_tables(self.results.values(), self.params.values())
        self._cache_inputs: list[dict] | None = None
        self._cache_out: dict[str, dict] | None = None
        #: the rounds of the last fixed point computed
        self.steps = 0

    def compute_all(self, input_states: list[dict]) -> dict[str, dict]:
        """The fixed point over ``input_states``: the parameters' states, then the
        captured tables'. -> each result's state."""
        if self._cache_inputs is not None and all(
            a == b for a, b in zip(self._cache_inputs, input_states)
        ):
            assert self._cache_out is not None
            return self._cache_out
        n_params = len(self.outer_names)
        state = {name: dict(input_states[i]) for i, name in enumerate(self.outer_names)}
        bound = [list(s.items()) for s in input_states[n_params:]]
        steps = 0
        while True:
            runner = GraphRunner()
            runner.iterate_params = [list(state[name].items()) for name in self.outer_names]
            for t, rows in zip(self.captured, bound):
                runner.nodes[t._id] = runner.scope.static_table(rows, len(t._column_names))
            nodes = {n: runner.build(t) for n, t in self.results.items()}
            for node in nodes.values():
                # the round reads each result's state directly: the optimizer must
                # leave these nodes whole (the JAX package does not mark them, so a
                # result that feeds a fused chain loses its rows there; queue 3)
                node._pw_observed = True
            Scheduler(runner.scope).run_static()
            out = {n: dict(node.current) for n, node in nodes.items()}
            steps += 1
            converged = all(out[n] == state[n] for n in self.feedback)
            for n in self.feedback:
                state[n] = out[n]
            if converged or (self.limit is not None and steps >= self.limit):
                break
        self.steps = steps
        self._cache_inputs = [dict(s) for s in input_states]
        self._cache_out = out
        return out


class IterationResult:
    """The iterated tables, as attributes and by name."""

    def __init__(self, tables: dict[str, Table]) -> None:
        self._tables = tables
        for name, t in tables.items():
            setattr(self, name, t)

    def __getitem__(self, name: str) -> Table:
        return self._tables[name]


def iterate(
    func: Callable,
    iteration_limit: int | None = None,
    **kwargs: Table,
) -> IterationResult:
    """Iterate ``func`` to a fixed point.

    ``func(**tables) -> dict[str, Table] | Table``: the returned names that match
    parameter names are fed back each round; every returned table is on the result.
    """
    if not kwargs:
        raise ValueError("pw.iterate needs at least one input table")
    engine = _IterationEngine(func, kwargs, iteration_limit)
    inputs = list(kwargs.values()) + engine.captured
    return IterationResult({
        name: Table(
            TableSpec("iterate_result", inputs, {"engine": engine, "name": name}),
            t.column_names(),
            {c: t._dtypes[c] for c in t.column_names()},
            name=f"iterate_{name}",
        )
        for name, t in engine.results.items()
    })
