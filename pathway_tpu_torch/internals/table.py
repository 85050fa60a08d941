"""`pw.Table`: the declarative table API.

Counterpart of ``pathway_tpu/internals/table.py``: column access, ``select`` and the
operations that are selects (``with_columns``, ``without``, ``rename*``,
``with_prefix``, ``with_suffix``, ``copy``, ``cast_to_types``, ``update_types``),
``filter`` and ``split``, ``groupby`` and ``reduce``, the joins, ``concat`` and
``concat_reindex``, ``update_rows`` and ``update_cells``, ``intersect``,
``difference`` and ``restrict``, the re-keying operations (``with_id``,
``with_id_from``, ``with_universe_of``), ``flatten``, ``ix`` and ``ix_ref``,
``having``, ``deduplicate``, ``sort``, ``await_futures``, the universe promises,
``remove_errors``, the as-of-now external index and the static constructors ``empty``
and ``from_rows``. Tables are lazy: each holds a
:class:`TableSpec` describing the operator that produces it, and
:mod:`pathway_tpu_torch.internals.runner` lowers the reachable specs onto the engine
scope at run time. The reference's other public methods are here by name and raise
``NotImplementedError`` naming the ROADMAP item that ports them (:data:`UNPORTED`).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping, Sequence

from pathway_tpu_torch.engine.value import Pointer, ref_scalar
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.desugaring import resolve_this
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    PointerExpression,
    wrap_expression,
)
from pathway_tpu_torch.internals.trace import current_trace
from pathway_tpu_torch.internals.universe import Universe, solver

_table_counter = itertools.count()


class JoinMode:
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    OUTER = "outer"


@dataclass
class TableSpec:
    """How to produce this table: operator kind + inputs + parameters."""

    kind: str
    inputs: list["Table"] = field(default_factory=list)
    params: dict[str, Any] = field(default_factory=dict)


class Table:
    def __init__(
        self,
        spec: TableSpec,
        column_names: Sequence[str],
        dtypes: Mapping[str, dt.DType],
        universe: Universe | None = None,
        name: str | None = None,
    ) -> None:
        self._spec = spec
        self._column_names = list(column_names)
        self._dtypes = dict(dtypes)
        self._universe = universe if universe is not None else Universe()
        self._id = next(_table_counter)
        self._name = name or f"table_{self._id}"
        self._trace = current_trace()
        from pathway_tpu_torch.internals import errors as _errors

        self._error_log_id = _errors.current_log_id()

    # -- introspection ------------------------------------------------------

    @property
    def schema(self) -> schema_mod.SchemaMetaclass:
        return schema_mod.schema_from_dict(
            {n: self._dtypes[n] for n in self._column_names}, name=f"{self._name}_schema"
        )

    def column_names(self) -> list[str]:
        return list(self._column_names)

    def typehints(self) -> dict[str, Any]:
        return {n: self._dtypes[n].typehint for n in self._column_names}

    def keys(self) -> list[str]:
        return list(self._column_names)

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}: {self._dtypes[n]!r}" for n in self._column_names)
        return f"<pw.Table {self._name}({cols})>"

    # -- column access ------------------------------------------------------

    @property
    def id(self) -> ColumnReference:
        return ColumnReference(self, "id")

    def __getattr__(self, name: str) -> ColumnReference:
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self.__dict__.get("_column_names", ()):
            raise AttributeError(
                f"table {self._name!r} has no column {name!r}; "
                f"columns: {self._column_names}"
            )
        return ColumnReference(self, name)

    def __getitem__(self, arg: Any) -> Any:
        if isinstance(arg, str):
            if arg == "id":
                return self.id
            return ColumnReference(self, arg)
        if isinstance(arg, (list, tuple)):
            return self.select(*[self[a] for a in arg])
        if isinstance(arg, ColumnReference):
            return ColumnReference(self, arg.name)
        raise TypeError(f"cannot index table with {arg!r}")

    def __iter__(self) -> Iterable[ColumnReference]:
        return iter(ColumnReference(self, n) for n in self._column_names)

    def _ref(self, name: str) -> ColumnReference:
        return ColumnReference(self, name)

    def pointer_from(
        self, *args: Any, instance: Any = None, optional: bool = False
    ) -> PointerExpression:
        resolved = [resolve_this(a, self) for a in args]
        inst = resolve_this(instance, self) if instance is not None else None
        return PointerExpression(resolved, instance=inst)

    # -- helpers ------------------------------------------------------------

    def _resolve_kwargs(
        self, args: tuple, kwargs: dict
    ) -> dict[str, ColumnExpression]:
        from pathway_tpu_torch.internals.thisclass import ThisStar

        out: dict[str, ColumnExpression] = {}
        for arg in args:
            if isinstance(arg, str):
                out[arg] = ColumnReference(self, arg)
                continue
            if isinstance(arg, ThisStar):
                from pathway_tpu_torch.internals.thisclass import this

                if arg._owner is not this:
                    raise ValueError(
                        f"{arg!r} cannot be used here; use *pw.this"
                    )
                # ``*pw.this``: every column of the bound table
                for n in self._column_names:
                    out[n] = ColumnReference(self, n)
                continue
            resolved = resolve_this(arg, self)
            if isinstance(resolved, ColumnReference):
                if resolved.name == "id":
                    raise ValueError("cannot select id as a positional column")
                out[resolved.name] = resolved
            else:
                raise ValueError(
                    f"positional select arguments must be column references, got {arg!r}"
                )
        for name, value in kwargs.items():
            out[name] = resolve_this(value, self)
        return out

    def _derived(
        self,
        spec: TableSpec,
        columns: Mapping[str, dt.DType],
        universe: Universe | None = None,
        name_hint: str | None = None,
    ) -> "Table":
        return Table(
            spec,
            list(columns.keys()),
            columns,
            universe=universe,
            name=name_hint,
        )

    # -- core ops -----------------------------------------------------------

    def select(self, *args: Any, **kwargs: Any) -> "Table":
        exprs = self._resolve_kwargs(args, kwargs)
        return self._derived(
            TableSpec("select", [self], {"exprs": exprs}),
            {n: e._dtype for n, e in exprs.items()},
            universe=self._universe,
        )

    def _select_all(self, exprs: Mapping[str, ColumnExpression]) -> "Table":
        return self._derived(
            TableSpec("select", [self], {"exprs": dict(exprs)}),
            {n: e._dtype for n, e in exprs.items()},
            universe=self._universe,
        )

    def with_columns(self, *args: Any, **kwargs: Any) -> "Table":
        combined: dict[str, ColumnExpression] = {
            n: ColumnReference(self, n) for n in self._column_names
        }
        combined.update(self._resolve_kwargs(args, kwargs))
        return self._select_all(combined)

    def without(self, *columns: Any) -> "Table":
        names = set()
        for col in columns:
            if isinstance(col, str):
                names.add(col)
            else:
                resolved = resolve_this(col, self)
                if not isinstance(resolved, ColumnReference):
                    raise ValueError(f"without() takes columns, got {col!r}")
                names.add(resolved.name)
        return self._select_all(
            {n: ColumnReference(self, n) for n in self._column_names if n not in names}
        )

    def rename(
        self, names_mapping: Mapping[Any, str] | None = None, **kwargs: Any
    ) -> "Table":
        """``names_mapping`` maps old columns to new names; keyword arguments read
        ``new_name=old_column``, as in the reference."""

        def colname(ref: Any) -> str:
            name = getattr(ref, "name", None)  # a column reference or pw.this.x
            return name if isinstance(name, str) else str(ref)

        mapping: dict[str, str] = {}
        for old, new in (names_mapping or {}).items():
            mapping[colname(old)] = new
        for new, old in kwargs.items():
            mapping[colname(old)] = new
        return self._select_all(
            {mapping.get(n, n): ColumnReference(self, n) for n in self._column_names}
        )

    rename_columns = rename

    def rename_by_dict(self, names_mapping: Mapping[Any, str]) -> "Table":
        return self.rename(names_mapping)

    def with_prefix(self, prefix: str) -> "Table":
        return self.rename({n: prefix + n for n in self._column_names})

    def with_suffix(self, suffix: str) -> "Table":
        return self.rename({n: n + suffix for n in self._column_names})

    def copy(self) -> "Table":
        return self.select(**{n: ColumnReference(self, n) for n in self._column_names})

    def _retyped(self, kind: type, types: Mapping[str, Any]) -> "Table":
        return self._select_all(
            {
                n: kind(ColumnReference(self, n), types[n])
                if n in types
                else ColumnReference(self, n)
                for n in self._column_names
            }
        )

    def cast_to_types(self, **kwargs: Any) -> "Table":
        return self._retyped(expr_mod.CastExpression, kwargs)

    def update_types(self, **kwargs: Any) -> "Table":
        return self._retyped(expr_mod.DeclareTypeExpression, kwargs)

    # -- filter -------------------------------------------------------------

    def filter(self, filter_expression: Any) -> "Table":
        cond = resolve_this(filter_expression, self)
        return self._derived(
            TableSpec("filter", [self], {"condition": cond}),
            {n: self._dtypes[n] for n in self._column_names},
            universe=self._universe.subset(),
        )

    def split(self, expression: Any) -> tuple["Table", "Table"]:
        cond = resolve_this(expression, self)
        pos = self.filter(cond)
        neg = self.filter(expr_mod.UnaryOpExpression("not", cond))
        return pos, neg

    # -- groupby / reduce ---------------------------------------------------

    def groupby(
        self,
        *args: Any,
        id: Any = None,  # noqa: A002 — mirrors reference signature
        instance: Any = None,
        **kwargs: Any,
    ) -> "GroupedTable":
        from pathway_tpu_torch.internals.groupbys import GroupedTable

        by: list[ColumnReference] = []
        if id is not None:
            resolved = resolve_this(id, self)
            assert isinstance(resolved, ColumnReference)
            return GroupedTable(self, [resolved], set_id=True)
        for arg in args:
            resolved = resolve_this(arg, self)
            if not isinstance(resolved, ColumnReference):
                raise ValueError("groupby arguments must be column references")
            by.append(resolved)
        if instance is not None:
            inst = resolve_this(instance, self)
            assert isinstance(inst, ColumnReference)
            by.append(inst)
        return GroupedTable(self, by, instance_last=instance is not None)

    def reduce(self, *args: Any, **kwargs: Any) -> "Table":
        from pathway_tpu_torch.internals.groupbys import GroupedTable

        return GroupedTable(self, []).reduce(*args, **kwargs)

    def deduplicate(
        self,
        *,
        value: Any,
        instance: Any = None,
        acceptor: Callable[[Any, Any], bool],
        name: str | None = None,
    ) -> "Table":
        """One row per ``instance`` (one for the whole table without it): a new row
        replaces the kept one when ``acceptor(new value, kept value)`` is true."""
        instance_refs = [resolve_this(instance, self)] if instance is not None else []
        return self._derived(
            TableSpec(
                "deduplicate",
                [self],
                {"value": resolve_this(value, self), "instance": instance_refs,
                 "acceptor": acceptor, "name": name},
            ),
            {n: self._dtypes[n] for n in self._column_names},
        )

    # -- joins --------------------------------------------------------------

    def join(
        self, other: "Table", *on: Any, id: Any = None, how: str = JoinMode.INNER  # noqa: A002
    ) -> "JoinResult":
        from pathway_tpu_torch.internals.joins import JoinResult

        return JoinResult(self, other, on, how=how, id=id)

    def join_inner(self, other: "Table", *on: Any, id: Any = None) -> "JoinResult":  # noqa: A002
        return self.join(other, *on, id=id, how=JoinMode.INNER)

    def join_left(self, other: "Table", *on: Any, id: Any = None) -> "JoinResult":  # noqa: A002
        return self.join(other, *on, id=id, how=JoinMode.LEFT)

    def join_right(self, other: "Table", *on: Any, id: Any = None) -> "JoinResult":  # noqa: A002
        return self.join(other, *on, id=id, how=JoinMode.RIGHT)

    def join_outer(self, other: "Table", *on: Any, id: Any = None) -> "JoinResult":  # noqa: A002
        return self.join(other, *on, id=id, how=JoinMode.OUTER)

    # -- set operations -----------------------------------------------------

    def concat(self, *others: "Table") -> "Table":
        tables = [self, *others]
        dtypes: dict[str, dt.DType] = {}
        for n in self._column_names:
            dtype = self._dtypes[n]
            for o in others:
                if n not in o._dtypes:
                    raise ValueError(f"column {n!r} missing in concat operand")
                dtype = dt.lca(dtype, o._dtypes[n])
            dtypes[n] = dtype
        return self._derived(
            TableSpec("concat", tables, {}),
            dtypes,
            # concat's key set IS the union of the operands': the SAT
            # solver then proves each operand ⊆ result (cross-table
            # selects against an operand keep working)
            universe=solver.get_union(*(t._universe for t in tables)),
        )

    def concat_reindex(self, *others: "Table") -> "Table":
        reindexed = [
            t.with_id_from(t.id, expr_mod.ColumnConstExpression(i))
            for i, t in enumerate([self, *others])
        ]
        return reindexed[0].concat(*reindexed[1:])

    def update_rows(self, other: "Table") -> "Table":
        if set(other._column_names) != set(self._column_names):
            raise ValueError("update_rows requires matching columns")
        dtypes = {
            n: dt.lca(self._dtypes[n], other._dtypes[n]) for n in self._column_names
        }
        return self._derived(TableSpec("update_rows", [self, other], {}), dtypes)

    def update_cells(self, other: "Table") -> "Table":
        extra = set(other._column_names) - set(self._column_names)
        if extra:
            raise ValueError(f"update_cells: unknown columns {extra}")
        dtypes = {
            n: dt.lca(self._dtypes[n], other._dtypes[n]) if n in other._dtypes else self._dtypes[n]
            for n in self._column_names
        }
        return self._derived(
            TableSpec("update_cells", [self, other], {}),
            dtypes,
            universe=self._universe,
        )

    def __lshift__(self, other: "Table") -> "Table":
        return self.update_cells(other)

    def intersect(self, *tables: "Table") -> "Table":
        return self._derived(
            TableSpec("intersect", [self, *tables], {}),
            {n: self._dtypes[n] for n in self._column_names},
            universe=solver.get_intersection(
                self._universe, *(t._universe for t in tables)
            ),
        )

    def difference(self, other: "Table") -> "Table":
        return self._derived(
            TableSpec("subtract", [self, other], {}),
            {n: self._dtypes[n] for n in self._column_names},
            universe=solver.get_difference(self._universe, other._universe),
        )

    def with_universe_of(self, other: "Table") -> "Table":
        solver.register_equal(self._universe, other._universe)
        return self._derived(
            TableSpec("override_universe", [self, other], {}),
            {n: self._dtypes[n] for n in self._column_names},
            universe=other._universe,
        )

    # -- re-keying and pointer lookup ---------------------------------------

    def with_id_from(self, *args: Any, instance: Any = None) -> "Table":
        resolved = [resolve_this(a, self) for a in args]
        inst = resolve_this(instance, self) if instance is not None else None
        pointer = PointerExpression(resolved, instance=inst)
        return self._derived(
            TableSpec("reindex", [self], {"new_id": pointer}),
            {n: self._dtypes[n] for n in self._column_names},
        )

    def with_id(self, new_id: Any) -> "Table":
        pointer = resolve_this(new_id, self)
        return self._derived(
            TableSpec("reindex", [self], {"new_id": pointer}),
            {n: self._dtypes[n] for n in self._column_names},
        )

    def ix(
        self, expression: Any, *, optional: bool = False, context: Any = None
    ) -> "Table":
        expression = wrap_expression(expression)
        if context is not None:
            keys_table = context
        else:
            deps = list(expression._dependencies())
            if not deps:
                raise ValueError(
                    "ix expression must reference a column (or pass "
                    "context=)"
                )
            keys_table = deps[0].table
        keys = keys_table.select(_pw_ix_key=expression)
        return self._derived(
            TableSpec("ix", [keys, self], {"optional": optional}),
            {n: self._dtypes[n] for n in self._column_names},
            universe=keys_table._universe,
        )

    def ix_ref(
        self,
        *args: Any,
        optional: bool = False,
        instance: Any = None,
        context: "Table | None" = None,
        allow_misses: bool = False,
    ) -> "Table":
        """Reindex this table by primary-key expressions: desugars to
        ``self.ix(keys_table.pointer_from(*args))``, inferring the keys table from the
        expressions' column references. ``context`` pins the keys table when the
        arguments are literals only; ``pw.this.ix_ref(...)`` inside select supplies it
        automatically."""
        keys_table = context
        if keys_table is None:
            exprs = [wrap_expression(a) for a in args]
            if instance is not None:
                exprs.append(wrap_expression(instance))
            deps = [d for e in exprs for d in e._dependencies()]
            if not deps:
                raise ValueError(
                    "ix_ref with literal-only keys cannot infer the keys "
                    "table; pass context= or use pw.this.ix_ref(...) "
                    "inside select"
                )
            keys_table = deps[0].table
        # plain strings are literal KEY VALUES here (ix_ref("Alice")),
        # unlike select's string-as-column-name convention
        resolved = [
            wrap_expression(a)
            if isinstance(a, str)
            else resolve_this(a, keys_table)
            for a in args
        ]
        inst = (
            resolve_this(instance, keys_table)
            if instance is not None
            else None
        )
        pointer = PointerExpression(resolved, instance=inst)
        return self.ix(
            pointer, optional=optional or allow_misses, context=keys_table
        )

    def flatten(
        self, to_flatten: Any, *, origin_id: str | None = None, **kwargs: Any
    ) -> "Table":
        """Explode a sequence column; ``origin_id`` names an extra column holding
        the source row's id."""
        ref = resolve_this(to_flatten, self)
        assert isinstance(ref, ColumnReference)
        inner = self._dtypes.get(ref.name, dt.ANY)
        base = inner.strip_optional()
        if isinstance(base, dt.List):
            flat_dtype: dt.DType = base.wrapped
        elif isinstance(base, dt.Tuple) and base.args:
            flat_dtype = base.args[0]
        elif base == dt.STR:
            flat_dtype = dt.STR
        else:
            flat_dtype = dt.ANY
        dtypes = {
            n: (flat_dtype if n == ref.name else self._dtypes[n])
            for n in self._column_names
        }
        if origin_id is not None:
            dtypes[origin_id] = dt.Pointer()
        return self._derived(
            TableSpec(
                "flatten", [self], {"column": ref.name, "origin_id": origin_id}
            ),
            dtypes,
        )

    # -- static constructors ------------------------------------------------

    @staticmethod
    def empty(**kwargs: Any) -> "Table":
        dtypes = {n: dt.wrap(t) for n, t in kwargs.items()}
        return Table(
            TableSpec("static", [], {"rows": []}),
            list(dtypes.keys()),
            dtypes,
        )

    @staticmethod
    def from_rows(
        rows: Sequence[tuple],
        schema: schema_mod.SchemaMetaclass,
        keys: Sequence[Pointer] | None = None,
    ) -> "Table":
        names = schema.column_names()
        dtypes = schema.dtypes()
        pk = schema.primary_key_columns()
        out_rows: list[tuple[Pointer, tuple]] = []
        for i, row in enumerate(rows):
            normalized = tuple(
                dt.normalize_value(v, dtypes[n]) for v, n in zip(row, names)
            )
            if keys is not None:
                key = keys[i]
            elif pk:
                key_vals = tuple(normalized[names.index(p)] for p in pk)
                key = ref_scalar(*key_vals)
            else:
                key = ref_scalar(i)
            out_rows.append((key, normalized))
        return Table(
            TableSpec("static", [], {"rows": out_rows}),
            names,
            dtypes,
        )

    def restrict(self, other: "Table") -> "Table":
        return self._derived(
            TableSpec("restrict", [self, other], {}),
            {n: self._dtypes[n] for n in self._column_names},
            universe=other._universe,
        )

    def promise_universes_are_equal(self, other: "Table") -> "Table":
        solver.register_equal(self._universe, other._universe)
        return self

    def promise_universe_is_subset_of(self, other: "Table") -> "Table":
        solver.register_subset(self._universe, other._universe)
        return self

    def promise_universe_is_equal_to(self, other: "Table") -> "Table":
        return self.promise_universes_are_equal(other)

    @property
    def slice(self) -> "Table":
        """A column-access view; tables take ``t[...]`` directly."""
        return self

    def having(self, *indexers: Any) -> "Table":
        """The rows whose id is among the pointer values of each indexer expression
        (as ``ix_ref`` gives them)."""
        out = self
        for ix in indexers:
            resolved = resolve_this(ix, self)
            keys = resolved.table.select(_pw_p=resolved)
            out = out.intersect(keys.with_id(keys["_pw_p"]))
        return out

    def sort(self, key: Any, instance: Any = None) -> "Table":
        """``prev`` and ``next``: each row's neighbours' ids in the order of ``key``
        within its ``instance``."""
        key_expr = resolve_this(key, self)
        inst_expr = resolve_this(instance, self) if instance is not None else None
        return self._derived(
            TableSpec("sort", [self], {"key": key_expr, "instance": inst_expr}),
            {"prev": dt.Optional_(dt.Pointer()), "next": dt.Optional_(dt.Pointer())},
            universe=self._universe,
        )

    def await_futures(self) -> "Table":
        """The table with its ``Future`` columns' types unwrapped: async results are
        resolved in the commit of their rows, so this is a type-level unwrap."""
        exprs = {
            n: (
                expr_mod.DeclareTypeExpression(ColumnReference(self, n), self._dtypes[n].wrapped)
                if isinstance(self._dtypes[n], dt.Future)
                else ColumnReference(self, n)
            )
            for n in self._column_names
        }
        return self._derived(
            TableSpec("select", [self], {"exprs": exprs}),
            {n: e._dtype for n, e in exprs.items()},
            universe=self._universe,
        )

    def _external_index_as_of_now(
        self,
        query_table: "Table",
        index_column: ColumnExpression,
        query_column: ColumnExpression,
        index_factory: Any,
        number_of_matches: Any = 3,
    ) -> "Table":
        """As-of-now external-index lookup (reference: Table._external_index_
        _as_of_now internals/table.py:584 → use_external_index_as_of_now).

        ``self`` is the indexed data table. Returns a table keyed by query id
        with columns ``_pw_index_reply_ids`` / ``_pw_index_reply_scores``.
        ``number_of_matches`` is an int or a ColumnExpression on the query
        table (per-query limit).
        """
        index_expr = resolve_this(index_column, self)
        query_expr = resolve_this(query_column, query_table)
        limit_expr: ColumnExpression | None = None
        k = 3
        if isinstance(number_of_matches, ColumnExpression):
            limit_expr = resolve_this(number_of_matches, query_table)
            k = 16
        else:
            k = int(number_of_matches)
        return self._derived(
            TableSpec(
                "external_index",
                [self, query_table],
                {
                    "index_expr": index_expr,
                    "query_expr": query_expr,
                    "limit_expr": limit_expr,
                    "k": k,
                    "factory": index_factory,
                },
            ),
            {
                "_pw_index_reply_ids": dt.ANY,
                "_pw_index_reply_scores": dt.ANY,
            },
            universe=query_table._universe.subset(),
        )

    def remove_errors(self) -> "Table":
        return self._derived(
            TableSpec("remove_errors", [self], {}),
            {n: self._dtypes[n] for n in self._column_names},
            universe=self._universe.subset(),
        )


#: the reference ``Table``'s public methods that are not ported yet -> the ROADMAP
#: queue 1 item that ports them
UNPORTED = {
    **dict.fromkeys(
        ("asof_join", "asof_now_join", "interval_join", "window_join", "windowby"),
        "11: the other node types and table operations",
    ),
    "show": "8: the rest of the package (the stdlib's viz)",
}


def _unported(name: str, item: str) -> Any:
    def method(*_args: Any, **_kwargs: Any) -> Any:
        raise NotImplementedError(
            f"Table.{name} is not ported yet (ROADMAP queue 1 item {item})"
        )

    method.__name__ = name
    method.__qualname__ = f"Table.{name}"
    return method


for _name, _item in UNPORTED.items():
    setattr(Table, _name, _unported(_name, _item))
del _name, _item
