"""`pw.Table`: the declarative table API.

Counterpart of ``pathway_tpu/internals/table.py`` for the operations of the
streaming-RAG pipeline: column access, ``select`` and the operations that are selects
(``with_columns``, ``without``, ``rename*``, ``with_prefix``, ``with_suffix``, ``copy``,
``cast_to_types``, ``update_types``), ``restrict``, the universe promises,
``remove_errors`` and the as-of-now external index. Tables are lazy: each holds a
:class:`TableSpec` describing the operator that produces it, and
:mod:`pathway_tpu_torch.internals.runner` lowers the reachable specs onto the engine
scope at run time. The reference's other public methods are here by name and raise
``NotImplementedError`` naming the ROADMAP item that ports them (:data:`UNPORTED`).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping, Sequence

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.desugaring import resolve_this
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    PointerExpression,
)
from pathway_tpu_torch.internals.trace import current_trace
from pathway_tpu_torch.internals.universe import Universe, solver

_table_counter = itertools.count()


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
        (
            "asof_join", "asof_now_join", "await_futures", "concat", "concat_reindex",
            "deduplicate", "difference", "empty", "filter", "flatten", "from_rows",
            "groupby", "having", "intersect", "interval_join", "ix", "ix_ref", "join",
            "join_inner", "join_left", "join_outer", "join_right", "reduce", "sort",
            "split", "update_cells", "update_rows", "window_join", "windowby",
            "with_id", "with_id_from", "with_universe_of",
        ),
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
    _fn = _unported(_name, _item)
    # the reference's constructors are static methods
    setattr(Table, _name, staticmethod(_fn) if _name in ("empty", "from_rows") else _fn)
del _name, _item, _fn
