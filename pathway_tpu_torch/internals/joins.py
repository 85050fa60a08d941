"""``JoinResult``: ``t1.join(t2, t1.a == t2.b).select(...)``.

A copy of ``pathway_tpu/internals/joins.py``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.desugaring import resolve_join_sides
from pathway_tpu_torch.internals.expression import (
    BinaryOpExpression,
    ColumnExpression,
    ColumnReference,
)

if TYPE_CHECKING:
    from pathway_tpu_torch.internals.table import Table


class JoinResult:
    """Lazy join; materialized by ``.select`` (or ``.reduce`` after groupby)."""

    def __init__(
        self,
        left: "Table",
        right: "Table",
        on: tuple,
        how: str,
        id: Any = None,  # noqa: A002
    ) -> None:
        self._left = left
        self._right = right
        self._how = how
        self._id = id
        self._on: list[tuple[ColumnExpression, ColumnExpression]] = []
        for cond in on:
            resolved = resolve_join_sides(cond, left, right)
            if not (
                isinstance(resolved, BinaryOpExpression) and resolved._op == "=="
            ):
                raise ValueError(
                    f"join conditions must be equalities (left_col == right_col), got {cond!r}"
                )
            lexpr, rexpr = resolved._left, resolved._right
            if self._side_of(lexpr) == "right" or self._side_of(rexpr) == "left":
                lexpr, rexpr = rexpr, lexpr
            self._on.append((lexpr, rexpr))

    def _side_of(self, expression: ColumnExpression) -> str | None:
        tables = {ref.table._id for ref in expression._dependencies()}
        if tables <= self._reachable_ids(self._left):
            return "left"
        if tables <= self._reachable_ids(self._right):
            return "right"
        return None

    @staticmethod
    def _reachable_ids(table: "Table") -> set[int]:
        return {table._id}

    def select(self, *args: Any, **kwargs: Any) -> "Table":
        from pathway_tpu_torch.internals.table import Table, TableSpec

        from pathway_tpu_torch.internals.thisclass import ThisStar, left, right

        exprs: dict[str, ColumnExpression] = {}
        for arg in args:
            if isinstance(arg, ThisStar):
                # *pw.left / *pw.right expand that side; *pw.this takes
                # both (left first; duplicate names keep the left column)
                sides = (
                    [self._left]
                    if arg._owner is left
                    else [self._right]
                    if arg._owner is right
                    else [self._left, self._right]
                )
                for side in sides:
                    for n in side.column_names():
                        exprs.setdefault(n, ColumnReference(side, n))
                continue
            resolved = resolve_join_sides(arg, self._left, self._right)
            if not isinstance(resolved, ColumnReference):
                raise ValueError("positional join-select arguments must be column refs")
            exprs[resolved.name] = resolved
        for name, value in kwargs.items():
            exprs[name] = resolve_join_sides(value, self._left, self._right)
        dtypes = {n: e._dtype for n, e in exprs.items()}
        id_spec = None
        if self._id is not None:
            resolved_id = resolve_join_sides(self._id, self._left, self._right)
            if not isinstance(resolved_id, ColumnReference):
                raise ValueError(
                    "join id= must be a column reference (a side's .id or "
                    "a pointer column)"
                )
            if resolved_id.table is self._left:
                side, side_table = "left", self._left
            elif resolved_id.table is self._right:
                side, side_table = "right", self._right
            else:
                raise ValueError(
                    "join id= must reference one of the joined tables"
                )
            if resolved_id.name == "id":
                id_spec = (side, None)
            else:
                col_dtype = side_table._dtypes.get(resolved_id.name)
                base = (
                    col_dtype.strip_optional()
                    if col_dtype is not None
                    else None
                )
                if not (
                    col_dtype is None
                    or col_dtype == dt.ANY
                    or isinstance(base, dt.Pointer)
                ):
                    raise ValueError(
                        f"join id= column {resolved_id.name!r} must be "
                        f"pointer-typed, got {col_dtype}"
                    )
                id_spec = (side, resolved_id.name)
        return Table(
            TableSpec(
                "join_select",
                [self._left, self._right],
                {
                    "on": self._on,
                    "how": self._how,
                    "exprs": exprs,
                    "id_spec": id_spec,
                },
            ),
            list(exprs.keys()),
            dtypes,
        )
