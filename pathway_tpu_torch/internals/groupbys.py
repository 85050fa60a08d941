"""``GroupedTable``: ``table.groupby(...).reduce(...)``.

A copy of ``pathway_tpu/internals/groupbys.py``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.desugaring import resolve_this, substitute
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    ReducerExpression,
)

if TYPE_CHECKING:
    from pathway_tpu_torch.internals.table import Table


class GroupedTable:
    def __init__(
        self,
        table: "Table",
        by: list[ColumnReference],
        set_id: bool = False,
        instance_last: bool = False,
    ) -> None:
        self._table = table
        self._by = by
        self._set_id = set_id
        self._instance_last = instance_last

    def reduce(self, *args: Any, **kwargs: Any) -> "Table":
        from pathway_tpu_torch.internals.table import Table, TableSpec

        table = self._table
        exprs: dict[str, ColumnExpression] = {}
        for arg in args:
            from pathway_tpu_torch.internals.thisclass import ThisStar

            if isinstance(arg, ThisStar):
                from pathway_tpu_torch.internals.thisclass import this

                if arg._owner is not this:
                    raise ValueError(
                        f"{arg!r} cannot be used here; use *pw.this"
                    )
                # *pw.this inside reduce: the grouping columns (anything
                # else is invalid in a reduce anyway)
                for ref in self._by:
                    exprs[ref.name] = ref
                continue
            resolved = resolve_this(arg, table)
            if not isinstance(resolved, ColumnReference):
                raise ValueError("positional reduce arguments must be column references")
            exprs[resolved.name] = resolved
        for name, value in kwargs.items():
            exprs[name] = resolve_this(value, table)

        by_names = {ref.name for ref in self._by}
        # validate: plain column refs in outputs must be grouping columns
        for name, e in exprs.items():
            for ref in e._dependencies():
                if isinstance(ref, ColumnReference) and ref.table is table:
                    if ref.name not in by_names and not self._set_id and ref.name != "id":
                        # it may appear under a reducer; verified during lowering
                        pass

        dtypes = {n: e._dtype for n, e in exprs.items()}
        return Table(
            TableSpec(
                "groupby_reduce",
                [table],
                {
                    "by": self._by,
                    "exprs": exprs,
                    "set_id": self._set_id,
                    "instance_last": self._instance_last,
                },
            ),
            list(exprs.keys()),
            dtypes,
        )
