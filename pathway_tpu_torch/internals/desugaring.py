"""Expression desugaring: bind the ``pw.this``, ``pw.left`` and ``pw.right``
placeholders to tables.

Counterpart of ``pathway_tpu/internals/desugaring.py``, a structural substitution over
the expression tree.
"""

from __future__ import annotations

import copy
from typing import TYPE_CHECKING, Any, Callable

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.internals.thisclass import ThisColumnReference, left, right, this

if TYPE_CHECKING:
    from pathway_tpu_torch.internals.table import Table

_CHILD_ATTRS = (
    "_left",
    "_right",
    "_arg",
    "_cond",
    "_then",
    "_otherwise",
    "_value",
    "_fallback",
    "_index",
    "_default",
    "_instance",
)
_CHILD_LIST_ATTRS = ("_args", "_deps")
_CHILD_DICT_ATTRS = ("_kwargs",)


def substitute(
    expression: ColumnExpression,
    replace: Callable[[ColumnExpression], ColumnExpression | None],
) -> ColumnExpression:
    """Rebuild an expression tree, replacing nodes where ``replace`` returns
    a non-None substitute."""
    replaced = replace(expression)
    if replaced is not None:
        return replaced
    clone: ColumnExpression | None = None

    def ensure_clone() -> ColumnExpression:
        nonlocal clone
        if clone is None:
            clone = copy.copy(expression)
        return clone

    for attr in _CHILD_ATTRS:
        child = getattr(expression, attr, None)
        if isinstance(child, ColumnExpression):
            new_child = substitute(child, replace)
            if new_child is not child:
                setattr(ensure_clone(), attr, new_child)
    for attr in _CHILD_LIST_ATTRS:
        children = getattr(expression, attr, None)
        if isinstance(children, list):
            new_children = [
                substitute(c, replace) if isinstance(c, ColumnExpression) else c
                for c in children
            ]
            if any(a is not b for a, b in zip(children, new_children)):
                setattr(ensure_clone(), attr, new_children)
    for attr in _CHILD_DICT_ATTRS:
        children = getattr(expression, attr, None)
        if isinstance(children, dict):
            new_dict = {
                k: substitute(c, replace) if isinstance(c, ColumnExpression) else c
                for k, c in children.items()
            }
            if any(new_dict[k] is not children[k] for k in children):
                setattr(ensure_clone(), attr, new_dict)
    return clone if clone is not None else expression


def resolve_this(expression: Any, table: "Table") -> ColumnExpression:
    """Bind ``pw.this`` placeholders (and bare column names) to ``table``."""
    from pathway_tpu_torch.internals.thisclass import DelayedIxRefColumn

    if isinstance(expression, str):
        return ColumnReference(table, expression)
    expression = expr_mod.wrap_expression(expression)

    def replace(node: ColumnExpression) -> ColumnExpression | None:
        if isinstance(node, DelayedIxRefColumn):
            if node._owner is not this:
                raise ValueError(f"{node!r} cannot be used here; use pw.this")
            return ColumnReference(
                _delayed_ix_table(node, table), node.name
            )
        if isinstance(node, ThisColumnReference):
            if node._owner is not this:
                raise ValueError(f"{node!r} cannot be used here; use pw.this")
            return ColumnReference(table, node.name)
        return None

    return substitute(expression, replace)


def _delayed_ix_table(node: "ColumnExpression", table: "Table") -> "Table":
    """The bound table indexes ITSELF by the key expressions, with
    itself as the keys context (reference delayed ix_ref). Identical
    (args, kwargs) chains reuse ONE ix table per bound table, so
    selecting several columns from the same pw.this.ix_ref(keys) runs a
    single index lookup."""
    cache = table.__dict__.setdefault("_pw_ix_ref_cache", {})
    key = repr((node._ix_args, node._ix_kwargs))
    ix_table = cache.get(key)
    if ix_table is None:
        ix_table = table.ix_ref(
            *node._ix_args, context=table, **node._ix_kwargs
        )
        cache[key] = ix_table
    return ix_table


def resolve_join_sides(
    expression: Any, left_table: "Table", right_table: "Table"
) -> ColumnExpression:
    """Bind pw.left/pw.right (and pw.this → left) in a join context."""
    from pathway_tpu_torch.internals.thisclass import DelayedIxRefColumn

    expression = expr_mod.wrap_expression(expression)

    def replace(node: ColumnExpression) -> ColumnExpression | None:
        if isinstance(node, DelayedIxRefColumn):
            # pw.this binds the left side in a join context, matching
            # the ThisColumnReference rule below
            side = (
                right_table if node._owner is right else left_table
            )
            return ColumnReference(
                _delayed_ix_table(node, side), node.name
            )
        if isinstance(node, ThisColumnReference):
            if node._owner is left or node._owner is this:
                return ColumnReference(left_table, node.name)
            if node._owner is right:
                return ColumnReference(right_table, node.name)
        return None

    return substitute(expression, replace)


def resolve_side(expression: Any, table: "Table", side: str) -> ColumnExpression:
    """Bind ``pw.this`` and the side's own placeholder (``pw.left`` for ``side="left"``,
    ``pw.right`` for ``"right"``) to ``table``: the temporal joins take a time
    expression per side in either spelling."""
    if isinstance(expression, str):
        return ColumnReference(table, expression)
    expression = expr_mod.wrap_expression(expression)
    sided = left if side == "left" else right

    def replace(node: ColumnExpression) -> ColumnExpression | None:
        if isinstance(node, ThisColumnReference):
            if node._owner is this or node._owner is sided:
                return ColumnReference(table, node.name)
            raise ValueError(f"{node!r} cannot be used for the {side} side of this join")
        return None

    return substitute(expression, replace)
