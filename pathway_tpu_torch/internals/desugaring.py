"""Expression desugaring: bind ``pw.this`` placeholders to a table.

Counterpart of ``pathway_tpu/internals/desugaring.py``, a structural substitution over
the expression tree. The join sides (``pw.left``, ``pw.right``) and the delayed
``pw.this.ix_ref`` wait for the join and ix operators.
"""

from __future__ import annotations

import copy
from typing import TYPE_CHECKING, Any, Callable

from pathway_tpu_torch.internals import expression as expr_mod
from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.internals.thisclass import ThisColumnReference, this

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
    if isinstance(expression, str):
        return ColumnReference(table, expression)
    expression = expr_mod.wrap_expression(expression)

    def replace(node: ColumnExpression) -> ColumnExpression | None:
        if isinstance(node, ThisColumnReference):
            if node._owner is not this:
                raise ValueError(f"{node!r} cannot be used here; use pw.this")
            return ColumnReference(table, node.name)
        return None

    return substitute(expression, replace)
