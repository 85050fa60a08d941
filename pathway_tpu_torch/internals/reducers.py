"""User-facing reducer constructors: ``pw.reducers.*``.

A copy of ``pathway_tpu/internals/reducers.py``: each constructor builds a
:class:`ReducerExpression` over an engine ``ReducerKind``; ``avg`` desugars to sum over
count, and ``stateful_single`` recomputes a user combine over the group's multiset.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.engine.reducers import ReducerKind
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    BinaryOpExpression,
    CastExpression,
    ColumnExpression,
    ReducerExpression,
    wrap_expression,
)


def count(*args: Any) -> ReducerExpression:
    return ReducerExpression(ReducerKind.COUNT, [])


def sum(expr: Any) -> ReducerExpression:  # noqa: A001 — mirrors pw.reducers.sum
    return ReducerExpression(ReducerKind.SUM, [wrap_expression(expr)])


def min(expr: Any) -> ReducerExpression:  # noqa: A001
    return ReducerExpression(ReducerKind.MIN, [wrap_expression(expr)])


def max(expr: Any) -> ReducerExpression:  # noqa: A001
    return ReducerExpression(ReducerKind.MAX, [wrap_expression(expr)])


def argmin(expr: Any) -> ReducerExpression:
    return ReducerExpression(ReducerKind.ARG_MIN, [wrap_expression(expr)])


def argmax(expr: Any) -> ReducerExpression:
    return ReducerExpression(ReducerKind.ARG_MAX, [wrap_expression(expr)])


def unique(expr: Any) -> ReducerExpression:
    return ReducerExpression(ReducerKind.UNIQUE, [wrap_expression(expr)])


def any(expr: Any) -> ReducerExpression:  # noqa: A001
    return ReducerExpression(ReducerKind.ANY, [wrap_expression(expr)])


def sorted_tuple(expr: Any, *, skip_nones: bool = False) -> ReducerExpression:
    return ReducerExpression(
        ReducerKind.SORTED_TUPLE, [wrap_expression(expr)], skip_nones=skip_nones
    )


def tuple(expr: Any, *, skip_nones: bool = False) -> ReducerExpression:  # noqa: A001
    return ReducerExpression(
        ReducerKind.TUPLE, [wrap_expression(expr)], skip_nones=skip_nones
    )


def ndarray(expr: Any) -> ReducerExpression:
    return ReducerExpression(ReducerKind.NDARRAY, [wrap_expression(expr)])


def earliest(expr: Any) -> ReducerExpression:
    return ReducerExpression(ReducerKind.EARLIEST, [wrap_expression(expr)])


def latest(expr: Any) -> ReducerExpression:
    return ReducerExpression(ReducerKind.LATEST, [wrap_expression(expr)])


def count_distinct(expr: Any) -> ReducerExpression:
    return ReducerExpression(ReducerKind.COUNT_DISTINCT, [wrap_expression(expr)])


def avg(expr: Any) -> ColumnExpression:
    """Average — desugars to sum/count at reduce time."""
    expr = wrap_expression(expr)
    s = ReducerExpression(ReducerKind.SUM, [expr])
    c = ReducerExpression(ReducerKind.COUNT, [])
    out = BinaryOpExpression("/", s, c)
    out._dtype = dt.FLOAT
    return out


def stateful_single(
    combine: Callable[..., Any], *exprs: Any
) -> ReducerExpression:
    """Custom reducer recomputed over the group's retained multiset.

    ``combine(values: list) -> value`` receives the current (flattened)
    multiset of argument values.
    """
    wrapped = [wrap_expression(e) for e in exprs]

    def combine_entries(entries: list) -> Any:
        values: list[Any] = []
        for args, cnt in entries:
            v = args if len(args) > 1 else args[0]
            values.extend([v] * cnt)
        return combine(values)

    return ReducerExpression(
        ReducerKind.STATEFUL,
        wrapped,
        combine=combine_entries,
        n_args=len(wrapped),
    )
