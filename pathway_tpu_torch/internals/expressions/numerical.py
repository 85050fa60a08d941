"""``expr.num.*``: the numeric methods of a column expression.

Counterpart of ``pathway_tpu/internals/expressions/numerical.py``."""

from __future__ import annotations

import math
from typing import Any

from pathway_tpu_torch.internals.expression import (
    ApplyExpression,
    ColumnExpression,
    wrap_expression,
)


def _method(fn, ret, *args):
    return ApplyExpression(fn, ret, args, {}, propagate_none=True)


class NumericalNamespace:
    def __init__(self, expression: ColumnExpression) -> None:
        self._e = expression

    def abs(self) -> ColumnExpression:
        return _method(abs, float, self._e)

    def round(self, decimals: Any = 0) -> ColumnExpression:
        return _method(lambda x, d: round(x, d), float, self._e, wrap_expression(decimals))

    def fill_na(self, default_value: Any) -> ColumnExpression:
        def fill(x: Any, d: Any) -> Any:
            if x is None:
                return d
            if isinstance(x, float) and math.isnan(x):
                return d
            return x

        return ApplyExpression(
            fill, None, (self._e, wrap_expression(default_value)), {}, propagate_none=False
        )
