"""``expr.str.*``: the string methods of a column expression.

Counterpart of ``pathway_tpu/internals/expressions/string.py``."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    ApplyExpression,
    ColumnExpression,
    wrap_expression,
)


def _method(fn, ret, *args, propagate_none=True):
    return ApplyExpression(fn, ret, args, {}, propagate_none=propagate_none)


class StringNamespace:
    def __init__(self, expression: ColumnExpression) -> None:
        self._e = expression

    def lower(self) -> ColumnExpression:
        return _method(lambda s: s.lower(), str, self._e)

    def upper(self) -> ColumnExpression:
        return _method(lambda s: s.upper(), str, self._e)

    def reversed(self) -> ColumnExpression:
        return _method(lambda s: s[::-1], str, self._e)

    def len(self) -> ColumnExpression:
        return _method(len, int, self._e)

    def strip(self, chars: Any = None) -> ColumnExpression:
        # a literal-None optional arg must not ride through None-propagating
        # apply (it would blank the result row) — omit it instead
        if chars is None:
            return _method(lambda s: s.strip(), str, self._e)
        return _method(lambda s, c: s.strip(c), str, self._e, wrap_expression(chars))

    def lstrip(self, chars: Any = None) -> ColumnExpression:
        if chars is None:
            return _method(lambda s: s.lstrip(), str, self._e)
        return _method(lambda s, c: s.lstrip(c), str, self._e, wrap_expression(chars))

    def rstrip(self, chars: Any = None) -> ColumnExpression:
        if chars is None:
            return _method(lambda s: s.rstrip(), str, self._e)
        return _method(lambda s, c: s.rstrip(c), str, self._e, wrap_expression(chars))

    def startswith(self, prefix: Any) -> ColumnExpression:
        return _method(lambda s, p: s.startswith(p), bool, self._e, wrap_expression(prefix))

    def endswith(self, suffix: Any) -> ColumnExpression:
        return _method(lambda s, p: s.endswith(p), bool, self._e, wrap_expression(suffix))

    def swapcase(self) -> ColumnExpression:
        return _method(lambda s: s.swapcase(), str, self._e)

    def title(self) -> ColumnExpression:
        return _method(lambda s: s.title(), str, self._e)

    def count(self, sub: Any, start: Any = None, end: Any = None) -> ColumnExpression:
        return self._bounded(lambda s: s.count, int, sub, start, end)

    def _bounded(self, method_of, ret, sub: Any, start: Any, end: Any) -> ColumnExpression:
        # omitted bounds must not ride through None-propagating apply (a
        # None operand would blank the whole result): pass only given args
        args = [self._e, wrap_expression(sub)]
        if start is not None or end is not None:
            args.append(wrap_expression(0 if start is None else start))
        if end is not None:
            args.append(wrap_expression(end))
        fns = {
            2: lambda s, x: method_of(s)(x),
            3: lambda s, x, b: method_of(s)(x, b),
            4: lambda s, x, b, e: method_of(s)(x, b, e),
        }
        return _method(fns[len(args)], ret, *args)

    def find(self, sub: Any, start: Any = None, end: Any = None) -> ColumnExpression:
        return self._bounded(lambda s: s.find, int, sub, start, end)

    def rfind(self, sub: Any, start: Any = None, end: Any = None) -> ColumnExpression:
        return self._bounded(lambda s: s.rfind, int, sub, start, end)

    def replace(self, old: Any, new: Any, count: Any = -1) -> ColumnExpression:
        return _method(
            lambda s, o, n, c: s.replace(o, n, c),
            str,
            self._e,
            wrap_expression(old),
            wrap_expression(new),
            wrap_expression(count),
        )

    def split(self, sep: Any = None, maxsplit: Any = -1) -> ColumnExpression:
        if sep is None:  # whitespace split; None must not blank the row
            return _method(
                lambda s, m: tuple(s.split(None, m)),
                tuple[str, ...],
                self._e,
                wrap_expression(maxsplit),
            )
        return ApplyExpression(
            lambda s, sp, m: tuple(s.split(sp, m)),
            tuple[str, ...],
            (self._e, wrap_expression(sep), wrap_expression(maxsplit)),
            {},
            propagate_none=True,
        )

    def slice(self, start: Any, end: Any) -> ColumnExpression:
        return _method(
            lambda s, b, e: s[b:e], str, self._e, wrap_expression(start), wrap_expression(end)
        )

    def parse_int(self, optional: bool = False) -> ColumnExpression:
        def parse(s: str) -> int | None:
            try:
                return int(s)
            except (ValueError, TypeError):
                if optional:
                    return None
                raise

        return _method(parse, int | None if optional else int, self._e)

    def parse_float(self, optional: bool = False) -> ColumnExpression:
        def parse(s: str) -> float | None:
            try:
                return float(s)
            except (ValueError, TypeError):
                if optional:
                    return None
                raise

        return _method(parse, float | None if optional else float, self._e)

    def parse_bool(self, optional: bool = False) -> ColumnExpression:
        def parse(s: str) -> bool | None:
            low = s.strip().lower()
            if low in ("true", "1", "yes", "on"):
                return True
            if low in ("false", "0", "no", "off"):
                return False
            if optional:
                return None
            raise ValueError(f"cannot parse {s!r} as bool")

        return _method(parse, bool | None if optional else bool, self._e)

    def to_datetime(self, fmt: Any = None) -> ColumnExpression:
        import datetime

        def parse(s: str, f: str | None = None) -> datetime.datetime:
            if f is not None:
                return datetime.datetime.strptime(s, f)
            return datetime.datetime.fromisoformat(s)

        if fmt is None:
            return _method(parse, datetime.datetime, self._e)
        return _method(parse, datetime.datetime, self._e, wrap_expression(fmt))