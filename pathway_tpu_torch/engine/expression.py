"""Interpreted engine expression trees.

A copy of ``pathway_tpu/engine/expression.py``: the Python API lowers its
``ColumnExpression`` DSL to these nodes, evaluated per row. Any failing operation or
``ERROR`` operand yields ``ERROR`` and reports the failure to the scope's error log
instead of raising. The columnar NumPy evaluator over the same trees
(``engine/device.py::eval_columnar``) computes the same rows for large insert-only
batches.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np

from pathway_tpu_torch.engine.value import ERROR, Error, Json, Pointer, is_error, ref_scalar


class EvalContext:
    """Per-batch evaluation context: collects row-level errors."""

    __slots__ = ("errors",)

    def __init__(self) -> None:
        self.errors: list[tuple[Pointer, str]] = []

    def report(self, key: Pointer, message: str) -> Any:
        self.errors.append((key, message))
        return ERROR


class EngineExpression:
    """Base class; subclasses implement ``evaluate(key, row, ctx)``."""

    __slots__ = ()

    def evaluate(self, key: Pointer, row: tuple, ctx: EvalContext) -> Any:
        raise NotImplementedError


class ColumnRef(EngineExpression):
    __slots__ = ("index",)

    def __init__(self, index: int) -> None:
        self.index = index

    def evaluate(self, key: Pointer, row: tuple, ctx: EvalContext) -> Any:
        return row[self.index]

    def __repr__(self) -> str:
        return f"col[{self.index}]"


class KeyRef(EngineExpression):
    """The row id (``table.id``)."""

    __slots__ = ()

    def evaluate(self, key: Pointer, row: tuple, ctx: EvalContext) -> Any:
        return key


class Const(EngineExpression):
    __slots__ = ("value",)

    def __init__(self, value: Any) -> None:
        self.value = value

    def evaluate(self, key: Pointer, row: tuple, ctx: EvalContext) -> Any:
        return self.value

    def __repr__(self) -> str:
        return f"const({self.value!r})"


def _div(a: Any, b: Any) -> Any:
    return a / b


def _floordiv(a: Any, b: Any) -> Any:
    return a // b


def _matmul(a: Any, b: Any) -> Any:
    return np.matmul(a, b)


_BINARY_OPS: dict[str, Callable[[Any, Any], Any]] = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": _div,
    "//": _floordiv,
    "%": lambda a, b: a % b,
    "**": lambda a, b: a**b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "&": lambda a, b: a & b,
    "|": lambda a, b: a | b,
    "^": lambda a, b: a ^ b,
    "<<": lambda a, b: a << b,
    ">>": lambda a, b: a >> b,
    "@": _matmul,
}

_NONE_SAFE_OPS = {"==", "!="}


class Binary(EngineExpression):
    __slots__ = ("op", "left", "right", "fn")

    def __init__(self, op: str, left: EngineExpression, right: EngineExpression) -> None:
        self.op = op
        self.left = left
        self.right = right
        self.fn = _BINARY_OPS[op]

    def evaluate(self, key: Pointer, row: tuple, ctx: EvalContext) -> Any:
        a = self.left.evaluate(key, row, ctx)
        b = self.right.evaluate(key, row, ctx)
        if is_error(a) or is_error(b):
            return ERROR
        if (a is None or b is None) and self.op not in _NONE_SAFE_OPS:
            return ctx.report(key, f"cannot apply {self.op} to None operand")
        try:
            return self.fn(a, b)
        except Exception as e:  # noqa: BLE001 — poisoned, not raised
            return ctx.report(key, f"{type(e).__name__} in {self.op}: {e}")

    def __repr__(self) -> str:
        return f"({self.left!r} {self.op} {self.right!r})"


_UNARY_OPS: dict[str, Callable[[Any], Any]] = {
    "-": lambda a: -a,
    "~": lambda a: ~a,
    "not": lambda a: not a,
    "abs": abs,
}


class Unary(EngineExpression):
    __slots__ = ("op", "arg", "fn")

    def __init__(self, op: str, arg: EngineExpression) -> None:
        self.op = op
        self.arg = arg
        self.fn = _UNARY_OPS[op]

    def evaluate(self, key: Pointer, row: tuple, ctx: EvalContext) -> Any:
        a = self.arg.evaluate(key, row, ctx)
        if is_error(a):
            return ERROR
        if a is None:
            return ctx.report(key, f"cannot apply unary {self.op} to None")
        try:
            return self.fn(a)
        except Exception as e:  # noqa: BLE001
            return ctx.report(key, f"{type(e).__name__} in unary {self.op}: {e}")


class BooleanChain(EngineExpression):
    """Short-circuit ``&``/``|`` over boolean columns."""

    __slots__ = ("op", "args")

    def __init__(self, op: str, args: Sequence[EngineExpression]) -> None:
        assert op in ("and", "or")
        self.op = op
        self.args = list(args)

    def evaluate(self, key: Pointer, row: tuple, ctx: EvalContext) -> Any:
        saw_error = False
        for arg in self.args:
            v = arg.evaluate(key, row, ctx)
            if is_error(v):
                saw_error = True
                continue
            if self.op == "and" and not v:
                return False
            if self.op == "or" and v:
                return True
        if saw_error:
            return ERROR
        return self.op == "and"


class IfElse(EngineExpression):
    __slots__ = ("cond", "then", "otherwise")

    def __init__(
        self, cond: EngineExpression, then: EngineExpression, otherwise: EngineExpression
    ) -> None:
        self.cond = cond
        self.then = then
        self.otherwise = otherwise

    def evaluate(self, key: Pointer, row: tuple, ctx: EvalContext) -> Any:
        c = self.cond.evaluate(key, row, ctx)
        if is_error(c):
            return ERROR
        if c is None:
            return ctx.report(key, "if_else condition is None")
        return (self.then if c else self.otherwise).evaluate(key, row, ctx)


class IsNone(EngineExpression):
    __slots__ = ("arg", "negated")

    def __init__(self, arg: EngineExpression, negated: bool = False) -> None:
        self.arg = arg
        self.negated = negated

    def evaluate(self, key: Pointer, row: tuple, ctx: EvalContext) -> Any:
        v = self.arg.evaluate(key, row, ctx)
        if is_error(v):
            return ERROR
        return (v is not None) if self.negated else (v is None)


class Coalesce(EngineExpression):
    __slots__ = ("args",)

    def __init__(self, args: Sequence[EngineExpression]) -> None:
        self.args = list(args)

    def evaluate(self, key: Pointer, row: tuple, ctx: EvalContext) -> Any:
        for arg in self.args:
            v = arg.evaluate(key, row, ctx)
            if is_error(v):
                return ERROR
            if v is not None:
                return v
        return None


class Require(EngineExpression):
    """``pw.require(val, *deps)`` — None if any dep is None."""

    __slots__ = ("value", "deps")

    def __init__(self, value: EngineExpression, deps: Sequence[EngineExpression]) -> None:
        self.value = value
        self.deps = list(deps)

    def evaluate(self, key: Pointer, row: tuple, ctx: EvalContext) -> Any:
        for dep in self.deps:
            v = dep.evaluate(key, row, ctx)
            if is_error(v):
                return ERROR
            if v is None:
                return None
        return self.value.evaluate(key, row, ctx)


class MakeTuple(EngineExpression):
    __slots__ = ("args",)

    def __init__(self, args: Sequence[EngineExpression]) -> None:
        self.args = list(args)

    def evaluate(self, key: Pointer, row: tuple, ctx: EvalContext) -> Any:
        out = []
        for arg in self.args:
            v = arg.evaluate(key, row, ctx)
            if is_error(v):
                return ERROR
            out.append(v)
        return tuple(out)


class SequenceGet(EngineExpression):
    __slots__ = ("arg", "index", "default", "checked")

    def __init__(
        self,
        arg: EngineExpression,
        index: EngineExpression,
        default: EngineExpression | None,
        checked: bool,
    ) -> None:
        self.arg = arg
        self.index = index
        self.default = default
        self.checked = checked

    def evaluate(self, key: Pointer, row: tuple, ctx: EvalContext) -> Any:
        seq = self.arg.evaluate(key, row, ctx)
        idx = self.index.evaluate(key, row, ctx)
        if is_error(seq) or is_error(idx):
            return ERROR
        try:
            if isinstance(seq, Json):
                got = seq.get(idx, _MISSING)
                if got is _MISSING:
                    raise KeyError(idx)
                return got
            return seq[idx]
        except Exception as e:  # noqa: BLE001
            if self.checked:
                return (
                    self.default.evaluate(key, row, ctx)
                    if self.default is not None
                    else None
                )
            return ctx.report(key, f"index error: {e}")


_MISSING = object()


class JsonGet(EngineExpression):
    """``col.get("field")`` / ``col["field"]`` over Json values."""

    __slots__ = ("arg", "index", "default", "checked")

    def __init__(
        self,
        arg: EngineExpression,
        index: EngineExpression,
        default: EngineExpression | None = None,
        checked: bool = True,
    ) -> None:
        self.arg = arg
        self.index = index
        self.default = default
        self.checked = checked

    def evaluate(self, key: Pointer, row: tuple, ctx: EvalContext) -> Any:
        val = self.arg.evaluate(key, row, ctx)
        idx = self.index.evaluate(key, row, ctx)
        if is_error(val) or is_error(idx):
            return ERROR
        if not isinstance(val, Json):
            val = Json(val)
        got = val.get(idx, _MISSING)
        if got is _MISSING:
            if self.checked:
                return (
                    self.default.evaluate(key, row, ctx)
                    if self.default is not None
                    else None
                )
            return ctx.report(key, f"json key {idx!r} not found")
        return got


class Cast(EngineExpression):
    __slots__ = ("arg", "target")

    _CASTS: dict[str, Callable[[Any], Any]] = {
        "Int": int,
        "Float": float,
        "Bool": bool,
        "String": str,
    }

    def __init__(self, arg: EngineExpression, target: str) -> None:
        self.arg = arg
        self.target = target

    def evaluate(self, key: Pointer, row: tuple, ctx: EvalContext) -> Any:
        v = self.arg.evaluate(key, row, ctx)
        if is_error(v):
            return ERROR
        if v is None:
            return None
        try:
            return self._CASTS[self.target](v)
        except Exception as e:  # noqa: BLE001
            return ctx.report(key, f"cannot cast {v!r} to {self.target}: {e}")


class Convert(EngineExpression):
    """Json → typed value conversion (``.as_int()`` etc.)."""

    __slots__ = ("arg", "target", "unwrap")

    def __init__(self, arg: EngineExpression, target: str, unwrap: bool = False) -> None:
        self.arg = arg
        self.target = target
        self.unwrap = unwrap

    def evaluate(self, key: Pointer, row: tuple, ctx: EvalContext) -> Any:
        v = self.arg.evaluate(key, row, ctx)
        if is_error(v):
            return ERROR
        if v is None:
            return None
        if not isinstance(v, Json):
            v = Json(v)
        inner = v.value
        ok: Any = None
        if self.target == "Int" and isinstance(inner, (int, float)) and not isinstance(inner, bool):
            ok = int(inner)
        elif self.target == "Float" and isinstance(inner, (int, float)) and not isinstance(inner, bool):
            ok = float(inner)
        elif self.target == "Bool" and isinstance(inner, bool):
            ok = inner
        elif self.target == "String" and isinstance(inner, str):
            ok = inner
        elif self.target == "List" and isinstance(inner, list):
            ok = tuple(inner)
        if ok is None and not (inner is None and not self.unwrap):
            return ctx.report(key, f"cannot convert json {inner!r} to {self.target}")
        return ok


class Unwrap(EngineExpression):
    __slots__ = ("arg",)

    def __init__(self, arg: EngineExpression) -> None:
        self.arg = arg

    def evaluate(self, key: Pointer, row: tuple, ctx: EvalContext) -> Any:
        v = self.arg.evaluate(key, row, ctx)
        if is_error(v):
            return ERROR
        if v is None:
            return ctx.report(key, "unwrap() on None value")
        return v


class FillError(EngineExpression):
    """``pw.fill_error(expr, fallback)`` (reference: expression.rs FillError)."""

    __slots__ = ("arg", "fallback")

    def __init__(self, arg: EngineExpression, fallback: EngineExpression) -> None:
        self.arg = arg
        self.fallback = fallback

    def evaluate(self, key: Pointer, row: tuple, ctx: EvalContext) -> Any:
        # evaluate in a throwaway context: errors here are being handled
        sub = EvalContext()
        v = self.arg.evaluate(key, row, sub)
        if is_error(v):
            return self.fallback.evaluate(key, row, ctx)
        return v


class Apply(EngineExpression):
    """Python function escape hatch (AnyExpression::Apply, expression.rs:325)."""

    __slots__ = ("fn", "args", "propagate_none", "deterministic")

    def __init__(
        self,
        fn: Callable[..., Any],
        args: Sequence[EngineExpression],
        propagate_none: bool = False,
        deterministic: bool = True,
    ) -> None:
        self.fn = fn
        self.args = list(args)
        self.propagate_none = propagate_none
        self.deterministic = deterministic

    def evaluate(self, key: Pointer, row: tuple, ctx: EvalContext) -> Any:
        vals = []
        for arg in self.args:
            v = arg.evaluate(key, row, ctx)
            if is_error(v):
                return ERROR
            if v is None and self.propagate_none:
                return None
            vals.append(v)
        try:
            return self.fn(*vals)
        except Exception as e:  # noqa: BLE001
            return ctx.report(key, f"{type(e).__name__} in apply: {e}")


class PointerFrom(EngineExpression):
    """``table.pointer_from(*cols, instance=...)``."""

    __slots__ = ("args", "instance")

    def __init__(
        self, args: Sequence[EngineExpression], instance: EngineExpression | None = None
    ) -> None:
        self.args = list(args)
        self.instance = instance

    def evaluate(self, key: Pointer, row: tuple, ctx: EvalContext) -> Any:
        vals = []
        for arg in self.args:
            v = arg.evaluate(key, row, ctx)
            if is_error(v):
                return ERROR
            vals.append(v)
        inst = None
        if self.instance is not None:
            inst = self.instance.evaluate(key, row, ctx)
            if is_error(inst):
                return ERROR
        return ref_scalar(*vals, instance=inst)


def evaluate_expressions(
    expressions: Sequence[EngineExpression],
    key: Pointer,
    row: tuple,
    ctx: EvalContext,
) -> tuple:
    return tuple(expr.evaluate(key, row, ctx) for expr in expressions)
