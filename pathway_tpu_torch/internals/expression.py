"""User-facing column expression DSL.

Counterpart of ``pathway_tpu/internals/expression.py``: overloaded operators build a
tree of :class:`ColumnExpression` nodes that the graph runner compiles to engine
expressions (:mod:`pathway_tpu_torch.engine.expression`). ``pw.this`` placeholders are
resolved eagerly at the call site (``table.select(x=pw.this.a)``). Reducer calls
(``pw.reducers.*``) are :class:`ReducerExpression` nodes inside ``.reduce(...)``. The
``.dt``, ``.str`` and ``.num`` properties give the method namespaces of
:mod:`pathway_tpu_torch.internals.expressions`; ``apply_async`` runs a function on the
async UDF executor.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Iterable

from pathway_tpu_torch.internals import dtype as dt

if TYPE_CHECKING:
    from pathway_tpu_torch.internals.table import Table


class ColumnExpression:
    """Base class for all column expressions."""

    _dtype: dt.DType = dt.ANY

    # -- operator overloads -------------------------------------------------

    def _bin(self, op: str, other: Any, reverse: bool = False) -> "BinaryOpExpression":
        other = wrap_expression(other)
        if reverse:
            return BinaryOpExpression(op, other, self)
        return BinaryOpExpression(op, self, other)

    def __add__(self, other: Any) -> "ColumnExpression":
        return self._bin("+", other)

    def __radd__(self, other: Any) -> "ColumnExpression":
        return self._bin("+", other, reverse=True)

    def __sub__(self, other: Any) -> "ColumnExpression":
        return self._bin("-", other)

    def __rsub__(self, other: Any) -> "ColumnExpression":
        return self._bin("-", other, reverse=True)

    def __mul__(self, other: Any) -> "ColumnExpression":
        return self._bin("*", other)

    def __rmul__(self, other: Any) -> "ColumnExpression":
        return self._bin("*", other, reverse=True)

    def __truediv__(self, other: Any) -> "ColumnExpression":
        return self._bin("/", other)

    def __rtruediv__(self, other: Any) -> "ColumnExpression":
        return self._bin("/", other, reverse=True)

    def __floordiv__(self, other: Any) -> "ColumnExpression":
        return self._bin("//", other)

    def __rfloordiv__(self, other: Any) -> "ColumnExpression":
        return self._bin("//", other, reverse=True)

    def __mod__(self, other: Any) -> "ColumnExpression":
        return self._bin("%", other)

    def __rmod__(self, other: Any) -> "ColumnExpression":
        return self._bin("%", other, reverse=True)

    def __pow__(self, other: Any) -> "ColumnExpression":
        return self._bin("**", other)

    def __rpow__(self, other: Any) -> "ColumnExpression":
        return self._bin("**", other, reverse=True)

    def __matmul__(self, other: Any) -> "ColumnExpression":
        return self._bin("@", other)

    def __eq__(self, other: Any) -> "ColumnExpression":  # type: ignore[override]
        return self._bin("==", other)

    def __ne__(self, other: Any) -> "ColumnExpression":  # type: ignore[override]
        return self._bin("!=", other)

    def __lt__(self, other: Any) -> "ColumnExpression":
        return self._bin("<", other)

    def __le__(self, other: Any) -> "ColumnExpression":
        return self._bin("<=", other)

    def __gt__(self, other: Any) -> "ColumnExpression":
        return self._bin(">", other)

    def __ge__(self, other: Any) -> "ColumnExpression":
        return self._bin(">=", other)

    def __and__(self, other: Any) -> "ColumnExpression":
        return BooleanExpression("and", [self, wrap_expression(other)])

    def __rand__(self, other: Any) -> "ColumnExpression":
        return BooleanExpression("and", [wrap_expression(other), self])

    def __or__(self, other: Any) -> "ColumnExpression":
        return BooleanExpression("or", [wrap_expression(other), self]) if not isinstance(other, ColumnExpression) else BooleanExpression("or", [self, wrap_expression(other)])

    def __ror__(self, other: Any) -> "ColumnExpression":
        return BooleanExpression("or", [wrap_expression(other), self])

    def __xor__(self, other: Any) -> "ColumnExpression":
        return self._bin("^", other)

    def __neg__(self) -> "ColumnExpression":
        return UnaryOpExpression("-", self)

    def __invert__(self) -> "ColumnExpression":
        return UnaryOpExpression("not", self)

    def __abs__(self) -> "ColumnExpression":
        return UnaryOpExpression("abs", self)

    def __hash__(self) -> int:
        return id(self)

    def __bool__(self) -> bool:
        raise RuntimeError(
            "a ColumnExpression is not a bool; use &, |, ~ instead of and/or/not"
        )

    # -- methods ------------------------------------------------------------

    def is_none(self) -> "ColumnExpression":
        return IsNoneExpression(self, negated=False)

    def is_not_none(self) -> "ColumnExpression":
        return IsNoneExpression(self, negated=True)

    def __getitem__(self, index: Any) -> "ColumnExpression":
        return GetExpression(self, wrap_expression(index), default=None, checked=False)

    def get(self, index: Any, default: Any = None) -> "ColumnExpression":
        return GetExpression(
            self, wrap_expression(index), default=wrap_expression(default), checked=True
        )

    def as_int(self, unwrap: bool = False) -> "ColumnExpression":
        return ConvertExpression(self, "Int", unwrap)

    def as_float(self, unwrap: bool = False) -> "ColumnExpression":
        return ConvertExpression(self, "Float", unwrap)

    def as_str(self, unwrap: bool = False) -> "ColumnExpression":
        return ConvertExpression(self, "String", unwrap)

    def as_bool(self, unwrap: bool = False) -> "ColumnExpression":
        return ConvertExpression(self, "Bool", unwrap)

    def to_string(self) -> "ColumnExpression":
        return CastExpression(self, dt.STR)

    @property
    def dt(self) -> Any:
        from pathway_tpu_torch.internals.expressions.date_time import DateTimeNamespace

        return DateTimeNamespace(self)

    @property
    def str(self) -> Any:
        from pathway_tpu_torch.internals.expressions.string import StringNamespace

        return StringNamespace(self)

    @property
    def num(self) -> Any:
        from pathway_tpu_torch.internals.expressions.numerical import NumericalNamespace

        return NumericalNamespace(self)

    def _dependencies(self) -> "Iterable[ColumnReference]":
        """All ColumnReferences in this tree."""
        for child in self._children():
            yield from child._dependencies()

    def _children(self) -> "Iterable[ColumnExpression]":
        return ()


class ColumnConstExpression(ColumnExpression):
    def __init__(self, value: Any) -> None:
        self._value = dt.normalize_value(value)
        self._dtype = dt.dtype_of_value(self._value)

    def __repr__(self) -> str:
        return f"{self._value!r}"


class ColumnReference(ColumnExpression):
    """A reference to a column of a concrete table (``t.colname`` / ``t.id``)."""

    def __init__(self, table: "Table", name: str) -> None:
        self._table = table
        self._name = name
        if name == "id":
            self._dtype = dt.Pointer()
        else:
            self._dtype = table._dtypes.get(name, dt.ANY)

    @property
    def table(self) -> "Table":
        return self._table

    @property
    def name(self) -> str:
        return self._name

    def _dependencies(self) -> Iterable["ColumnReference"]:
        yield self

    def __repr__(self) -> str:
        return f"<{self._table._name}>.{self._name}"


class BinaryOpExpression(ColumnExpression):
    _COMPARISONS = {"==", "!=", "<", "<=", ">", ">="}

    def __init__(self, op: str, left: ColumnExpression, right: ColumnExpression) -> None:
        self._op = op
        self._left = left
        self._right = right
        if op in self._COMPARISONS:
            self._dtype = dt.BOOL
        elif op == "/":
            self._dtype = dt.FLOAT if left._dtype.strip_optional() in (dt.INT, dt.FLOAT, dt.BOOL) else dt.ANY
        else:
            self._dtype = dt.lca(left._dtype, right._dtype)

    def _children(self) -> Iterable[ColumnExpression]:
        return (self._left, self._right)

    def __repr__(self) -> str:
        return f"({self._left!r} {self._op} {self._right!r})"


class UnaryOpExpression(ColumnExpression):
    def __init__(self, op: str, arg: ColumnExpression) -> None:
        self._op = op
        self._arg = arg
        self._dtype = dt.BOOL if op == "not" else arg._dtype

    def _children(self) -> Iterable[ColumnExpression]:
        return (self._arg,)


class BooleanExpression(ColumnExpression):
    _dtype = dt.BOOL

    def __init__(self, op: str, args: list[ColumnExpression]) -> None:
        # flatten nested chains of the same op
        flat: list[ColumnExpression] = []
        for a in args:
            if isinstance(a, BooleanExpression) and a._op == op:
                flat.extend(a._args)
            else:
                flat.append(a)
        self._op = op
        self._args = flat

    def _children(self) -> Iterable[ColumnExpression]:
        return tuple(self._args)


class IsNoneExpression(ColumnExpression):
    _dtype = dt.BOOL

    def __init__(self, arg: ColumnExpression, negated: bool) -> None:
        self._arg = arg
        self._negated = negated

    def _children(self) -> Iterable[ColumnExpression]:
        return (self._arg,)


class IfElseExpression(ColumnExpression):
    def __init__(
        self,
        cond: ColumnExpression,
        then: ColumnExpression,
        otherwise: ColumnExpression,
    ) -> None:
        self._cond = cond
        self._then = then
        self._otherwise = otherwise
        self._dtype = dt.lca(then._dtype, otherwise._dtype)

    def _children(self) -> Iterable[ColumnExpression]:
        return (self._cond, self._then, self._otherwise)


class CoalesceExpression(ColumnExpression):
    def __init__(self, args: list[ColumnExpression]) -> None:
        self._args = args
        dtype = args[0]._dtype
        for a in args[1:]:
            dtype = dt.lca(dtype, a._dtype)
        self._dtype = dtype.strip_optional() if len(args) > 1 and args[-1]._dtype == dt.NONE is False else dtype

    def _children(self) -> Iterable[ColumnExpression]:
        return tuple(self._args)


class RequireExpression(ColumnExpression):
    def __init__(self, value: ColumnExpression, deps: list[ColumnExpression]) -> None:
        self._value = value
        self._deps = deps
        self._dtype = dt.Optional_(value._dtype.strip_optional())

    def _children(self) -> Iterable[ColumnExpression]:
        return (self._value, *self._deps)


class ApplyExpression(ColumnExpression):
    def __init__(
        self,
        fn: Callable[..., Any],
        return_type: Any,
        args: tuple,
        kwargs: dict,
        *,
        propagate_none: bool = False,
        deterministic: bool = True,
    ) -> None:
        self._fn = fn
        self._args = [wrap_expression(a) for a in args]
        self._kwargs = {k: wrap_expression(v) for k, v in kwargs.items()}
        self._dtype = dt.wrap(return_type) if return_type is not None else dt.ANY
        self._propagate_none = propagate_none
        self._deterministic = deterministic

    def _children(self) -> Iterable[ColumnExpression]:
        return (*self._args, *self._kwargs.values())


class BatchApplyExpression(ColumnExpression):
    """A UDF call executed by the engine in commit-batches (BatchApplyNode).

    ``rows_fn`` is ``UDF.execute_rows``: list of arg tuples in, list of
    (ok, value) out. Must appear as a top-level select expression.
    """

    def __init__(
        self,
        rows_fn: Callable[[list], list],
        return_type: Any,
        args: tuple,
        kwargs: dict,
        *,
        propagate_none: bool = False,
        deterministic: bool = False,
        name: str = "udf",
    ) -> None:
        self._rows_fn = rows_fn
        self._args = [wrap_expression(a) for a in args]
        self._kwargs = {k: wrap_expression(v) for k, v in kwargs.items()}
        self._dtype = dt.wrap(return_type) if return_type is not None else dt.ANY
        self._propagate_none = propagate_none
        self._deterministic = deterministic
        self._name = name

    def _children(self) -> Iterable[ColumnExpression]:
        return (*self._args, *self._kwargs.values())


class CastExpression(ColumnExpression):
    def __init__(self, arg: ColumnExpression, target: Any) -> None:
        self._arg = arg
        self._dtype = dt.wrap(target)

    def _children(self) -> Iterable[ColumnExpression]:
        return (self._arg,)


class DeclareTypeExpression(ColumnExpression):
    def __init__(self, arg: ColumnExpression, target: Any) -> None:
        self._arg = arg
        self._dtype = dt.wrap(target)

    def _children(self) -> Iterable[ColumnExpression]:
        return (self._arg,)


class ConvertExpression(ColumnExpression):
    def __init__(self, arg: ColumnExpression, target: str, unwrap: bool = False) -> None:
        self._arg = arg
        self._target = target
        self._unwrap = unwrap
        mapping = {"Int": dt.INT, "Float": dt.FLOAT, "Bool": dt.BOOL, "String": dt.STR}
        base = mapping.get(target, dt.ANY)
        self._dtype = base if unwrap else dt.Optional_(base)

    def _children(self) -> Iterable[ColumnExpression]:
        return (self._arg,)


class UnwrapExpression(ColumnExpression):
    def __init__(self, arg: ColumnExpression) -> None:
        self._arg = arg
        self._dtype = arg._dtype.strip_optional()

    def _children(self) -> Iterable[ColumnExpression]:
        return (self._arg,)


class FillErrorExpression(ColumnExpression):
    def __init__(self, arg: ColumnExpression, fallback: ColumnExpression) -> None:
        self._arg = arg
        self._fallback = fallback
        self._dtype = dt.lca(arg._dtype, fallback._dtype)

    def _children(self) -> Iterable[ColumnExpression]:
        return (self._arg, self._fallback)


class MakeTupleExpression(ColumnExpression):
    def __init__(self, args: list[ColumnExpression]) -> None:
        self._args = args
        self._dtype = dt.Tuple(*[a._dtype for a in args])

    def _children(self) -> Iterable[ColumnExpression]:
        return tuple(self._args)


class GetExpression(ColumnExpression):
    def __init__(
        self,
        arg: ColumnExpression,
        index: ColumnExpression,
        default: ColumnExpression | None,
        checked: bool,
    ) -> None:
        self._arg = arg
        self._index = index
        self._default = default
        self._checked = checked
        base = arg._dtype.strip_optional()
        if base == dt.JSON:
            self._dtype = dt.Optional_(dt.JSON) if checked else dt.JSON
        elif isinstance(base, dt.List):
            self._dtype = base.wrapped
        else:
            self._dtype = dt.ANY

    def _children(self) -> Iterable[ColumnExpression]:
        children = [self._arg, self._index]
        if self._default is not None:
            children.append(self._default)
        return tuple(children)


class PointerExpression(ColumnExpression):
    """``table.pointer_from(*exprs)``."""

    def __init__(
        self,
        args: list[ColumnExpression],
        instance: ColumnExpression | None = None,
        target: Any = None,
    ) -> None:
        self._args = args
        self._instance = instance
        self._dtype = dt.Pointer(target)

    def _children(self) -> Iterable[ColumnExpression]:
        if self._instance is not None:
            return (*self._args, self._instance)
        return tuple(self._args)


class ReducerExpression(ColumnExpression):
    """A reducer call inside ``.reduce(...)`` (pw.reducers.*)."""

    def __init__(self, kind: Any, args: list[ColumnExpression], **options: Any) -> None:
        from pathway_tpu_torch.engine.reducers import ReducerKind

        self._kind: ReducerKind = kind
        self._args = args
        self._options = options
        if kind in (ReducerKind.COUNT, ReducerKind.COUNT_DISTINCT):
            self._dtype = dt.INT
        elif kind in (ReducerKind.ARG_MIN, ReducerKind.ARG_MAX):
            self._dtype = dt.Pointer()
        elif args:
            self._dtype = args[0]._dtype
        else:
            self._dtype = dt.ANY

    def _children(self) -> Iterable[ColumnExpression]:
        return tuple(self._args)


def wrap_expression(value: Any) -> ColumnExpression:
    if isinstance(value, ColumnExpression):
        return value
    return ColumnConstExpression(value)


# -- module-level constructors (exported as pw.*) ---------------------------


def if_else(cond: Any, then: Any, otherwise: Any) -> ColumnExpression:
    return IfElseExpression(
        wrap_expression(cond), wrap_expression(then), wrap_expression(otherwise)
    )


def coalesce(*args: Any) -> ColumnExpression:
    return CoalesceExpression([wrap_expression(a) for a in args])


def require(value: Any, *deps: Any) -> ColumnExpression:
    return RequireExpression(wrap_expression(value), [wrap_expression(d) for d in deps])


def apply(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> ColumnExpression:
    return ApplyExpression(fn, None, args, kwargs)


def apply_with_type(
    fn: Callable[..., Any], ret_type: Any, *args: Any, **kwargs: Any
) -> ColumnExpression:
    return ApplyExpression(fn, ret_type, args, kwargs)


def cast(target: Any, expr: Any) -> ColumnExpression:
    return CastExpression(wrap_expression(expr), target)


def declare_type(target: Any, expr: Any) -> ColumnExpression:
    return DeclareTypeExpression(wrap_expression(expr), target)


def unwrap(expr: Any) -> ColumnExpression:
    return UnwrapExpression(wrap_expression(expr))


def fill_error(expr: Any, fallback: Any) -> ColumnExpression:
    return FillErrorExpression(wrap_expression(expr), wrap_expression(fallback))


def make_tuple(*args: Any) -> ColumnExpression:
    return MakeTupleExpression([wrap_expression(a) for a in args])


def apply_async(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> ColumnExpression:
    """Apply ``fn`` to each row on the async UDF executor (a plain function is wrapped
    in a coroutine), lowered to the engine's batch-apply node."""
    import inspect

    from pathway_tpu_torch.internals.udfs import UDF
    from pathway_tpu_torch.internals.udfs.executors import AsyncExecutor

    if not inspect.iscoroutinefunction(fn):
        sync_fn = fn

        async def async_fn(*a: Any, **kw: Any) -> Any:
            return sync_fn(*a, **kw)

        fn = async_fn
    return UDF(fn, executor=AsyncExecutor())(*args, **kwargs)
