"""Column dtype lattice for the Python layer.

A copy of ``pathway_tpu/internals/dtype.py``: singleton dtypes plus parametric
Optional/Tuple/List/Array/Callable/Pointer wrappers, conversion from Python type
annotations, and the lattice operations (is_subclass / lca) used to type expressions.
"""

from __future__ import annotations

import datetime
import types as _types
import typing
from typing import Any, Optional, Union, get_args, get_origin

import numpy as np

from pathway_tpu_torch.engine import value as engine_value
from pathway_tpu_torch.engine.value import Json as _Json
from pathway_tpu_torch.engine.value import Pointer as _Pointer
from pathway_tpu_torch.engine.value import PyObjectWrapper as _PyObjectWrapper
from pathway_tpu_torch.engine.value import Type as EngineType


class DType:
    """Base class for column dtypes."""

    _name: str = "DType"

    def to_engine(self) -> EngineType:
        raise NotImplementedError

    @property
    def typehint(self) -> Any:
        return Any

    def is_optional(self) -> bool:
        return False

    def strip_optional(self) -> "DType":
        return self

    def __repr__(self) -> str:
        return self._name

    def __eq__(self, other: Any) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self))


class _SimpleDType(DType):
    def __init__(self, name: str, engine_type: EngineType, typehint: Any) -> None:
        self._name = name
        self._engine_type = engine_type
        self._typehint = typehint

    def to_engine(self) -> EngineType:
        return self._engine_type

    @property
    def typehint(self) -> Any:
        return self._typehint

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, _SimpleDType) and other._name == self._name

    def __hash__(self) -> int:
        return hash(self._name)


ANY = _SimpleDType("ANY", EngineType.ANY, Any)
NONE = _SimpleDType("NONE", EngineType.NONE, type(None))
BOOL = _SimpleDType("BOOL", EngineType.BOOL, bool)
INT = _SimpleDType("INT", EngineType.INT, int)
FLOAT = _SimpleDType("FLOAT", EngineType.FLOAT, float)
STR = _SimpleDType("STR", EngineType.STRING, str)
BYTES = _SimpleDType("BYTES", EngineType.BYTES, bytes)
DATE_TIME_NAIVE = _SimpleDType(
    "DATE_TIME_NAIVE", EngineType.DATE_TIME_NAIVE, datetime.datetime
)
DATE_TIME_UTC = _SimpleDType("DATE_TIME_UTC", EngineType.DATE_TIME_UTC, datetime.datetime)
DURATION = _SimpleDType("DURATION", EngineType.DURATION, datetime.timedelta)
JSON = _SimpleDType("JSON", EngineType.JSON, _Json)
PY_OBJECT_WRAPPER = _SimpleDType(
    "PY_OBJECT_WRAPPER", EngineType.PY_OBJECT_WRAPPER, _PyObjectWrapper
)


class Optional_(DType):
    def __init__(self, wrapped: DType) -> None:
        if isinstance(wrapped, Optional_):
            wrapped = wrapped.wrapped
        self.wrapped = wrapped
        self._name = f"Optional({wrapped!r})"

    def to_engine(self) -> EngineType:
        return self.wrapped.to_engine()

    @property
    def typehint(self) -> Any:
        return Optional[self.wrapped.typehint]

    def is_optional(self) -> bool:
        return True

    def strip_optional(self) -> DType:
        return self.wrapped

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Optional_) and other.wrapped == self.wrapped

    def __hash__(self) -> int:
        return hash(("Optional", self.wrapped))


class Pointer(DType):
    """Pointer dtype, optionally carrying the target schema."""

    def __init__(self, target_schema: Any = None) -> None:
        self.target_schema = target_schema
        self._name = "POINTER" if target_schema is None else f"Pointer({target_schema})"

    def to_engine(self) -> EngineType:
        return EngineType.POINTER

    @property
    def typehint(self) -> Any:
        return _Pointer

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Pointer)

    def __hash__(self) -> int:
        return hash("Pointer")


POINTER = Pointer()


class Tuple(DType):
    def __init__(self, *args: DType) -> None:
        self.args = tuple(args)
        self._name = f"Tuple{self.args!r}"

    def to_engine(self) -> EngineType:
        return EngineType.TUPLE

    @property
    def typehint(self) -> Any:
        return typing.Tuple[tuple(a.typehint for a in self.args)] if self.args else tuple

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Tuple) and other.args == self.args

    def __hash__(self) -> int:
        return hash(("Tuple", self.args))


ANY_TUPLE = Tuple()


class List(DType):
    def __init__(self, wrapped: DType = ANY) -> None:
        self.wrapped = wrapped
        self._name = f"List({wrapped!r})"

    def to_engine(self) -> EngineType:
        return EngineType.LIST

    @property
    def typehint(self) -> Any:
        return typing.List[self.wrapped.typehint]

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, List) and other.wrapped == self.wrapped

    def __hash__(self) -> int:
        return hash(("List", self.wrapped))


class Array(DType):
    """N-dimensional numeric array dtype (an ndarray on the host, a tensor on the card)."""

    def __init__(self, n_dim: int | None = None, wrapped: DType = ANY) -> None:
        self.n_dim = n_dim
        self.wrapped = wrapped
        self._name = f"Array({n_dim}, {wrapped!r})"

    def to_engine(self) -> EngineType:
        return EngineType.ARRAY

    @property
    def typehint(self) -> Any:
        return np.ndarray

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, Array)
            and other.n_dim == self.n_dim
            and other.wrapped == self.wrapped
        )

    def __hash__(self) -> int:
        return hash(("Array", self.n_dim, self.wrapped))


ANY_ARRAY = Array()


class Callable(DType):
    def __init__(self, arg_types: Any = ..., return_type: DType = ANY) -> None:
        self.arg_types = arg_types
        self.return_type = return_type
        self._name = f"Callable(..., {return_type!r})"

    def to_engine(self) -> EngineType:
        return EngineType.ANY

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Callable) and other.return_type == self.return_type

    def __hash__(self) -> int:
        return hash(("Callable", self.return_type))


class Future(DType):
    """Result of an async UDF not yet awaited (reference dtype.Future)."""

    def __init__(self, wrapped: DType) -> None:
        self.wrapped = wrapped
        self._name = f"Future({wrapped!r})"

    def to_engine(self) -> EngineType:
        return EngineType.FUTURE

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Future) and other.wrapped == self.wrapped

    def __hash__(self) -> int:
        return hash(("Future", self.wrapped))


_SIMPLE_FROM_HINT: dict[Any, DType] = {
    Any: ANY,
    type(None): NONE,
    bool: BOOL,
    int: INT,
    float: FLOAT,
    str: STR,
    bytes: BYTES,
    datetime.datetime: DATE_TIME_NAIVE,
    datetime.timedelta: DURATION,
    np.ndarray: ANY_ARRAY,
    _Json: JSON,
    dict: JSON,
    _Pointer: POINTER,
    _PyObjectWrapper: PY_OBJECT_WRAPPER,
    np.int64: INT,
    np.float64: FLOAT,
    np.bool_: BOOL,
}


def wrap(input_type: Any) -> DType:
    """Convert a Python type annotation (or DType) to a DType."""
    if isinstance(input_type, DType):
        return input_type
    if input_type in _SIMPLE_FROM_HINT:
        return _SIMPLE_FROM_HINT[input_type]
    origin = get_origin(input_type)
    if origin is Union or origin is _types.UnionType:
        args = get_args(input_type)
        non_none = [a for a in args if a is not type(None)]
        has_none = len(non_none) != len(args)
        if len(non_none) == 1:
            inner = wrap(non_none[0])
        else:
            inner = ANY
        return Optional_(inner) if has_none else inner
    if origin in (tuple, typing.Tuple):
        args = get_args(input_type)
        if not args or args[-1] is Ellipsis:
            if args:
                return List(wrap(args[0]))
            return ANY_TUPLE
        return Tuple(*[wrap(a) for a in args])
    if origin in (list, typing.List):
        args = get_args(input_type)
        return List(wrap(args[0]) if args else ANY)
    if origin is np.ndarray:
        return ANY_ARRAY
    if origin is _Pointer:
        return POINTER
    if isinstance(input_type, type):
        # Schema classes become typed pointers; other classes opaque objects
        from pathway_tpu_torch.internals import schema as schema_mod

        if issubclass(input_type, schema_mod.Schema):
            return Pointer(input_type)
        if issubclass(input_type, _Pointer):
            return POINTER
        return PY_OBJECT_WRAPPER
    return ANY


def dtype_of_value(value: Any) -> DType:
    """Runtime dtype of a concrete value."""
    et = engine_value.value_type_of(value)
    mapping = {
        engine_value.Type.NONE: NONE,
        engine_value.Type.BOOL: BOOL,
        engine_value.Type.INT: INT,
        engine_value.Type.FLOAT: FLOAT,
        engine_value.Type.POINTER: POINTER,
        engine_value.Type.STRING: STR,
        engine_value.Type.BYTES: BYTES,
        engine_value.Type.DATE_TIME_NAIVE: DATE_TIME_NAIVE,
        engine_value.Type.DATE_TIME_UTC: DATE_TIME_UTC,
        engine_value.Type.DURATION: DURATION,
        engine_value.Type.ARRAY: ANY_ARRAY,
        engine_value.Type.JSON: JSON,
        engine_value.Type.TUPLE: ANY_TUPLE,
        engine_value.Type.LIST: List(ANY),
        engine_value.Type.PY_OBJECT_WRAPPER: PY_OBJECT_WRAPPER,
    }
    return mapping.get(et, ANY)


_NUMERIC_ORDER = {BOOL: 0, INT: 1, FLOAT: 2}


def is_subclass(sub: DType, sup: DType) -> bool:
    """dtype lattice partial order."""
    if sup == ANY or sub == sup:
        return True
    if isinstance(sub, Optional_):
        return isinstance(sup, Optional_) and is_subclass(sub.wrapped, sup.wrapped)
    if isinstance(sup, Optional_):
        return sub == NONE or is_subclass(sub, sup.wrapped)
    if sub in _NUMERIC_ORDER and sup in _NUMERIC_ORDER:
        return _NUMERIC_ORDER[sub] <= _NUMERIC_ORDER[sup]
    if isinstance(sub, Tuple) and isinstance(sup, Tuple):
        if not sup.args:
            return True
        return len(sub.args) == len(sup.args) and all(
            is_subclass(a, b) for a, b in zip(sub.args, sup.args)
        )
    if isinstance(sub, Array) and isinstance(sup, Array):
        return sup.n_dim is None or sub.n_dim == sup.n_dim
    if isinstance(sub, Pointer) and isinstance(sup, Pointer):
        return True
    return False


def lca(a: DType, b: DType) -> DType:
    """Least common ancestor of two dtypes (used for if_else/concat typing)."""
    if a == b:
        return a
    if is_subclass(a, b):
        return b
    if is_subclass(b, a):
        return a
    a_opt, b_opt = a.is_optional() or a == NONE, b.is_optional() or b == NONE
    sa, sb = a.strip_optional(), b.strip_optional()
    if a == NONE:
        return Optional_(sb)
    if b == NONE:
        return Optional_(sa)
    inner: DType
    if sa in _NUMERIC_ORDER and sb in _NUMERIC_ORDER:
        inner = max(sa, sb, key=lambda d: _NUMERIC_ORDER[d])
    elif sa == sb:
        inner = sa
    else:
        inner = ANY
    if a_opt or b_opt:
        return Optional_(inner) if inner != ANY else ANY
    return inner


def normalize_value(value: Any, dtype: DType | None = None) -> Any:
    """Coerce a raw Python value to engine representation (e.g. dict→Json)."""
    if dtype is not None:
        target = dtype.strip_optional()
        if value is None:
            return None
        if target == JSON and not isinstance(value, _Json):
            return _Json(value)
        if target == FLOAT and isinstance(value, (int, np.integer)) and not isinstance(value, bool):
            return float(value)
        if target == INT and isinstance(value, np.integer):
            return int(value)
        if target == BOOL and isinstance(value, np.bool_):
            return bool(value)
        if target == STR and isinstance(value, str):
            return value
    if isinstance(value, np.integer):
        return int(value)
    if isinstance(value, np.floating):
        return float(value)
    if isinstance(value, np.bool_):
        return bool(value)
    if isinstance(value, dict):
        return _Json(value)
    return value
