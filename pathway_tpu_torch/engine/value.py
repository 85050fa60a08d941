"""Engine values: row keys, the error sentinel, and the stable hash behind keys.

Counterpart of ``pathway_tpu/engine/value.py``, its pure-Python digest path: keys are
128-bit ints from a BLAKE2b-128 of a deterministic serialization of the values, equal
bit for bit to the JAX package's keys for the same values (the C++ host kernels there
are held to this Python path, so it is the spec). ``ERROR`` is a poisoning sentinel that
propagates through expressions instead of raising.
"""

from __future__ import annotations

import datetime
import enum
import hashlib
import json as _json
import math
import struct
from typing import Any, Iterable

import numpy as np

__all__ = [
    "ERROR",
    "Error",
    "Json",
    "Pointer",
    "PyObjectWrapper",
    "Type",
    "hash_values",
    "is_error",
    "ref_scalar",
    "rows_differ",
    "unsafe_make_pointer",
    "value_type_of",
]


class Type(enum.Enum):
    """Engine column types (reference: src/engine/value.rs:507)."""

    ANY = "Any"
    NONE = "None"
    BOOL = "Bool"
    INT = "Int"
    FLOAT = "Float"
    POINTER = "Pointer"
    STRING = "String"
    BYTES = "Bytes"
    DATE_TIME_NAIVE = "DateTimeNaive"
    DATE_TIME_UTC = "DateTimeUtc"
    DURATION = "Duration"
    ARRAY = "Array"
    JSON = "Json"
    TUPLE = "Tuple"
    LIST = "List"
    PY_OBJECT_WRAPPER = "PyObjectWrapper"
    FUTURE = "Future"

    def __repr__(self) -> str:
        return f"Type.{self.name}"


class Error:
    """Singleton poisoning sentinel (reference: Value::Error, src/engine/value.rs:228).

    Any expression evaluated over an ``ERROR`` operand yields ``ERROR`` rather
    than raising; rows carrying errors are routed to error logs and can be
    filtered with ``remove_errors``.
    """

    _instance: "Error | None" = None

    def __new__(cls) -> "Error":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "Error"

    def __bool__(self) -> bool:
        raise ValueError("cannot convert error value to bool")

    def __hash__(self) -> int:
        return 0x9E3779B97F4A7C15

    def __reduce__(self):
        return (Error, ())


ERROR = Error()


def is_error(value: Any) -> bool:
    return value is ERROR or isinstance(value, Error)


class Pointer(int):
    """A 128-bit row key (reference: Key(u128), src/engine/value.rs:41).

    Subclasses ``int`` so it hashes/compares natively; rendering is the
    compact ``^BASE32``-style form used in printed tables.
    """

    __slots__ = ()

    _ALPHABET = "0123456789ABCDEFGHIJKLMNOPQRSTUV"

    def __new__(cls, value: int) -> "Pointer":
        return super().__new__(cls, int(value) & ((1 << 128) - 1))

    def shard(self, nshards: int) -> int:
        """Shard routing: high 64 bits modulo shard count (data parallelism)."""
        return (int(self) >> 64) % nshards

    def __repr__(self) -> str:
        n = int(self)
        if n == 0:
            return "^0"
        digits = []
        while n:
            digits.append(self._ALPHABET[n & 31])
            n >>= 5
        return "^" + "".join(reversed(digits))

    __str__ = __repr__


class Json:
    """JSON value wrapper (reference: Value::Json)."""

    __slots__ = ("value",)

    def __init__(self, value: Any) -> None:
        if isinstance(value, Json):
            value = value.value
        self.value = value

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, Json):
            return self.value == other.value
        return self.value == other

    def __hash__(self) -> int:
        return hash(_json.dumps(self.value, sort_keys=True, default=str))

    def __repr__(self) -> str:
        return _json.dumps(self.value, default=str)

    def as_int(self) -> int | None:
        return int(self.value) if isinstance(self.value, (int, float)) else None

    def as_float(self) -> float | None:
        return float(self.value) if isinstance(self.value, (int, float)) else None

    def as_str(self) -> str | None:
        return self.value if isinstance(self.value, str) else None

    def as_bool(self) -> bool | None:
        return self.value if isinstance(self.value, bool) else None

    def as_list(self) -> list | None:
        return self.value if isinstance(self.value, list) else None

    def as_dict(self) -> dict | None:
        return self.value if isinstance(self.value, dict) else None

    def __getitem__(self, item: Any) -> "Json":
        return Json(self.value[item])

    def get(self, item: Any, default: Any = None) -> "Json | None":
        if isinstance(self.value, dict):
            got = self.value.get(item, _SENTINEL)
            if got is _SENTINEL:
                return default
            return Json(got)
        if isinstance(self.value, list) and isinstance(item, int):
            if -len(self.value) <= item < len(self.value):
                return Json(self.value[item])
            return default
        return default

    def __len__(self) -> int:
        return len(self.value)

    def __iter__(self):
        for item in self.value:
            yield Json(item)


_SENTINEL = object()


class PyObjectWrapper:
    """Opaque Python object carried through the engine (Value::PyObjectWrapper)."""

    __slots__ = ("value", "_serializer")

    def __init__(self, value: Any, *, serializer: Any = None) -> None:
        self.value = value
        self._serializer = serializer

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, PyObjectWrapper) and self.value == other.value

    def __hash__(self) -> int:
        try:
            return hash(self.value)
        except TypeError:
            return id(self.value)

    def __repr__(self) -> str:
        return f"pw.wrap_py_object({self.value!r})"


# Date/time: thin aliases over stdlib types. Naive vs UTC is tracked at the
# dtype level (reference keeps separate Value variants, src/engine/time.rs).
DateTimeNaive = datetime.datetime
DateTimeUtc = datetime.datetime
Duration = datetime.timedelta


# ---------------------------------------------------------------------------
# Stable hashing → 128-bit keys
# ---------------------------------------------------------------------------

_H_NONE = b"\x00"
_H_BOOL = b"\x01"
_H_INT = b"\x02"
_H_FLOAT = b"\x03"
_H_POINTER = b"\x04"
_H_STRING = b"\x05"
_H_BYTES = b"\x06"
_H_TUPLE = b"\x07"
_H_ARRAY = b"\x08"
_H_DT = b"\x09"
_H_DUR = b"\x0a"
_H_JSON = b"\x0b"
_H_PYOBJ = b"\x0c"
_H_ERROR = b"\x0d"


def _feed(h: "hashlib._Hash", value: Any) -> None:
    if value is None:
        h.update(_H_NONE)
    elif isinstance(value, Error):
        h.update(_H_ERROR)
    elif isinstance(value, Pointer):
        h.update(_H_POINTER)
        h.update(int(value).to_bytes(16, "little"))
    elif isinstance(value, bool):
        h.update(_H_BOOL)
        h.update(b"\x01" if value else b"\x00")
    elif isinstance(value, (int, np.integer)):
        h.update(_H_INT)
        h.update(int(value).to_bytes(16, "little", signed=True))
    elif isinstance(value, (float, np.floating)):
        f = float(value)
        if math.isnan(f) or math.isinf(f):
            h.update(_H_FLOAT)
            h.update(struct.pack("<d", f))
        elif abs(f) < 2**63 and f == int(f):
            # ints and equal floats hash alike, matching engine semantics
            h.update(_H_INT)
            h.update(int(f).to_bytes(16, "little", signed=True))
        else:
            h.update(_H_FLOAT)
            h.update(struct.pack("<d", f))
    elif isinstance(value, str):
        b = value.encode()
        h.update(_H_STRING)
        h.update(len(b).to_bytes(8, "little"))
        h.update(b)
    elif isinstance(value, bytes):
        h.update(_H_BYTES)
        h.update(len(value).to_bytes(8, "little"))
        h.update(value)
    elif isinstance(value, tuple) or isinstance(value, list):
        h.update(_H_TUPLE)
        h.update(len(value).to_bytes(8, "little"))
        for item in value:
            _feed(h, item)
    elif isinstance(value, np.ndarray):
        h.update(_H_ARRAY)
        h.update(str(value.dtype).encode())
        h.update(str(value.shape).encode())
        h.update(np.ascontiguousarray(value).tobytes())
    elif isinstance(value, datetime.datetime):
        h.update(_H_DT)
        h.update(value.isoformat().encode())
    elif isinstance(value, datetime.timedelta):
        h.update(_H_DUR)
        h.update(struct.pack("<q", round(value.total_seconds() * 1_000_000_000)))
    elif isinstance(value, Json):
        h.update(_H_JSON)
        h.update(_json.dumps(value.value, sort_keys=True, default=str).encode())
    elif isinstance(value, PyObjectWrapper):
        h.update(_H_PYOBJ)
        _feed(h, repr(value.value))
    else:
        h.update(_H_PYOBJ)
        _feed(h, repr(value))


#: pre-personalized hasher, cloned per digest — blake2b parameter-block
#: construction costs more than copy(), and every key derivation pays it
_BASE_HASHER = hashlib.blake2b(digest_size=16, person=b"pw-tpu-key")


def _digest16(values: Iterable[Any], salt: bytes) -> bytes:
    """The 16-byte little-endian digest behind :func:`hash_values`.

    Digest-identical fast path: common scalar types append to one buffer
    flushed in a single ``update`` (join/groupby key derivation calls this
    per output row — the per-value ``_feed`` dispatch dominated join time).
    """
    h = _BASE_HASHER.copy()
    buf = bytearray(salt)
    for value in values:
        t = type(value)
        if t is Pointer:
            buf += _H_POINTER
            buf += int.to_bytes(value, 16, "little")
        elif t is int:
            buf += _H_INT
            buf += value.to_bytes(16, "little", signed=True)
        elif t is str:
            b = value.encode()
            buf += _H_STRING
            buf += len(b).to_bytes(8, "little")
            buf += b
        elif t is bool:
            buf += _H_BOOL
            buf += b"\x01" if value else b"\x00"
        elif t is float:
            if math.isnan(value) or math.isinf(value):
                buf += _H_FLOAT
                buf += struct.pack("<d", value)
            elif abs(value) < 2**63 and value == int(value):
                buf += _H_INT
                buf += int(value).to_bytes(16, "little", signed=True)
            else:
                buf += _H_FLOAT
                buf += struct.pack("<d", value)
        else:
            if buf:
                h.update(bytes(buf))
                buf.clear()
            _feed(h, value)
    if buf:
        h.update(bytes(buf))
    return h.digest()


def hash_values(values: Iterable[Any], *, salt: bytes = b"") -> Pointer:
    """Stable 128-bit key from a sequence of values (Key::for_values analog)."""
    return Pointer(int.from_bytes(_digest16(values, salt), "little"))


def ref_scalar(*values: Any, instance: Any = None) -> Pointer:
    """Derive a pointer from scalar values (python_api.rs ref_scalar :3373)."""
    if instance is not None:
        return hash_values(tuple(values) + (instance,), salt=b"inst")
    return hash_values(values)


def unsafe_make_pointer(value: int) -> Pointer:
    """A pointer with the given 128-bit value, unhashed."""
    return Pointer(value)


def value_type_of(value: Any) -> Type:
    """Runtime type tag of a value."""
    if value is None:
        return Type.NONE
    if isinstance(value, Error):
        return Type.ANY
    if isinstance(value, Pointer):
        return Type.POINTER
    if isinstance(value, bool) or isinstance(value, np.bool_):
        return Type.BOOL
    if isinstance(value, (int, np.integer)):
        return Type.INT
    if isinstance(value, (float, np.floating)):
        return Type.FLOAT
    if isinstance(value, str):
        return Type.STRING
    if isinstance(value, bytes):
        return Type.BYTES
    if isinstance(value, datetime.datetime):
        return Type.DATE_TIME_UTC if value.tzinfo is not None else Type.DATE_TIME_NAIVE
    if isinstance(value, datetime.timedelta):
        return Type.DURATION
    if isinstance(value, np.ndarray):
        return Type.ARRAY
    if isinstance(value, Json):
        return Type.JSON
    if isinstance(value, tuple):
        return Type.TUPLE
    if isinstance(value, list):
        return Type.LIST
    if isinstance(value, PyObjectWrapper):
        return Type.PY_OBJECT_WRAPPER
    return Type.ANY


def rows_differ(a: "tuple | None", b: "tuple | None") -> bool:
    """Row inequality that tolerates numpy-array cells (plain ``!=`` raises
    'truth value is ambiguous' on arrays). None = absent row. The common
    all-scalar row stays on the C tuple compare; only rows actually holding
    arrays take the per-cell path."""
    if a is b:
        return False
    if a is None or b is None:
        return True
    try:
        return a != b
    except ValueError:  # some cell is a numpy array
        pass
    if len(a) != len(b):
        return True
    for x, y in zip(a, b):
        if x is y:
            continue
        try:
            if x != y:
                return True
        except ValueError:  # numpy broadcast comparison
            import numpy as np

            if not np.array_equal(x, y):
                return True
    return False
