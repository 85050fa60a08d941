"""A binary codec for Apache Avro and its object container files.

Counterpart of ``pathway_tpu/io/_avro.py``, byte for byte: Kafka's schema registry
frames its messages' bodies with :func:`encode` and :func:`decode`, and Iceberg's
manifests are container files. Spec: https://avro.apache.org/docs/1.11.1/specification/

Schema forms: ``"null" | "boolean" | "int" | "long" | "float" | "double" | "bytes" |
"string"``, records, arrays, maps, fixed, and unions (a value takes the first branch
it matches). The decoder is generic: a container is read with the writer schema in its
header, as any conforming Avro reader reads it.

Container layout (spec "Object Container Files"): magic ``Obj\\x01``, a metadata map
(``avro.schema`` JSON and ``avro.codec``), a random 16-byte sync marker, then blocks of
``(count, byte size, data, sync)``. Only the ``null`` codec is written or read.
"""

from __future__ import annotations

import io
import json
import os
import struct
from typing import Any, BinaryIO

MAGIC = b"Obj\x01"

# -- primitive binary encoding ------------------------------------------------


def write_long(out: io.BytesIO, n: int) -> None:
    z = (n << 1) ^ (n >> 63)  # arithmetic shift: works for negatives
    z &= (1 << 64) - 1
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out.write(bytes((b | 0x80,)))
        else:
            out.write(bytes((b,)))
            return


def read_long(buf: BinaryIO) -> int:
    shift = 0
    acc = 0
    while True:
        (b,) = buf.read(1)
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)  # un-zigzag


def write_bytes(out: io.BytesIO, data: bytes) -> None:
    write_long(out, len(data))
    out.write(data)


def read_bytes(buf: BinaryIO) -> bytes:
    n = read_long(buf)
    data = buf.read(n)
    if len(data) != n:
        raise ValueError("truncated avro bytes")
    return data


# -- schema-driven encode/decode ----------------------------------------------


def encode(out: io.BytesIO, schema: Any, value: Any) -> None:
    if isinstance(schema, str):
        kind = schema
    elif isinstance(schema, list):  # union: branch index then value
        for i, branch in enumerate(schema):
            if _matches(branch, value):
                write_long(out, i)
                encode(out, branch, value)
                return
        raise ValueError(f"value {value!r} matches no union branch {schema}")
    else:
        kind = schema["type"]
    if kind == "null":
        if value is not None:
            raise ValueError(f"non-null {value!r} for null schema")
    elif kind == "boolean":
        out.write(b"\x01" if value else b"\x00")
    elif kind in ("int", "long"):
        write_long(out, int(value))
    elif kind == "float":
        out.write(struct.pack("<f", float(value)))
    elif kind == "double":
        out.write(struct.pack("<d", float(value)))
    elif kind == "bytes":
        write_bytes(out, bytes(value))
    elif kind == "string":
        write_bytes(out, str(value).encode())
    elif kind == "fixed":
        data = bytes(value)
        if len(data) != schema["size"]:
            raise ValueError("fixed size mismatch")
        out.write(data)
    elif kind == "record":
        for field in schema["fields"]:
            fv = value.get(field["name"]) if isinstance(value, dict) else None
            if fv is None and "default" in field:
                fv = field["default"]
            encode(out, field["type"], fv)
    elif kind == "array":
        items = list(value or ())
        if items:
            write_long(out, len(items))
            for item in items:
                encode(out, schema["items"], item)
        write_long(out, 0)
    elif kind == "map":
        entries = dict(value or {})
        if entries:
            write_long(out, len(entries))
            for k, v in entries.items():
                write_bytes(out, str(k).encode())
                encode(out, schema["values"], v)
        write_long(out, 0)
    else:
        raise ValueError(f"unsupported avro schema {schema!r}")


def _matches(branch: Any, value: Any) -> bool:
    kind = branch if isinstance(branch, str) else branch["type"]
    if kind == "null":
        return value is None
    if value is None:
        return False
    if kind == "boolean":
        return isinstance(value, bool)
    if kind in ("int", "long"):
        return isinstance(value, int) and not isinstance(value, bool)
    if kind in ("float", "double"):
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if kind == "string":
        return isinstance(value, str)
    if kind in ("bytes", "fixed"):
        return isinstance(value, (bytes, bytearray))
    if kind == "record":
        return isinstance(value, dict)
    if kind == "array":
        return isinstance(value, (list, tuple))
    if kind == "map":
        return isinstance(value, dict)
    return False


def decode(buf: BinaryIO, schema: Any) -> Any:
    if isinstance(schema, str):
        kind = schema
    elif isinstance(schema, list):
        idx = read_long(buf)
        return decode(buf, schema[idx])
    else:
        kind = schema["type"]
    if kind == "null":
        return None
    if kind == "boolean":
        return buf.read(1) == b"\x01"
    if kind in ("int", "long"):
        return read_long(buf)
    if kind == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if kind == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if kind == "bytes":
        return read_bytes(buf)
    if kind == "string":
        return read_bytes(buf).decode()
    if kind == "fixed":
        return buf.read(schema["size"])
    if kind == "record":
        return {
            field["name"]: decode(buf, field["type"])
            for field in schema["fields"]
        }
    if kind == "array":
        out = []
        while True:
            n = read_long(buf)
            if n == 0:
                return out
            if n < 0:  # negative count: byte size follows (skippable form)
                read_long(buf)
                n = -n
            for _ in range(n):
                out.append(decode(buf, schema["items"]))
    if kind == "map":
        out: dict = {}
        while True:
            n = read_long(buf)
            if n == 0:
                return out
            if n < 0:
                read_long(buf)
                n = -n
            for _ in range(n):
                k = read_bytes(buf).decode()
                out[k] = decode(buf, schema["values"])
    raise ValueError(f"unsupported avro schema {schema!r}")


# -- object container files ---------------------------------------------------

_META_SCHEMA = {"type": "map", "values": "bytes"}


def write_container(
    path: str | os.PathLike,
    schema: dict,
    records: list[dict],
    metadata: dict[str, str] | None = None,
) -> None:
    """Write an Avro object container file (null codec, one block)."""
    import secrets

    sync = secrets.token_bytes(16)
    out = io.BytesIO()
    out.write(MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode(), "avro.codec": b"null"}
    for k, v in (metadata or {}).items():
        meta[k] = v.encode() if isinstance(v, str) else bytes(v)
    encode(out, _META_SCHEMA, meta)
    out.write(sync)
    block = io.BytesIO()
    for rec in records:
        encode(block, schema, rec)
    data = block.getvalue()
    write_long(out, len(records))
    write_long(out, len(data))
    out.write(data)
    out.write(sync)
    tmp = os.fspath(path) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(out.getvalue())
    os.replace(tmp, path)


def read_container(path: str | os.PathLike) -> tuple[dict, list[dict], dict]:
    """-> (writer schema, records, file metadata). Generic: decodes with
    the schema embedded in the header, like any conforming Avro reader."""
    with open(path, "rb") as f:
        raw = f.read()
    buf = io.BytesIO(raw)
    if buf.read(4) != MAGIC:
        raise ValueError(f"{path}: not an avro object container file")
    meta = decode(buf, _META_SCHEMA)
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", ""):
        raise ValueError(f"{path}: unsupported avro codec {codec!r}")
    schema = json.loads(meta["avro.schema"].decode())
    sync = buf.read(16)
    records: list[dict] = []
    while buf.tell() < len(raw):
        n = read_long(buf)
        size = read_long(buf)
        block = io.BytesIO(buf.read(size))
        for _ in range(n):
            records.append(decode(block, schema))
        if buf.read(16) != sync:
            raise ValueError(f"{path}: sync marker mismatch")
    return schema, records, {
        k: v.decode(errors="replace") for k, v in meta.items()
    }
