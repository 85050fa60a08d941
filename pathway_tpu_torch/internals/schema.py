"""`pw.Schema`: declarative table schemas.

Counterpart of ``pathway_tpu/internals/schema.py``: schemas are classes whose
annotations declare column dtypes; ``column_definition`` adds primary-key and default
metadata; ``schema_from_types``, ``schema_from_dict``, ``schema_builder`` and
``schema_from_csv`` (a header and a sample of rows) make them, and
``assert_table_has_schema`` holds a table to one.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Iterable, Mapping

from pathway_tpu_torch.internals import dtype as dt

_no_default = object()


@dataclass(frozen=True)
class ColumnDefinition:
    dtype: dt.DType = dt.ANY
    primary_key: bool = False
    default_value: Any = _no_default
    name: str | None = None
    append_only: bool | None = None

    def has_default(self) -> bool:
        return self.default_value is not _no_default


def column_definition(
    *,
    primary_key: bool = False,
    default_value: Any = _no_default,
    dtype: Any = None,
    name: str | None = None,
    append_only: bool | None = None,
) -> Any:
    """Column metadata marker used as a class attribute in a Schema."""
    return ColumnDefinition(
        dtype=dt.wrap(dtype) if dtype is not None else dt.ANY,
        primary_key=primary_key,
        default_value=default_value,
        name=name,
        append_only=append_only,
    )


class SchemaProperties:
    def __init__(self, append_only: bool = False) -> None:
        self.append_only = append_only


class SchemaMetaclass(type):
    __columns__: dict[str, ColumnDefinition]
    __properties__: SchemaProperties

    def __init__(cls, name: str, bases: tuple, namespace: dict, /, **kwargs: Any) -> None:
        super().__init__(name, bases, namespace)
        append_only = bool(kwargs.get("append_only", False))
        columns: dict[str, ColumnDefinition] = {}
        for base in reversed(bases):
            columns.update(getattr(base, "__columns__", {}))
        annotations = namespace.get("__annotations__", {})
        for col_name, annotation in annotations.items():
            if col_name.startswith("__"):
                continue
            dtype = dt.wrap(annotation)
            definition = namespace.get(col_name)
            if isinstance(definition, ColumnDefinition):
                definition = ColumnDefinition(
                    dtype=dtype if definition.dtype == dt.ANY else definition.dtype,
                    primary_key=definition.primary_key,
                    default_value=definition.default_value,
                    name=definition.name or col_name,
                    append_only=definition.append_only,
                )
            else:
                definition = ColumnDefinition(dtype=dtype, name=col_name)
            columns[definition.name or col_name] = definition
        cls.__columns__ = columns
        cls.__properties__ = SchemaProperties(append_only=append_only)

    def column_names(cls) -> list[str]:
        return list(cls.__columns__.keys())

    def columns(cls) -> Mapping[str, ColumnDefinition]:
        return dict(cls.__columns__)

    def primary_key_columns(cls) -> list[str] | None:
        pkeys = [n for n, c in cls.__columns__.items() if c.primary_key]
        return pkeys or None

    def typehints(cls) -> dict[str, Any]:
        return {n: c.dtype.typehint for n, c in cls.__columns__.items()}

    def dtypes(cls) -> dict[str, dt.DType]:
        return {n: c.dtype for n, c in cls.__columns__.items()}

    def keys(cls) -> Iterable[str]:
        return cls.__columns__.keys()

    def __getitem__(cls, name: str) -> ColumnDefinition:
        return cls.__columns__[name]

    def __or__(cls, other: "SchemaMetaclass") -> "SchemaMetaclass":
        columns = dict(cls.__columns__)
        for name, col in other.__columns__.items():
            if name in columns and columns[name].dtype != col.dtype:
                raise ValueError(f"column {name!r} has conflicting dtypes in schema union")
            columns[name] = col
        return schema_from_column_definitions(columns)

    def with_types(cls, **kwargs: Any) -> "SchemaMetaclass":
        columns = dict(cls.__columns__)
        for name, dtype in kwargs.items():
            if name not in columns:
                raise ValueError(f"column {name!r} not present in schema")
            old = columns[name]
            columns[name] = ColumnDefinition(
                dtype=dt.wrap(dtype),
                primary_key=old.primary_key,
                default_value=old.default_value,
                name=old.name,
                append_only=old.append_only,
            )
        return schema_from_column_definitions(columns)

    def without(cls, *names: str) -> "SchemaMetaclass":
        columns = {n: c for n, c in cls.__columns__.items() if n not in names}
        return schema_from_column_definitions(columns)

    def update_properties(cls, **kwargs: Any) -> "SchemaMetaclass":
        new = schema_from_column_definitions(dict(cls.__columns__))
        new.__properties__ = SchemaProperties(**kwargs)
        return new

    def __repr__(cls) -> str:
        cols = ", ".join(f"{n}: {c.dtype!r}" for n, c in cls.__columns__.items())
        return f"<pw.Schema {cls.__name__}({cols})>"


class Schema(metaclass=SchemaMetaclass):
    """Base class for user-defined schemas:

    >>> class InputSchema(pw.Schema):
    ...     name: str
    ...     age: int
    """


_schema_counter = itertools.count()


def schema_from_column_definitions(
    columns: dict[str, ColumnDefinition], name: str | None = None
) -> SchemaMetaclass:
    if name is None:
        name = f"Schema_{next(_schema_counter)}"
    cls = SchemaMetaclass(name, (Schema,), {})
    cls.__columns__ = dict(columns)
    cls.__properties__ = SchemaProperties()
    return cls


def schema_from_types(_name: str | None = None, **kwargs: Any) -> SchemaMetaclass:
    """`pw.schema_from_types(x=int, y=str)`"""
    columns = {n: ColumnDefinition(dtype=dt.wrap(t), name=n) for n, t in kwargs.items()}
    return schema_from_column_definitions(columns, name=_name)


def schema_from_dict(
    columns: Mapping[str, Any], *, name: str | None = None
) -> SchemaMetaclass:
    defs: dict[str, ColumnDefinition] = {}
    for col_name, spec in columns.items():
        if isinstance(spec, ColumnDefinition):
            defs[col_name] = spec
        elif isinstance(spec, Mapping):
            defs[col_name] = ColumnDefinition(
                dtype=dt.wrap(spec.get("dtype", Any)),
                primary_key=spec.get("primary_key", False),
                default_value=spec.get("default_value", _no_default),
                name=col_name,
            )
        else:
            defs[col_name] = ColumnDefinition(dtype=dt.wrap(spec), name=col_name)
    return schema_from_column_definitions(defs, name=name)


def schema_builder(
    columns: Mapping[str, ColumnDefinition],
    *,
    name: str | None = None,
    properties: SchemaProperties | None = None,
) -> SchemaMetaclass:
    cls = schema_from_column_definitions(dict(columns), name=name)
    if properties is not None:
        cls.__properties__ = properties
    return cls


def schema_from_csv(
    path: str,
    *,
    name: str | None = None,
    num_parsed_rows: int | None = 30,
    delimiter: str = ",",
    quote: str = '"',
    double_quote_escapes: bool = True,
) -> SchemaMetaclass:
    """Infer a schema from a CSV file's header + a sample of rows
    (reference schema_from_csv): int ⊂ float ⊂ str by widening."""
    import csv as _csv

    def classify(text: str) -> type:
        try:
            int(text)
            return int
        except ValueError:
            pass
        try:
            float(text)
            return float
        except ValueError:
            return str

    with open(path, newline="", encoding="utf-8") as f:
        reader = _csv.reader(
            f,
            delimiter=delimiter,
            quotechar=quote,
            doublequote=double_quote_escapes,
        )
        header = next(reader, None)
        if header is None:
            raise ValueError(f"schema_from_csv: {path!r} is empty (no header)")
        if len(set(header)) != len(header):
            dupes = sorted({h for h in header if header.count(h) > 1})
            raise ValueError(
                f"schema_from_csv: duplicate column names {dupes}"
            )
        kinds: dict[str, type | None] = {h: None for h in header}
        for i, row in enumerate(reader):
            if num_parsed_rows is not None and i >= num_parsed_rows:
                break
            for h, cell in zip(header, row):
                k = classify(cell)
                prev = kinds[h]
                if prev is None or prev is k:
                    kinds[h] = k
                elif {prev, k} == {int, float}:
                    kinds[h] = float
                else:
                    kinds[h] = str
    return schema_from_types(
        name, **{h: (k or str) for h, k in kinds.items()}
    )


def assert_table_has_schema(
    table: Any,
    schema: SchemaMetaclass,
    *,
    allow_superset: bool = False,
    ignore_primary_keys: bool = True,
) -> None:
    """Raise AssertionError unless the table's columns (and dtypes) match
    the schema (reference pw.assert_table_has_schema)."""
    table_types = {n: table._dtypes[n] for n in table.column_names()}
    wanted = dict(schema.dtypes())
    if not ignore_primary_keys:
        table_pk = set(table.schema.primary_key_columns() or [])
        schema_pk = set(schema.primary_key_columns() or [])
        if table_pk != schema_pk:
            raise AssertionError(
                f"primary keys differ: table {sorted(table_pk)} vs schema "
                f"{sorted(schema_pk)}"
            )
    if allow_superset:
        missing = [n for n in wanted if n not in table_types]
        if missing:
            raise AssertionError(
                f"table lacks columns required by the schema: {missing}"
            )
        compare = {n: table_types[n] for n in wanted}
    else:
        if set(table_types) != set(wanted):
            raise AssertionError(
                f"column sets differ: table {sorted(table_types)} vs "
                f"schema {sorted(wanted)}"
            )
        compare = table_types
    for n, dtype in compare.items():
        if dtype != wanted[n] and wanted[n] != dt.ANY and dtype != dt.ANY:
            raise AssertionError(
                f"column {n!r}: table dtype {dtype!r} != schema {wanted[n]!r}"
            )
