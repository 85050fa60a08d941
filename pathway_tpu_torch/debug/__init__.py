"""Debug and notebook helpers: static tables from markdown, rows or pandas, and a
table's final state as dicts, a DataFrame or printed rows.

Counterpart of ``pathway_tpu/debug/__init__.py``; its ``StreamGenerator`` and
``compute_and_print_update_stream`` are not ported yet (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import re
from typing import Any, Iterable, Sequence

from pathway_tpu_torch.engine.value import Pointer, ref_scalar, unsafe_make_pointer
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.runner import GraphRunner
from pathway_tpu_torch.internals.table import Table


def _parse_value(text: str) -> Any:
    text = text.strip()
    if text in ("", "None"):
        return None
    if text == "True":
        return True
    if text == "False":
        return False
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    return text


def table_from_markdown(
    table_def: str,
    *,
    id_from: Sequence[str] | None = None,
    schema: schema_mod.SchemaMetaclass | None = None,
    **kwargs: Any,
) -> Table:
    """Build a static table from a markdown/whitespace definition:

    >>> t = pw.debug.table_from_markdown('''
    ...    | name  | age
    ...  1 | Alice | 10
    ...  2 | Bob   | 9
    ... ''')

    The optional first unnamed column gives explicit row ids.
    """
    lines = [ln for ln in table_def.strip().splitlines() if ln.strip() and not set(ln.strip()) <= {"-", "|", " ", "+"}]
    if not lines:
        raise ValueError("empty table definition")

    def split(line: str) -> list[str]:
        if "|" in line:
            parts = [p.strip() for p in line.split("|")]
        else:
            parts = re.split(r"\s+", line.strip())
        return parts

    header = split(lines[0])
    has_leading_id = header and header[0] == ""
    if has_leading_id:
        header = header[1:]
    col_names = [h for h in header if h]

    rows: list[tuple] = []
    keys: list[Pointer] = []
    for ln in lines[1:]:
        parts = split(ln)
        if has_leading_id:
            key_text, parts = parts[0], parts[1:]
            keys.append(ref_scalar(_parse_value(key_text)))
        parts = parts[: len(col_names)] + [""] * (len(col_names) - len(parts))
        rows.append(tuple(_parse_value(p) for p in parts[: len(col_names)]))

    if schema is None:
        dtypes: dict[str, dt.DType] = {}
        for i, name in enumerate(col_names):
            col_dtype: dt.DType | None = None
            saw_none = False
            for row in rows:
                v = row[i]
                if v is None:
                    saw_none = True
                    continue
                vd = dt.dtype_of_value(v)
                col_dtype = vd if col_dtype is None else dt.lca(col_dtype, vd)
            if col_dtype is None:
                col_dtype = dt.ANY
            elif saw_none:
                col_dtype = dt.Optional_(col_dtype)
            dtypes[name] = col_dtype
        schema = schema_mod.schema_from_dict(dtypes)
    else:
        schema_dtypes = schema.dtypes()
        rows = [
            tuple(
                dt.normalize_value(v, schema_dtypes[n])
                for v, n in zip(row, col_names)
            )
            for row in rows
        ]

    return Table.from_rows(
        rows, schema, keys=keys if has_leading_id else None
    )


# reference alias
T = table_from_markdown


def table_from_rows(
    schema: schema_mod.SchemaMetaclass,
    rows: Iterable[tuple],
    **kwargs: Any,
) -> Table:
    return Table.from_rows(list(rows), schema)


def table_from_pandas(df: Any, *, id_from: Sequence[str] | None = None, **kwargs: Any) -> Table:
    col_names = list(df.columns)
    dtypes: dict[str, dt.DType] = {}
    for name in col_names:
        kind = df[name].dtype.kind
        if kind in "iu":
            dtypes[name] = dt.INT
        elif kind == "f":
            dtypes[name] = dt.FLOAT
        elif kind == "b":
            dtypes[name] = dt.BOOL
        else:
            dtypes[name] = dt.ANY
    schema = schema_mod.schema_from_dict(dtypes)
    rows = [tuple(df[c].iloc[i] for c in col_names) for i in range(len(df))]
    keys = None
    if id_from is not None:
        keys = [
            ref_scalar(*[df[c].iloc[i] for c in id_from]) for i in range(len(df))
        ]
    else:
        keys = [unsafe_make_pointer(int(k)) if isinstance(k, (int,)) else ref_scalar(k)
                for k in df.index]
    return Table.from_rows(rows, schema, keys=keys)


def table_to_dicts(table: Table) -> tuple[dict[Pointer, dict[str, Any]], list[str]]:
    runner = GraphRunner()
    (snapshot,) = runner.capture(table)
    names = table.column_names()
    return (
        {key: dict(zip(names, row)) for key, row in snapshot.items()},
        names,
    )


def table_to_pandas(table: Table) -> Any:
    import pandas as pd

    data, names = table_to_dicts(table)
    index = list(data.keys())
    return pd.DataFrame(
        {n: [data[k][n] for k in index] for n in names}, index=index
    )


def compute_and_print(
    table: Table,
    *,
    include_id: bool = True,
    short_pointers: bool = True,
    n_rows: int | None = None,
    **kwargs: Any,
) -> None:
    data, names = table_to_dicts(table)
    header = (["id"] if include_id else []) + names
    rows = []
    for key in sorted(data.keys(), key=int):
        row = data[key]
        cells = ([repr(key)] if include_id else []) + [
            repr(row[n]) for n in names
        ]
        rows.append(cells)
    if n_rows is not None:
        rows = rows[:n_rows]
    widths = [
        max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
        for i, h in enumerate(header)
    ]
    print(" | ".join(h.ljust(w) for h, w in zip(header, widths)))
    for cells in rows:
        print(" | ".join(c.ljust(w) for c, w in zip(cells, widths)))
