"""``pw.io.csv``: ``pw.io.fs`` with the csv format (counterpart of
``pathway_tpu/io/csv.py``)."""

from __future__ import annotations

import os
from typing import Any

from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import fs as _fs


class CsvParserSettings:
    def __init__(self, delimiter: str = ",", **kwargs: Any) -> None:
        self.delimiter = delimiter


def read(
    path: str | os.PathLike,
    *,
    schema: schema_mod.SchemaMetaclass | None = None,
    mode: str = "streaming",
    csv_settings: CsvParserSettings | None = None,
    with_metadata: bool = False,
    **kwargs: Any,
) -> Table:
    return _fs.read(
        path,
        format="csv",
        schema=schema,
        mode=mode,
        csv_settings=csv_settings,
        with_metadata=with_metadata,
        **kwargs,
    )


def write(table: Table, filename: str | os.PathLike, **kwargs: Any) -> None:
    _fs.write(table, filename, format="csv", **kwargs)
