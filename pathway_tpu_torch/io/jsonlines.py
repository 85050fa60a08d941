"""``pw.io.jsonlines``: ``pw.io.fs`` with the JSON-lines format (counterpart of
``pathway_tpu/io/jsonlines.py``)."""

from __future__ import annotations

import os
from typing import Any

from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io import fs as _fs


def read(
    path: str | os.PathLike,
    *,
    schema: schema_mod.SchemaMetaclass | None = None,
    mode: str = "streaming",
    with_metadata: bool = False,
    **kwargs: Any,
) -> Table:
    return _fs.read(path, format="json", schema=schema, mode=mode, with_metadata=with_metadata, **kwargs)


def write(table: Table, filename: str | os.PathLike, **kwargs: Any) -> None:
    _fs.write(table, filename, format="json", **kwargs)
