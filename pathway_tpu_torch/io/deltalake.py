"""``pw.io.deltalake``: Delta Lake tables.

Counterpart of ``pathway_tpu/io/deltalake.py``: the open Delta protocol's subset the
connector needs, without the delta-rs library: parquet data files (pyarrow) and the
``_delta_log/`` JSON commit log, whose version files ``{v:020d}.json`` hold
``protocol``, ``metaData`` and ``add`` actions. :class:`DeltaWriter` appends one parquet
file and one log commit an engine commit, its rows carrying ``time`` and ``diff``
columns; it picks the next version by listing the log and publishes it with an atomic
rename, which is put-if-absent for one writer only. :class:`DeltaReader` polls the log
for new versions and reads their added files; a row with ``diff = -1`` is a retraction,
which needs the schema's primary key.
"""

from __future__ import annotations

import json
import os
import time as _time
import uuid
from typing import Any, Sequence

from pathway_tpu_torch.engine.connectors import Reader
from pathway_tpu_torch.engine.value import Json, Pointer
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._utils import attach_writer, input_table

_LOG_DIR = "_delta_log"


def _spark_type(dtype: dt.DType) -> str:
    base = dtype.strip_optional()
    if base == dt.INT:
        return "long"
    if base == dt.FLOAT:
        return "double"
    if base == dt.BOOL:
        return "boolean"
    if base == dt.BYTES:
        return "binary"
    return "string"


def _schema_string(column_names: Sequence[str], dtypes: dict) -> str:
    fields = [
        {
            "name": name,
            "type": _spark_type(dtypes.get(name, dt.STR)),
            "nullable": True,
            "metadata": {},
        }
        for name in column_names
    ]
    return json.dumps({"type": "struct", "fields": fields})


def _log_path(table_path: str, version: int) -> str:
    return os.path.join(table_path, _LOG_DIR, f"{version:020d}.json")


def _list_versions(table_path: str) -> list[int]:
    log_dir = os.path.join(table_path, _LOG_DIR)
    if not os.path.isdir(log_dir):
        return []
    out = []
    for name in os.listdir(log_dir):
        if name.endswith(".json"):
            try:
                out.append(int(name[:-5]))
            except ValueError:
                continue
    return sorted(out)


class DeltaWriter:
    """Append-only Delta writer: one parquet file + one log commit per
    engine commit (reference data_lake/writer.rs batching)."""

    def __init__(self, table_path: str, column_names: Sequence[str], dtypes: dict):
        self.table_path = os.fspath(table_path)
        self.column_names = list(column_names)
        self.dtypes = dtypes
        self._rows: list[tuple] = []
        os.makedirs(os.path.join(self.table_path, _LOG_DIR), exist_ok=True)
        if not _list_versions(self.table_path):
            self._commit(
                [
                    {"protocol": {"minReaderVersion": 1, "minWriterVersion": 2}},
                    {
                        "metaData": {
                            "id": str(uuid.uuid4()),
                            "format": {"provider": "parquet", "options": {}},
                            "schemaString": _schema_string(
                                self.column_names + ["time", "diff"],
                                {**dtypes, "time": dt.INT, "diff": dt.INT},
                            ),
                            "partitionColumns": [],
                            "configuration": {},
                            "createdTime": int(_time.time() * 1000),
                        }
                    },
                ]
            )

    def _commit(self, actions: list[dict]) -> None:
        version = (_list_versions(self.table_path) or [-1])[-1] + 1
        path = _log_path(self.table_path, version)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for action in actions:
                f.write(json.dumps(action) + "\n")
        os.replace(tmp, path)  # atomic publish, like delta's rename commit

    def on_change(self, key: Pointer, values: tuple, time: int, diff: int) -> None:
        row = tuple(
            json.dumps(v.value) if isinstance(v, Json) else v for v in values
        )
        self._rows.append(row + (time, diff))

    def on_time_end(self, time: int) -> None:
        if not self._rows:
            return
        import pyarrow as pa
        import pyarrow.parquet as pq

        names = self.column_names + ["time", "diff"]
        columns = list(zip(*self._rows))
        table = pa.table(
            {name: list(col) for name, col in zip(names, columns)}
        )
        fname = f"part-00000-{uuid.uuid4()}.parquet"
        fpath = os.path.join(self.table_path, fname)
        pq.write_table(table, fpath)
        self._rows = []
        self._commit(
            [
                {
                    "add": {
                        "path": fname,
                        "partitionValues": {},
                        "size": os.path.getsize(fpath),
                        "modificationTime": int(_time.time() * 1000),
                        "dataChange": True,
                    }
                }
            ]
        )

    def on_end(self) -> None:
        self.on_time_end(-1)


class DeltaReader(Reader):
    """Poll the Delta log; emit rows of newly-added parquet files. Rows
    written by a pathway writer carry time/diff columns — diff=-1 rows
    become retractions (the update-log round-trips)."""

    def __init__(
        self,
        table_path: str,
        column_names: Sequence[str],
        mode: str,
        key_indices: Sequence[int] | None = None,
    ):
        self.table_path = os.fspath(table_path)
        self.column_names = list(column_names)
        self.mode = mode
        self.key_indices = list(key_indices) if key_indices else None
        self._next_version = 0
        self._done_static = False

    def _events_of_file(self, fname: str):
        from pathway_tpu_torch.io._utils import lake_parquet_events

        return lake_parquet_events(
            os.path.join(self.table_path, fname),
            self.column_names,
            self.key_indices,
            "delta",
        )

    def poll(self) -> tuple[list[tuple[Any, str, dict]], bool]:
        if self._done_static:
            return [], True
        entries = []
        for version in _list_versions(self.table_path):
            if version < self._next_version:
                continue
            with open(_log_path(self.table_path, version), encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    action = json.loads(line)
                    if "add" in action:
                        fname = action["add"]["path"]
                        entries.append(
                            (
                                self._events_of_file(fname),
                                f"delta:{fname}",
                                {"path": fname},
                            )
                        )
            self._next_version = version + 1
        if self.mode == "static":
            self._done_static = True
        return entries, self.mode == "static"

    def state(self) -> dict:
        return {"next_version": self._next_version}

    def restore_state(self, state: dict) -> None:
        self._next_version = int(state.get("next_version", 0))
        self._done_static = False


def read(
    uri: str | os.PathLike,
    *,
    schema: schema_mod.SchemaMetaclass,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    persistent_id: str | None = None,
    **kwargs: Any,
) -> Table:
    from pathway_tpu_torch.engine.storage import TransparentParser

    column_names = schema.column_names()
    pk = schema.primary_key_columns()
    key_indices = [column_names.index(p) for p in pk] if pk else None
    return input_table(
        schema,
        lambda: DeltaReader(os.fspath(uri), column_names, mode, key_indices),
        lambda names: TransparentParser(names),
        source_name=f"deltalake:{uri}",
        persistent_id=persistent_id,
        autocommit_duration_ms=autocommit_duration_ms,
    )


def write(
    table: Table,
    uri: str | os.PathLike,
    *,
    min_commit_frequency: int | None = None,
    **kwargs: Any,
) -> None:
    dtypes = dict(table._dtypes)

    def make_writer(column_names):
        return DeltaWriter(os.fspath(uri), column_names, dtypes)

    attach_writer(table, make_writer)
