"""``pw.io.iceberg``: Apache Iceberg tables, read and written.

Counterpart of ``pathway_tpu/io/iceberg.py``: the Iceberg table layout (format version
2) without an Iceberg or Avro library, under one of two catalogs:

- :class:`FilesystemCatalog` (hadoop-style, ``warehouse/namespace/table``): the table's
  ``metadata/vN.metadata.json`` files and ``version-hint.text``; a commit publishes
  version N+1 with an exclusive create (a hard link), so a writer that lost the race
  raises ``FileExistsError`` and never overwrites another's snapshot;
- :class:`RestCatalog`: the metadata lives in a REST catalog service
  (``io/_iceberg_rest.py``) and a commit is a CommitTableRequest that asserts the
  table's uuid and the ``main`` ref's snapshot; a stale snapshot gets 409, which raises
  on the writer, whose rows stay queued for its next commit.

:class:`IcebergWriter` writes one parquet data file (pyarrow) and one snapshot an engine
commit: a manifest and a manifest list, Avro object container files with the spec's
record schemas and field ids (``io/_avro.py``), each with a ``.json`` twin; the rows
carry ``time`` and ``diff`` columns. :class:`IcebergReader` reads the current snapshot
once (``mode="static"``) or polls the catalog and reads the data files that each new
snapshot added, in sequence-number order, each snapshot once; a row with ``diff = -1``
is a retraction (``io/_utils.py::lake_parquet_events``), which needs the schema's
primary key. Its offset, the last sequence number read, is its persistence state.
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

_METADATA = "metadata"
_DATA = "data"
_VERSION_HINT = "version-hint.text"


def _iceberg_type(dtype: dt.DType) -> str:
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


def _schema_json(column_names: Sequence[str], dtypes: dict) -> dict:
    fields = [
        {
            "id": i + 1,
            "name": name,
            "required": False,
            "type": _iceberg_type(dtypes.get(name, dt.STR)),
        }
        for i, name in enumerate(column_names)
    ]
    return {"type": "struct", "schema-id": 0, "fields": fields}


def _is_rest_uri(catalog_uri: str | os.PathLike) -> bool:
    uri = os.fspath(catalog_uri)
    return isinstance(uri, str) and uri.split("://", 1)[0] in (
        "http",
        "https",
    )


def _check_local(catalog_uri: str | os.PathLike) -> str:
    uri = os.fspath(catalog_uri)
    if isinstance(uri, str) and "://" in uri:
        scheme = uri.split("://", 1)[0]
        if scheme != "file":
            # http(s) goes through the REST catalog path; other object-
            # store warehouses (s3/gs/abfs/...) need services this build
            # cannot reach — refuse rather than silently writing to a
            # local dir named "s3:"
            raise NotImplementedError(
                f"pw.io.iceberg speaks the filesystem (hadoop-style) "
                f"catalog or an http(s) REST catalog; {scheme}:// "
                f"locations are unreachable from this build"
            )
        uri = uri[len("file://"):]
    return uri


def table_location(
    catalog_uri: str | os.PathLike,
    namespace: Sequence[str],
    table_name: str,
) -> str:
    """warehouse root + namespace path + table name -> table directory."""
    return os.path.join(_check_local(catalog_uri), *namespace, table_name)


def _metadata_path(loc: str, version: int) -> str:
    return os.path.join(loc, _METADATA, f"v{version}.metadata.json")


def _current_version(loc: str) -> int | None:
    hint = os.path.join(loc, _METADATA, _VERSION_HINT)
    try:
        with open(hint, encoding="utf-8") as f:
            return int(f.read().strip())
    except FileNotFoundError:
        return None  # no table yet


def _read_metadata(loc: str, version: int) -> dict:
    with open(_metadata_path(loc, version), encoding="utf-8") as f:
        return json.load(f)


def _atomic_write(path: str, payload: str, exclusive: bool = False) -> None:
    """Write-new-then-rename. ``exclusive=True`` is the hadoop catalog
    commit: publishing an existing version must FAIL (hard-link then
    unlink raises FileExistsError) so concurrent writers can't silently
    clobber each other's snapshots."""
    tmp = path + f".tmp-{uuid.uuid4()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(payload)
    if exclusive:
        try:
            os.link(tmp, path)
        finally:
            os.unlink(tmp)
    else:
        os.replace(tmp, path)


# -- Avro manifests (Iceberg spec, format v2) --------------------------------
#
# Manifest lists and manifests are Avro object container files with the
# spec's field-ids, written via the from-scratch codec in io/_avro.py
# (no Avro library in this environment). A ``.json`` debug twin is kept
# beside each for transparency.

_FIELD_SUMMARY_SCHEMA = {
    "type": "record",
    "name": "r508",
    "fields": [
        {"name": "contains_null", "type": "boolean", "field-id": 509},
        {
            "name": "contains_nan",
            "type": ["null", "boolean"],
            "field-id": 518,
        },
        {"name": "lower_bound", "type": ["null", "bytes"], "field-id": 510},
        {"name": "upper_bound", "type": ["null", "bytes"], "field-id": 511},
    ],
}

MANIFEST_FILE_SCHEMA = {
    "type": "record",
    "name": "manifest_file",
    "fields": [
        {"name": "manifest_path", "type": "string", "field-id": 500},
        {"name": "manifest_length", "type": "long", "field-id": 501},
        {"name": "partition_spec_id", "type": "int", "field-id": 502},
        {"name": "content", "type": "int", "field-id": 517},
        {"name": "sequence_number", "type": "long", "field-id": 515},
        {"name": "min_sequence_number", "type": "long", "field-id": 516},
        {"name": "added_snapshot_id", "type": "long", "field-id": 503},
        {"name": "added_files_count", "type": "int", "field-id": 504},
        {"name": "existing_files_count", "type": "int", "field-id": 505},
        {"name": "deleted_files_count", "type": "int", "field-id": 506},
        {"name": "added_rows_count", "type": "long", "field-id": 512},
        {"name": "existing_rows_count", "type": "long", "field-id": 513},
        {"name": "deleted_rows_count", "type": "long", "field-id": 514},
        {
            "name": "partitions",
            "type": ["null", {"type": "array", "items": _FIELD_SUMMARY_SCHEMA}],
            "field-id": 507,
        },
    ],
}

MANIFEST_ENTRY_SCHEMA = {
    "type": "record",
    "name": "manifest_entry",
    "fields": [
        {"name": "status", "type": "int", "field-id": 0},
        {"name": "snapshot_id", "type": ["null", "long"], "field-id": 1},
        {
            "name": "sequence_number",
            "type": ["null", "long"],
            "field-id": 3,
        },
        {
            "name": "file_sequence_number",
            "type": ["null", "long"],
            "field-id": 4,
        },
        {
            "name": "data_file",
            "field-id": 2,
            "type": {
                "type": "record",
                "name": "r2",
                "fields": [
                    {"name": "content", "type": "int", "field-id": 134},
                    {"name": "file_path", "type": "string", "field-id": 100},
                    {
                        "name": "file_format",
                        "type": "string",
                        "field-id": 101,
                    },
                    {
                        "name": "partition",
                        "field-id": 102,
                        "type": {
                            "type": "record",
                            "name": "r102",
                            "fields": [],  # unpartitioned spec
                        },
                    },
                    {"name": "record_count", "type": "long", "field-id": 103},
                    {
                        "name": "file_size_in_bytes",
                        "type": "long",
                        "field-id": 104,
                    },
                ],
            },
        },
    ],
}


def _write_manifest(
    path: str, entries: list[dict], table_schema: dict
) -> None:
    from pathway_tpu_torch.io import _avro

    _avro.write_container(
        path,
        MANIFEST_ENTRY_SCHEMA,
        entries,
        metadata={
            "schema": json.dumps(table_schema),
            "schema-id": "0",
            "partition-spec": "[]",
            "partition-spec-id": "0",
            "format-version": "2",
            "content": "data",
        },
    )
    _atomic_write(path + ".json", json.dumps({"entries": entries}, indent=1))


def _write_manifest_list(
    path: str, manifests: list[dict], *, snapshot_id: int, sequence_number: int
) -> None:
    from pathway_tpu_torch.io import _avro

    _avro.write_container(
        path,
        MANIFEST_FILE_SCHEMA,
        manifests,
        metadata={
            "snapshot-id": str(snapshot_id),
            "sequence-number": str(sequence_number),
            "format-version": "2",
        },
    )
    _atomic_write(
        path + ".json", json.dumps({"manifests": manifests}, indent=1)
    )


def _read_manifest_list(path: str) -> list[dict]:
    """Avro manifest list -> entries; pre-Avro (JSON) tables still read
    AND append: legacy entries are normalized to the full v2 field set so
    carrying them into the next snapshot's Avro list encodes cleanly."""
    if path.endswith(".json"):
        with open(path, encoding="utf-8") as f:
            entries = json.load(f)["manifests"]
        base = os.path.dirname(os.path.dirname(path))  # table location
        out = []
        for e in entries:
            mpath = os.path.join(base, e["manifest_path"])
            seq = e.get("sequence_number", 0)
            out.append(
                {
                    "manifest_path": e["manifest_path"],
                    "manifest_length": e.get(
                        "manifest_length",
                        os.path.getsize(mpath) if os.path.exists(mpath) else 0,
                    ),
                    "partition_spec_id": e.get("partition_spec_id", 0),
                    "content": e.get("content", 0),
                    "sequence_number": seq,
                    "min_sequence_number": e.get("min_sequence_number", seq),
                    "added_snapshot_id": e["added_snapshot_id"],
                    "added_files_count": e.get("added_files_count", 0),
                    "existing_files_count": e.get("existing_files_count", 0),
                    "deleted_files_count": e.get("deleted_files_count", 0),
                    "added_rows_count": e.get("added_rows_count", 0),
                    "existing_rows_count": e.get("existing_rows_count", 0),
                    "deleted_rows_count": e.get("deleted_rows_count", 0),
                    "partitions": e.get("partitions", []),
                }
            )
        return out
    from pathway_tpu_torch.io import _avro

    _schema, records, _meta = _avro.read_container(path)
    return records


def _read_manifest(path: str) -> list[dict]:
    if path.endswith(".json"):
        with open(path, encoding="utf-8") as f:
            return json.load(f)["entries"]
    from pathway_tpu_torch.io import _avro

    _schema, records, _meta = _avro.read_container(path)
    return records


class FilesystemCatalog:
    """Hadoop-style catalog: the table's metadata directory IS the
    catalog; commits publish vN+1 with an exclusive create."""

    def __init__(self, location: str) -> None:
        self.location = os.fspath(location)

    def ensure(self, column_names: Sequence[str], dtypes: dict) -> str:
        os.makedirs(os.path.join(self.location, _METADATA), exist_ok=True)
        os.makedirs(os.path.join(self.location, _DATA), exist_ok=True)
        if _current_version(self.location) is None:
            metadata = {
                "format-version": 2,
                "table-uuid": str(uuid.uuid4()),
                "location": self.location,
                "last-sequence-number": 0,
                "last-updated-ms": int(_time.time() * 1000),
                "last-column-id": len(column_names) + 2,
                "current-schema-id": 0,
                "schemas": [
                    _schema_json(
                        list(column_names) + ["time", "diff"],
                        {**dtypes, "time": dt.INT, "diff": dt.INT},
                    )
                ],
                "default-spec-id": 0,
                "partition-specs": [{"spec-id": 0, "fields": []}],
                "last-partition-id": 999,
                "default-sort-order-id": 0,
                "sort-orders": [{"order-id": 0, "fields": []}],
                "properties": {},
                "current-snapshot-id": -1,
                "snapshots": [],
                "snapshot-log": [],
                "metadata-log": [],
            }
            self.commit(0, metadata)
        return self.location

    def load(self) -> tuple[Any, dict | None]:
        version = _current_version(self.location)
        if version is None:
            return None, None
        return version, _read_metadata(self.location, version)

    def commit(self, token: Any, metadata: dict) -> None:
        version = int(token) + 1
        _atomic_write(
            _metadata_path(self.location, version),
            json.dumps(metadata, indent=1),
            exclusive=True,  # lose the race -> raise, never clobber
        )
        _atomic_write(
            os.path.join(self.location, _METADATA, _VERSION_HINT),
            str(version),
        )


class RestCatalog:
    """REST catalog (reference: src/connectors/data_lake/iceberg.rs):
    metadata lives in the catalog service, reached through
    io/_iceberg_rest.py's client; data/manifest files live at the
    table's ``location``. Commits send the spec's CommitTableRequest
    (assert-table-uuid + assert-ref-snapshot-id requirements,
    add-snapshot + set-snapshot-ref updates) — a stale snapshot gets
    409 and the engine retries the batch, mirroring the filesystem
    catalog's exclusive-create race."""

    def __init__(
        self,
        uri: str,
        namespace: Sequence[str],
        table_name: str,
        *,
        token: str | None = None,
    ) -> None:
        from pathway_tpu_torch.io._iceberg_rest import RestCatalogClient

        self.client = RestCatalogClient(uri, token=token)
        self.namespace = list(namespace)
        self.table_name = table_name
        self.location: str | None = None

    def ensure(self, column_names: Sequence[str], dtypes: dict) -> str:
        from pathway_tpu_torch.io._iceberg_rest import IcebergRestError

        loaded = self.client.load_table(self.namespace, self.table_name)
        if loaded is None:
            self.client.create_namespace(self.namespace)
            try:
                loaded = self.client.create_table(
                    self.namespace,
                    self.table_name,
                    _schema_json(
                        list(column_names) + ["time", "diff"],
                        {**dtypes, "time": dt.INT, "diff": dt.INT},
                    ),
                )
            except IcebergRestError as exc:
                if exc.code != 409:
                    raise
                # lost the create race: the table exists now — use it
                loaded = self.client.load_table(
                    self.namespace, self.table_name
                )
                if loaded is None:
                    raise
        self.location = loaded["metadata"]["location"]
        return self.location

    def load(self) -> tuple[Any, dict | None]:
        loaded = self.client.load_table(self.namespace, self.table_name)
        if loaded is None:
            return None, None
        meta = loaded["metadata"]
        self.location = meta["location"]
        head = meta.get("refs", {}).get("main", {}).get("snapshot-id")
        return (meta["table-uuid"], head), meta

    def commit(self, token: Any, metadata: dict) -> None:
        table_uuid, head = token
        snapshot = metadata["snapshots"][-1]
        self.client.commit_table(
            self.namespace,
            self.table_name,
            requirements=[
                {"type": "assert-table-uuid", "uuid": table_uuid},
                {
                    "type": "assert-ref-snapshot-id",
                    "ref": "main",
                    "snapshot-id": head,
                },
            ],
            updates=[
                {"action": "add-snapshot", "snapshot": snapshot},
                {
                    "action": "set-snapshot-ref",
                    "ref-name": "main",
                    "type": "branch",
                    "snapshot-id": snapshot["snapshot-id"],
                },
            ],
        )


class IcebergWriter:
    """Append-only Iceberg writer: one parquet data file + one snapshot
    commit per engine commit (reference data_lake/writer.rs batching).
    The catalog seam carries the commit protocol: filesystem
    (version-hint exclusive create) or REST (CommitTableRequest)."""

    def __init__(
        self,
        location: str | None,
        column_names: Sequence[str],
        dtypes: dict,
        catalog: Any = None,
    ):
        self.catalog = (
            catalog
            if catalog is not None
            else FilesystemCatalog(os.fspath(location))
        )
        self.column_names = list(column_names)
        self.dtypes = dtypes
        self._rows: list[tuple] = []
        self.location = self.catalog.ensure(self.column_names, dtypes)

    def on_change(
        self, key: Pointer, values: tuple, time: int, diff: int
    ) -> None:
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
        arrow = pa.table({n: list(c) for n, c in zip(names, columns)})
        n_rows = len(self._rows)
        fname = f"{uuid.uuid4()}.parquet"
        fpath = os.path.join(self.location, _DATA, fname)
        pq.write_table(arrow, fpath)

        token, metadata = self.catalog.load()
        if metadata is None:
            raise RuntimeError(
                f"iceberg table at {self.location}: the catalog no longer "
                f"knows the table; it was deleted or corrupted after this "
                f"writer opened it"
            )
        seq = metadata["last-sequence-number"] + 1
        snapshot_id = int(uuid.uuid4().int % (1 << 62))
        now_ms = int(_time.time() * 1000)

        manifest_name = f"manifest-{uuid.uuid4()}.avro"
        manifest_path = os.path.join(self.location, _METADATA, manifest_name)
        entry = {
            "status": 1,  # ADDED
            "snapshot_id": snapshot_id,
            "sequence_number": seq,
            "file_sequence_number": seq,
            "data_file": {
                "content": 0,
                "file_path": os.path.join(_DATA, fname),
                "file_format": "PARQUET",
                "partition": {},
                "record_count": n_rows,
                "file_size_in_bytes": os.path.getsize(fpath),
            },
        }
        _write_manifest(
            manifest_path,
            [entry],
            table_schema=metadata["schemas"][0],
        )
        # new manifest list = previous snapshot's list + this manifest
        manifests: list[dict] = []
        current = metadata.get("current-snapshot-id", -1)
        for snap in metadata["snapshots"]:
            if snap["snapshot-id"] == current:
                manifests = _read_manifest_list(
                    os.path.join(self.location, snap["manifest-list"])
                )
        manifests = manifests + [
            {
                "manifest_path": os.path.join(_METADATA, manifest_name),
                "manifest_length": os.path.getsize(manifest_path),
                "partition_spec_id": 0,
                "content": 0,  # data
                "sequence_number": seq,
                "min_sequence_number": seq,
                "added_snapshot_id": snapshot_id,
                "added_files_count": 1,
                "existing_files_count": 0,
                "deleted_files_count": 0,
                "added_rows_count": n_rows,
                "existing_rows_count": 0,
                "deleted_rows_count": 0,
                "partitions": [],
            }
        ]
        list_name = f"snap-{snapshot_id}-{uuid.uuid4()}.avro"
        _write_manifest_list(
            os.path.join(self.location, _METADATA, list_name),
            manifests,
            snapshot_id=snapshot_id,
            sequence_number=seq,
        )
        metadata["last-sequence-number"] = seq
        metadata["last-updated-ms"] = now_ms
        metadata["current-snapshot-id"] = snapshot_id
        metadata["snapshots"].append(
            {
                "snapshot-id": snapshot_id,
                "sequence-number": seq,
                "timestamp-ms": now_ms,
                "manifest-list": os.path.join(_METADATA, list_name),
                "summary": {
                    "operation": "append",
                    "added-data-files": "1",
                    "added-records": str(n_rows),
                },
                "schema-id": 0,
            }
        )
        metadata["snapshot-log"].append(
            {"snapshot-id": snapshot_id, "timestamp-ms": now_ms}
        )
        if isinstance(token, int):  # fs catalog: token is the version
            metadata["metadata-log"].append(
                {
                    "metadata-file": _metadata_path(self.location, token),
                    "timestamp-ms": now_ms,
                }
            )
        self.catalog.commit(token, metadata)
        # only a fully committed snapshot releases the buffer: if the
        # parquet write or the exclusive version commit raised (lost
        # catalog race), the rows stay queued for the next flush — an
        # orphaned unreferenced data file is harmless, lost rows are not
        self._rows = []

    def on_end(self) -> None:
        self.on_time_end(-1)


class IcebergReader(Reader):
    """Poll the catalog's version hint; emit rows of data files added by
    unseen snapshots (in sequence-number order). Rows written by a pathway
    writer carry time/diff columns — diff=-1 rows become retractions."""

    def __init__(
        self,
        location: str | None,
        column_names: Sequence[str],
        mode: str,
        key_indices: Sequence[int] | None = None,
        catalog: Any = None,
    ):
        self.catalog = (
            catalog
            if catalog is not None
            else FilesystemCatalog(os.fspath(location))
        )
        self.location = (
            os.fspath(location) if location is not None else None
        )
        self.column_names = list(column_names)
        self.mode = mode
        self.key_indices = list(key_indices) if key_indices else None
        #: snapshots up to this sequence number were already emitted
        #: (sequence numbers are strictly increasing, so the offset is
        #: O(1) like DeltaReader's next_version)
        self._seen_seq = 0
        self._done_static = False

    def _events_of_file(self, rel_path: str):
        from pathway_tpu_torch.io._utils import lake_parquet_events

        return lake_parquet_events(
            os.path.join(self.location, rel_path),
            self.column_names,
            self.key_indices,
            "iceberg",
        )

    def poll(self) -> tuple[list[tuple[Any, str, dict]], bool]:
        if self._done_static:
            return [], True
        entries = []
        _token, metadata = self.catalog.load()
        if metadata is not None:
            # REST tables learn their file location from the catalog
            self.location = metadata.get("location", self.location)
            fresh = sorted(
                (
                    s
                    for s in metadata["snapshots"]
                    if s["sequence-number"] > self._seen_seq
                ),
                key=lambda s: s["sequence-number"],
            )
            for snap in fresh:
                manifests = _read_manifest_list(
                    os.path.join(self.location, snap["manifest-list"])
                )
                for m in manifests:
                    if m["added_snapshot_id"] != snap["snapshot-id"]:
                        continue  # carried over from an earlier snapshot
                    for entry in _read_manifest(
                        os.path.join(self.location, m["manifest_path"])
                    ):
                        if entry["status"] != 1:  # ADDED files only
                            continue
                        path = entry["data_file"]["file_path"]
                        entries.append(
                            (
                                self._events_of_file(path),
                                f"iceberg:{path}",
                                {"path": path},
                            )
                        )
                self._seen_seq = snap["sequence-number"]
        if self.mode == "static":
            self._done_static = True
        return entries, self.mode == "static"

    def state(self) -> dict:
        return {"seen_seq": self._seen_seq}

    def restore_state(self, state: dict) -> None:
        self._seen_seq = int(state.get("seen_seq", 0))
        self._done_static = False


def _rest_catalog_factory(
    catalog_uri: str | os.PathLike,
    namespace: Sequence[str] | None,
    table_name: str | None,
    kwargs: dict,
):
    """Shared REST dispatch for read()/write(): validation + a factory
    producing fresh RestCatalog clients."""
    if namespace is None or table_name is None:
        raise ValueError(
            "pw.io.iceberg: REST catalogs need namespace and table_name"
        )
    uri = os.fspath(catalog_uri)
    token = kwargs.get("credentials")
    return lambda: RestCatalog(uri, namespace, table_name, token=token)


def read(
    catalog_uri: str | os.PathLike,
    namespace: Sequence[str] | None = None,
    table_name: str | None = None,
    schema: schema_mod.SchemaMetaclass | None = None,
    *,
    mode: str = "streaming",
    autocommit_duration_ms: int | None = 1500,
    persistent_id: str | None = None,
    **kwargs: Any,
) -> Table:
    """Read an Iceberg table. An http(s) ``catalog_uri`` speaks the REST
    catalog protocol (reference src/connectors/data_lake/iceberg.rs);
    otherwise it is the warehouse root of the filesystem catalog.
    ``namespace`` + ``table_name`` locate the table under it — both may be
    omitted when ``catalog_uri`` IS the table directory (filesystem
    only)."""
    if schema is None:
        raise ValueError("schema= is required for pw.io.iceberg.read")
    if (namespace is None) != (table_name is None):
        raise ValueError(
            "pw.io.iceberg: pass both namespace and table_name (table under "
            "the warehouse root), or neither (catalog_uri IS the table dir)"
        )
    from pathway_tpu_torch.engine.storage import TransparentParser

    column_names = schema.column_names()
    pk = schema.primary_key_columns()
    key_indices = [column_names.index(p) for p in pk] if pk else None
    if _is_rest_uri(catalog_uri):
        make_catalog = _rest_catalog_factory(
            catalog_uri, namespace, table_name, kwargs
        )

        def make_rest_reader():
            return IcebergReader(
                None, column_names, mode, key_indices,
                catalog=make_catalog(),
            )

        return input_table(
            schema,
            make_rest_reader,
            lambda names: TransparentParser(names),
            source_name=(
                f"iceberg:{os.fspath(catalog_uri)}/"
                f"{'.'.join(namespace)}/{table_name}"
            ),
            persistent_id=persistent_id,
            autocommit_duration_ms=autocommit_duration_ms,
        )
    loc = (
        table_location(catalog_uri, namespace, table_name)
        if namespace is not None and table_name is not None
        else _check_local(catalog_uri)
    )
    return input_table(
        schema,
        lambda: IcebergReader(loc, column_names, mode, key_indices),
        lambda names: TransparentParser(names),
        source_name=f"iceberg:{loc}",
        persistent_id=persistent_id,
        autocommit_duration_ms=autocommit_duration_ms,
    )


def write(
    table: Table,
    catalog_uri: str | os.PathLike,
    namespace: Sequence[str] | None = None,
    table_name: str | None = None,
    *,
    min_commit_frequency: int | None = None,
    **kwargs: Any,
) -> None:
    """Write a table's update stream as Iceberg snapshot appends. An
    http(s) ``catalog_uri`` speaks the REST catalog protocol (reference
    src/connectors/data_lake/iceberg.rs); otherwise the filesystem
    (hadoop-style) catalog remains the default."""
    if (namespace is None) != (table_name is None):
        raise ValueError(
            "pw.io.iceberg: pass both namespace and table_name (table under "
            "the warehouse root), or neither (catalog_uri IS the table dir)"
        )
    dtypes = dict(table._dtypes)
    if _is_rest_uri(catalog_uri):
        make_catalog = _rest_catalog_factory(
            catalog_uri, namespace, table_name, kwargs
        )

        def make_rest_writer(column_names):
            return IcebergWriter(
                None, column_names, dtypes, catalog=make_catalog()
            )

        attach_writer(table, make_rest_writer)
        return
    loc = (
        table_location(catalog_uri, namespace, table_name)
        if namespace is not None and table_name is not None
        else _check_local(catalog_uri)
    )

    def make_writer(column_names):
        return IcebergWriter(loc, column_names, dtypes)

    attach_writer(table, make_writer)
