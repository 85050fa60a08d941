"""``pw.io.pyfilesystem``: read any PyFilesystem2 filesystem.

Counterpart of ``pathway_tpu/io/pyfilesystem.py``. ``source`` is any object with the
PyFilesystem surface the reader uses (``walk.files(path)``, ``getinfo(path,
namespaces=["details"])`` and ``readbytes(path)``): an ``fs.open_fs(...)`` result when
the ``fs`` package is installed, or an object of one's own. Each file is a row (its
bytes, or its text); a file whose size or modification time changes replaces its row,
a deleted one retracts it."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.connectors import IdentityParser
from pathway_tpu_torch.engine.storage import ObjectStoreReader
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._utils import input_table


class _FsStore:
    """A PyFilesystem source as an object store: a file's signature is its size and
    modification time."""

    def __init__(self, source: Any, path: str) -> None:
        self.source = source
        self.path = path

    def list_objects(self, prefix: str):
        out = []
        for fpath in self.source.walk.files(self.path or "/"):
            info = self.source.getinfo(fpath, namespaces=["details"])
            sig = f"{getattr(info, 'size', 0)}:{getattr(info, 'modified', '')}"
            out.append((fpath, sig))
        return out

    def get_object(self, key: str) -> bytes:
        return self.source.readbytes(key)


def read(
    source: Any,
    path: str = "",
    *,
    mode: str = "streaming",
    format: str = "binary",  # noqa: A002
    with_metadata: bool = False,
    **kwargs: Any,
) -> Table:
    schema = schema_mod.schema_from_types(data=bytes if format == "binary" else str)
    store = _FsStore(source, path)
    return input_table(
        schema,
        lambda: ObjectStoreReader(store, "", mode=mode, binary=format == "binary"),
        lambda names: IdentityParser(binary=format == "binary"),
        source_name=f"pyfilesystem:{path}",
        with_metadata=with_metadata,
    )
