"""SharePoint document libraries as a table source.

Counterpart of ``pathway_tpu/xpacks/connectors/sharepoint/__init__.py``: licensed (the
``xpack-sharepoint`` entitlement), and read through an injected ``client`` with the
object-store seam (``list_objects(prefix)`` of ``(path, version)`` pairs,
``get_object(path)``), by ``engine/storage.py::ObjectStoreReader``: each file is one
binary ``data`` row, an edit replaces it and a deletion retracts it.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.connectors import IdentityParser
from pathway_tpu_torch.engine.storage import ObjectStoreReader
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.license import (
    ENTITLEMENT_XPACK_SHAREPOINT,
    check_entitlements,
)
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._utils import input_table


def read(
    url: str | None = None,
    *,
    root_path: str = "",
    mode: str = "streaming",
    with_metadata: bool = False,
    client: Any = None,
    **kwargs: Any,
) -> Table:
    """Each library file becomes one binary ``data`` row; edits replace,
    deletions retract (the ObjectStore scanner's diffing)."""
    check_entitlements(ENTITLEMENT_XPACK_SHAREPOINT)
    if client is None:
        raise ValueError(
            "pw.xpacks.connectors.sharepoint.read needs an injected client "
            "(list_objects/get_object seam) — no Office365 SDK ships here"
        )
    schema = schema_mod.schema_from_types(data=bytes)
    return input_table(
        schema,
        lambda: ObjectStoreReader(client, root_path, mode=mode, binary=True),
        lambda names: IdentityParser(binary=True),
        source_name=f"sharepoint:{url or root_path}",
        with_metadata=with_metadata,
    )
