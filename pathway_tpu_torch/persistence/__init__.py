"""``pw.persistence``: ``Backend`` and ``Config``.

Counterpart of ``pathway_tpu/persistence/__init__.py``. In ``PERSISTING`` mode every
persistent input source (a connector with ``persistent_id``) journals its events and its
reader's position at each commit; a restart replays the journal up to the last complete
commit and the reader goes on past what it had consumed. ``OPERATOR_PERSISTING``
snapshots every operator's state instead and restores it with no replay.
``UDF_CACHING`` only routes the UDFs' disk caches under the backend's root.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

from pathway_tpu_torch.engine.persistence import (
    FileBackend,
    MemoryBackend,
    ObjectStoreBackend,
    PersistenceBackend,
)

__all__ = ["Backend", "Config", "PersistenceMode"]


class PersistenceMode(enum.Enum):
    PERSISTING = "persisting"  # input-event journal replay (the default)
    UDF_CACHING = "udf_caching"  # only the UDF disk cache
    #: operator state snapshots at commit boundaries; a resume restores them and seeks
    #: the readers: O(state), not O(history)
    OPERATOR_PERSISTING = "operator_persisting"


class Backend:
    """Factories of persistence backends."""

    @staticmethod
    def filesystem(path: Any) -> PersistenceBackend:
        return FileBackend(str(path))

    @staticmethod
    def mock(events: Any = None) -> PersistenceBackend:
        return MemoryBackend()

    @staticmethod
    def s3(root_path: Any = None, bucket_settings: Any = None, *, client: Any = None) -> PersistenceBackend:
        """An S3-shaped object store: an injected ``client`` (``get_object``,
        ``put_object``, ``list_objects``: ``pw.io.s3.DictObjectStore``, say), or the
        client that ``bucket_settings`` (``pw.io.s3.AwsS3Settings``) makes."""
        if client is None:
            if bucket_settings is None:
                raise ValueError("pass client= or bucket_settings=")
            client = bucket_settings.create_client()
        return ObjectStoreBackend(client, str(root_path or "pathway-persistence"))

    @staticmethod
    def azure(root_path: Any = None, account: Any = None, *, client: Any = None) -> PersistenceBackend:
        """Azure blobs through the same object-store seam; the client is injected."""
        if client is None:
            raise ImportError(
                "pw.persistence.Backend.azure needs an injected blob client "
                "(get_object/put_object/list_objects seam)"
            )
        return ObjectStoreBackend(client, str(root_path or "pathway-persistence"))


@dataclasses.dataclass
class Config:
    backend: PersistenceBackend
    snapshot_interval_ms: int = 0
    persistence_mode: PersistenceMode = PersistenceMode.PERSISTING
    continue_after_replay: bool = True

    @staticmethod
    def simple_config(
        backend: PersistenceBackend,
        snapshot_interval_ms: int = 0,
        persistence_mode: PersistenceMode = PersistenceMode.PERSISTING,
    ) -> "Config":
        return Config(backend, snapshot_interval_ms, persistence_mode)
