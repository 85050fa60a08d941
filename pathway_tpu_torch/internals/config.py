"""Env-driven runtime configuration, trimmed to what ``pw.run`` reads.

Counterpart of ``pathway_tpu/internals/config.py``: the worker topology
(``PATHWAY_THREADS``, ``PATHWAY_PROCESSES``, ``PATHWAY_PROCESS_ID``,
``PATHWAY_FIRST_PORT``) and persistence (``PATHWAY_PERSISTENT_STORAGE``,
``PATHWAY_REPLAY_STORAGE``, ``PATHWAY_PERSISTENCE_MODE``, ``PATHWAY_SNAPSHOT_ACCESS``,
``PATHWAY_CONTINUE_AFTER_REPLAY``) and the license key (``PATHWAY_LICENSE_KEY``, or the
key :func:`set_license_key` set in this context, which wins). ``pw.run`` reads a fresh
config per run, so environment changes between runs take effect.
"""

from __future__ import annotations

import os
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any

_UNSET = object()
#: the key ``set_license_key`` set in this context; unset: ``PATHWAY_LICENSE_KEY``
_license_key: ContextVar[object] = ContextVar("license_key", default=_UNSET)


def _current_license_key() -> str | None:
    key = _license_key.get()
    return os.environ.get("PATHWAY_LICENSE_KEY") if key is _UNSET else key


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _env_field(name: str, default: str | None = None):
    return field(default_factory=lambda: os.environ.get(name, default))


def _env_bool_field(name: str, default: str = "false"):
    return field(
        default_factory=lambda: os.environ.get(name, default).lower() in ("1", "true", "yes", "on")
    )


@dataclass
class PathwayConfig:
    threads: int = field(default_factory=lambda: _env_int("PATHWAY_THREADS", 1))
    processes: int = field(default_factory=lambda: _env_int("PATHWAY_PROCESSES", 1))
    process_id: str = _env_field("PATHWAY_PROCESS_ID", "0")
    #: process i of a mesh listens on ``first_port + i``
    first_port: int = field(default_factory=lambda: _env_int("PATHWAY_FIRST_PORT", 10000))
    continue_after_replay: bool = _env_bool_field("PATHWAY_CONTINUE_AFTER_REPLAY", "true")
    persistence_mode: str = _env_field("PATHWAY_PERSISTENCE_MODE", "persisting")
    persistent_storage: str | None = _env_field("PATHWAY_PERSISTENT_STORAGE")
    replay_storage: str | None = _env_field("PATHWAY_REPLAY_STORAGE")
    snapshot_access: str | None = _env_field("PATHWAY_SNAPSHOT_ACCESS")
    license_key: str | None = field(default_factory=lambda: _current_license_key())

    @property
    def replay_config(self) -> Any:
        """The persistence Config the environment implies, or None."""
        storage = self.persistent_storage or self.replay_storage
        if not storage:
            return None
        from pathway_tpu_torch.persistence import Backend, Config, PersistenceMode

        mode = {
            "persisting": PersistenceMode.PERSISTING,
            "operator_persisting": PersistenceMode.OPERATOR_PERSISTING,
            "udf_caching": PersistenceMode.UDF_CACHING,
        }.get(self.persistence_mode.lower(), PersistenceMode.PERSISTING)
        return Config(
            Backend.filesystem(storage),
            persistence_mode=mode,
            continue_after_replay=self.continue_after_replay,
        )


def get_pathway_config() -> PathwayConfig:
    """A fresh read of the environment."""
    return PathwayConfig()


def set_license_key(key: str | None) -> None:
    """Use ``key`` as the license key in this context, in place of
    ``PATHWAY_LICENSE_KEY`` (None: no key, the free tier)."""
    _license_key.set(key)
