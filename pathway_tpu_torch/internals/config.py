"""Env-driven runtime configuration, trimmed to what ``pw.run`` reads.

Counterpart of ``pathway_tpu/internals/config.py``: the worker topology
(``PATHWAY_THREADS``, ``PATHWAY_PROCESSES``) and the persistence location
(``PATHWAY_PERSISTENT_STORAGE``, ``PATHWAY_REPLAY_STORAGE``). ``pw.run`` reads a fresh
config per run, so environment changes between runs take effect.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


@dataclass
class PathwayConfig:
    threads: int = field(default_factory=lambda: _env_int("PATHWAY_THREADS", 1))
    processes: int = field(default_factory=lambda: _env_int("PATHWAY_PROCESSES", 1))
    persistent_storage: str | None = field(
        default_factory=lambda: os.environ.get("PATHWAY_PERSISTENT_STORAGE")
    )
    replay_storage: str | None = field(
        default_factory=lambda: os.environ.get("PATHWAY_REPLAY_STORAGE")
    )


def get_pathway_config() -> PathwayConfig:
    """A fresh read of the environment."""
    return PathwayConfig()
