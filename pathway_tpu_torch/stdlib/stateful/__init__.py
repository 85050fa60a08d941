"""Stateful helpers: ``deduplicate``.

Counterpart of ``pathway_tpu/stdlib/stateful/__init__.py``.
"""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals.table import Table


def deduplicate(
    table: Table,
    *,
    value: Any,
    instance: Any = None,
    acceptor: Callable[[Any, Any], bool],
    name: str | None = None,
) -> Table:
    """Keep one accepted row per instance (``Table.deduplicate``, the engine's
    ``DeduplicateNode``)."""
    return table.deduplicate(value=value, instance=instance, acceptor=acceptor, name=name)
