"""``pw.io.null``: consume a table without writing anywhere (counterpart of
``pathway_tpu/io/null.py``)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.engine.graph import Node, Scope
from pathway_tpu_torch.internals.parse_graph import G
from pathway_tpu_torch.internals.table import Table


def write(table: Table, **kwargs: Any) -> None:
    def attach(scope: Scope, node: Node):
        scope.subscribe_table(node)
        return None

    G.add_sink(table, attach)
