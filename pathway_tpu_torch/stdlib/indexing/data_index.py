"""DataIndex: retrieval as engine dataflow over as-of-now external indexes.

Counterpart of ``pathway_tpu/stdlib/indexing/data_index.py``. ``query_as_of_now``
answers each query row from the index as it stands when the row arrives, and revises
an answer only when the query row itself changes. The factories name what they build:
:class:`DeviceKnnFactory` the brute-force KNN index on the card (``TpuKnnFactory`` in
the JAX package; :class:`BruteForceKnnFactory` is the reference-compatible name),
:class:`HostKnnFactory` its exact f32 host twin.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from pathway_tpu_torch.engine.external_index import DeviceKnnIndex, HostKnnIndex
from pathway_tpu_torch.internals.expression import ColumnExpression, ColumnReference
from pathway_tpu_torch.internals.table import Table


class InnerIndexFactory:
    """Builds an engine-side index instance per graph build."""

    def build(self) -> Any:
        raise NotImplementedError


@dataclasses.dataclass
class DeviceKnnFactory(InnerIndexFactory):
    """Brute-force KNN on the card (``ops/knn.py``). ``dimensions`` is the embedding
    width; ``device=None`` means the card, as for every entry point."""

    dimensions: int
    metric: str = "cos"
    capacity: int = 1024
    device: "str | torch.device | None" = None

    def build(self) -> DeviceKnnIndex:
        return DeviceKnnIndex(
            dim=self.dimensions,
            metric=self.metric,
            capacity=self.capacity,
            device=self.device,
        )


class BruteForceKnnFactory(DeviceKnnFactory):
    """The reference-compatible name of :class:`DeviceKnnFactory`; the same index."""


@dataclasses.dataclass
class HostKnnFactory(InnerIndexFactory):
    """The exact f32 host twin of :class:`DeviceKnnFactory` (``HostKnnIndex``)."""

    dimensions: int
    metric: str = "cos"
    capacity: int = 1024

    def build(self) -> HostKnnIndex:
        return HostKnnIndex(dim=self.dimensions, metric=self.metric, capacity=self.capacity)


class DataIndex:
    """An index over ``data_table`` with retrieval as engine dataflow.
    ``data_column`` holds the embedding vectors; query results arrive as new columns
    on the query table. ``metadata_column`` is kept, as the reference keeps it; its one
    reader there, the LSH query path of ``stdlib/indexing/nearest_neighbors.py``, is not
    ported yet (ROADMAP queue 1 item 8)."""

    def __init__(
        self,
        data_table: Table,
        inner_index_factory: InnerIndexFactory,
        data_column: ColumnReference,
        metadata_column: ColumnReference | None = None,
    ) -> None:
        self.data_table = data_table
        self.factory = inner_index_factory
        self.data_column = data_column
        self.metadata_column = metadata_column

    def query_as_of_now(
        self,
        query_table: Table,
        query_column: ColumnReference,
        number_of_matches: int | ColumnExpression = 3,
        collapse_rows: bool = True,
        with_scores: bool = True,
    ) -> Table:
        """Retrieve for each query row, as of its arrival: a table keyed by query id
        with the query columns plus ``_pw_index_reply_ids`` (tuple of data-row keys)
        and ``_pw_index_reply_scores``. The scores column is there whatever
        ``with_scores`` says, as in the reference, which accepts the argument and
        always answers with scores. ``collapse_rows=False`` (one row per hit, the
        reference's ``explode_reply``) is not ported yet."""
        if not collapse_rows:
            raise NotImplementedError(
                "collapse_rows=False (one row per hit) is not ported yet "
                "(ROADMAP queue 1 item 11)"
            )
        reply = self.data_table._external_index_as_of_now(
            query_table,
            index_column=self.data_column,
            query_column=query_column,
            index_factory=self.factory.build,
            number_of_matches=number_of_matches,
        )
        combined = {name: query_table[name] for name in query_table.column_names()}
        combined["_pw_index_reply_ids"] = reply["_pw_index_reply_ids"]
        combined["_pw_index_reply_scores"] = reply["_pw_index_reply_scores"]
        return query_table.restrict(reply).select(**combined)
