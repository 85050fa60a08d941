"""DataIndex: retrieval as engine dataflow over as-of-now external indexes.

Counterpart of ``pathway_tpu/stdlib/indexing/data_index.py``. ``query_as_of_now``
answers each query row from the index as it stands when the row arrives, and revises
an answer only when the query row itself changes. The factories name what they build:
:class:`DeviceKnnFactory` the brute-force KNN index on the card (``TpuKnnFactory`` in
the JAX package; :class:`BruteForceKnnFactory` is the reference-compatible name),
:class:`HostKnnFactory` its exact f32 host twin; ``bm25.py`` holds the host full-text
index. Answers come collapsed (a tuple of hits per query), one row per hit
(:func:`explode_reply`), or with the hits' document columns fetched
(:func:`fetch_docs_for_hits`, the shape RAG pipelines consume).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from pathway_tpu_torch.engine.external_index import DeviceKnnIndex, HostKnnIndex
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    ColumnReference,
    apply as pw_apply,
    make_tuple,
)
from pathway_tpu_torch.internals.reducers import sorted_tuple
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.universe import solver


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
    ``data_column`` holds the indexable payload (embedding vectors for KNN, text for
    BM25); query results arrive as new columns on the query table. ``metadata_column``
    is kept, as the reference keeps it; its one reader there, the LSH query path of
    ``stdlib/indexing/nearest_neighbors.py``, is not ported yet (ROADMAP queue 1 item
    8)."""

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
        """Retrieve for each query row, as of its arrival. ``collapse_rows=True``: a
        table keyed by query id with the query columns plus ``_pw_index_reply_ids``
        (tuple of data-row keys) and ``_pw_index_reply_scores``. ``collapse_rows=False``:
        one row per (query, hit), with ``_pw_query_id``, ``_pw_index_reply_rank``,
        ``_pw_index_reply_id`` and ``_pw_index_reply_score`` (:func:`explode_reply`;
        a query with no hit keeps one sentinel row of rank -1). The scores are there
        whatever ``with_scores`` says, as in the reference, which accepts the argument
        and always answers with scores."""
        reply = self.data_table._external_index_as_of_now(
            query_table,
            index_column=self.data_column,
            query_column=query_column,
            index_factory=self.factory.build,
            number_of_matches=number_of_matches,
        )
        if not collapse_rows:
            return explode_reply(reply)
        combined = {name: query_table[name] for name in query_table.column_names()}
        combined["_pw_index_reply_ids"] = reply["_pw_index_reply_ids"]
        combined["_pw_index_reply_scores"] = reply["_pw_index_reply_scores"]
        return query_table.restrict(reply).select(**combined)

    def query_docs_as_of_now(
        self,
        query_table: Table,
        query_column: ColumnReference,
        doc_columns: list[str],
        number_of_matches: int | ColumnExpression = 3,
    ) -> Table:
        """The hits with their documents: per query, a tuple of each doc column's
        values in rank order, and the scores tuple (:func:`fetch_docs_for_hits`)."""
        flat = self.query_as_of_now(
            query_table,
            query_column,
            number_of_matches=number_of_matches,
            collapse_rows=False,
        )
        return fetch_docs_for_hits(self.data_table, query_table, flat, doc_columns)


def fetch_docs_for_hits(
    data_table: Table,
    query_table: Table,
    flat_hits: Table,
    doc_columns: list[str],
) -> Table:
    """One row per hit (``_pw_query_id``, ``_pw_index_reply_rank``,
    ``_pw_index_reply_id``, ``_pw_index_reply_score``) -> one row per query, keyed by
    the query's id: a tuple of each doc column's values ordered by rank, and
    ``_pw_index_reply_scores``. The result's universe is registered as a subset of the
    query table's, so callers can select query columns beside it."""
    # optional=True: a zero-hit sentinel row carries a None doc id
    docs_at = data_table.ix(flat_hits["_pw_index_reply_id"], optional=True)
    fetched = flat_hits.select(
        _pw_query_id=flat_hits["_pw_query_id"],
        _pw_index_reply_rank=flat_hits["_pw_index_reply_rank"],
        _pw_index_reply_score=flat_hits["_pw_index_reply_score"],
        **{name: docs_at[name] for name in doc_columns},
    )

    def strip_ranks(pairs: tuple) -> tuple:
        # rank -1 marks the zero-hit sentinel; it contributes no values
        return tuple(v for rank, v in pairs if rank >= 0)

    grouped = fetched.groupby(id=fetched["_pw_query_id"])
    agg = {
        name: pw_apply(
            strip_ranks,
            sorted_tuple(make_tuple(fetched["_pw_index_reply_rank"], fetched[name])),
        )
        for name in doc_columns
    }
    agg["_pw_index_reply_scores"] = pw_apply(
        strip_ranks,
        sorted_tuple(
            make_tuple(fetched["_pw_index_reply_rank"], fetched["_pw_index_reply_score"])
        ),
    )
    result = grouped.reduce(**agg)
    # the group keys are the query ids (groupby id=_pw_query_id)
    solver.register_subset(result._universe, query_table._universe)
    return result


def explode_reply(reply: Table) -> Table:
    """Collapsed replies (ids and scores tuples) -> one row per hit (rank, id,
    score), with a sentinel row (rank -1, no id, no score) for a query with no hit,
    so that it stays in downstream universes."""

    def hit_triples(ids: tuple, scores: tuple) -> tuple:
        if not ids:
            return ((-1, None, None),)
        return tuple((i, k, s) for i, (k, s) in enumerate(zip(ids, scores)))

    pairs = reply.select(
        _pw_hits=pw_apply(
            hit_triples, reply["_pw_index_reply_ids"], reply["_pw_index_reply_scores"]
        ),
        _pw_query_id=reply.id,
    )
    flat = pairs.flatten(pairs["_pw_hits"])
    return flat.select(
        _pw_query_id=flat["_pw_query_id"],
        _pw_index_reply_rank=flat["_pw_hits"].get(0),
        _pw_index_reply_id=flat["_pw_hits"].get(1),
        _pw_index_reply_score=flat["_pw_hits"].get(2),
    )
