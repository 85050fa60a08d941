"""HybridIndex: reciprocal-rank fusion over several DataIndexes.

Counterpart of ``pathway_tpu/stdlib/indexing/hybrid_index.py``: each retriever's reply
contributes ``1/(k + rank)`` per hit, scores sum across retrievers and the best
``number_of_matches`` keys win (ties by the key's ``repr``). Retrievers see the same
query table, each through its own query column (text for BM25, the vector for KNN).
"""

from __future__ import annotations

from typing import Any, Sequence

from pathway_tpu_torch.internals.expression import ColumnReference, apply as pw_apply
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing.data_index import DataIndex


class HybridIndex:
    def __init__(self, retrievers: Sequence[DataIndex], k: float = 60):
        if len(retrievers) < 2:
            raise ValueError(
                "HybridIndex requires at least two indices to be provided "
                "during initialization"
            )
        self.retrievers = list(retrievers)
        self.k = k

    def query_as_of_now(
        self,
        query_table: Table,
        query_columns: Sequence[ColumnReference],
        number_of_matches: Any = 3,
        oversample: int = 3,
    ) -> Table:
        """-> query columns + fused ``_pw_index_reply_ids`` /
        ``_pw_index_reply_scores`` (RRF scores). Each retriever is asked for
        ``number_of_matches * oversample`` candidates so fusion has depth.
        ``number_of_matches`` may be an int or a per-query column."""
        if len(query_columns) != len(self.retrievers):
            raise ValueError("one query column per retriever")
        if isinstance(number_of_matches, int):
            fetch: Any = number_of_matches * oversample
            n_expr = pw_apply(
                lambda _q: number_of_matches, query_columns[0]
            )
        else:
            fetch = pw_apply(lambda kk: kk * oversample, number_of_matches)
            n_expr = number_of_matches
        replies = [
            r.query_as_of_now(
                query_table, qc, number_of_matches=fetch
            )
            for r, qc in zip(self.retrievers, query_columns)
        ]
        k = self.k

        def fuse(n: int, *id_tuples: tuple) -> tuple:
            scores: dict = {}
            for ids in id_tuples:
                for rank, key in enumerate(ids, start=1):
                    scores[key] = scores.get(key, 0.0) + 1.0 / (k + rank)
            ranked = sorted(scores.items(), key=lambda kv: (-kv[1], repr(kv[0])))
            top = ranked[: int(n)]
            return (
                tuple(key for key, _s in top),
                tuple(s for _key, s in top),
            )

        combined = {
            name: query_table[name] for name in query_table.column_names()
        }
        fused = query_table.select(
            **combined,
            _pw_fused=pw_apply(
                fuse,
                n_expr,
                *[r["_pw_index_reply_ids"] for r in replies],
            ),
        )
        return fused.select(
            **{name: fused[name] for name in query_table.column_names()},
            _pw_index_reply_ids=fused["_pw_fused"].get(0),
            _pw_index_reply_scores=fused["_pw_fused"].get(1),
        )
