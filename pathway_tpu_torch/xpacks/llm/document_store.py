"""DocumentStore: docs -> parse -> split -> index, with retrieval queries.

Counterpart of ``pathway_tpu/xpacks/llm/document_store.py`` (``TpuKnnFactory`` there is
``DeviceKnnFactory`` here). The pipeline runs as engine dataflow: the parser, splitter
and embedder are UDF nodes, the index is the as-of-now external-index operator, on the
card for KNN and on the host for BM25. ``retrieve_query`` answers with the reference's
``{"text", "metadata", "dist"}`` dicts; ``statistics_query`` and ``inputs_query``
answer every query row with the chunk count and the input documents' metadata.
``_metadata`` arrives as the engine's ``Json``; every reader unwraps it. (The JAX
package's ``inputs_query`` calls ``dict`` on the ``Json`` itself, so its rows fail and
it answers ``None``; here it answers with the metadata dicts.)
"""

from __future__ import annotations

from typing import Any, Sequence

from pathway_tpu_torch.internals import jmespath_lite
from pathway_tpu_torch.internals.expression import apply as pw_apply
from pathway_tpu_torch.internals.reducers import count
from pathway_tpu_torch.internals.reducers import tuple as tuple_reducer
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.stdlib.indexing import (
    DataIndex,
    DeviceKnnFactory,
    HybridIndex,
    TantivyBM25Factory,
)
from pathway_tpu_torch.stdlib.indexing.data_index import explode_reply, fetch_docs_for_hits
from pathway_tpu_torch.xpacks.llm.parsers import ParseUtf8
from pathway_tpu_torch.xpacks.llm.splitters import NullSplitter


def _plain(m: Any) -> dict:
    """A metadata cell (the engine's ``Json``, a dict or ``None``) -> a dict."""
    if hasattr(m, "value"):
        m = m.value
    return dict(m or {})


class DocumentStore:
    """Indexes documents and serves retrieval queries as dataflow.

    ``docs`` tables need a ``data`` column (bytes/str) and may carry a
    ``_metadata`` dict column. Retrieval with ``retriever_factory='knn'``
    requires ``embedder`` (any text->vector UDF); ``'hybrid'`` fuses it with BM25,
    ``'bm25'`` indexes the text alone, and any other factory (``build()``) indexes the
    text column. ``device`` places the KNN index (the card unless the caller names
    another device, as for every entry point).
    """

    def __init__(
        self,
        docs: Table | Sequence[Table],
        *,
        embedder: Any = None,
        parser: Any = None,
        splitter: Any = None,
        retriever_factory: str | Any = "knn",
        dimensions: int | None = None,
        index_capacity: int = 1024,
        metric: str = "cos",
        device: Any = None,
    ) -> None:
        if isinstance(docs, Table):
            docs = [docs]
        self.metric = metric
        self.parser = parser or ParseUtf8()
        self.splitter = splitter or NullSplitter()
        self.embedder = embedder

        tables = []
        for d in docs:
            cols = d.column_names()
            meta = d["_metadata"] if "_metadata" in cols else None
            t = d.select(
                data=d["data"],
                _metadata=meta if meta is not None else pw_apply(lambda _x: {}, d["data"]),
            )
            tables.append(t)
        raw = tables[0].concat_reindex(*tables[1:]) if len(tables) > 1 else tables[0]
        self.input_docs = raw

        parsed = raw.select(_parts=self.parser(raw["data"]), _metadata=raw["_metadata"])
        parsed = parsed.flatten(parsed["_parts"])
        parsed = parsed.select(
            text=parsed["_parts"].get(0),
            _metadata=pw_apply(
                lambda part, meta: {**_plain(meta), **_plain(part[1])},
                parsed["_parts"],
                parsed["_metadata"],
            ),
        )
        chunked = parsed.select(
            _chunks=self.splitter(parsed["text"]), _metadata=parsed["_metadata"]
        )
        chunked = chunked.flatten(chunked["_chunks"])
        self.chunks = chunked.select(
            text=chunked["_chunks"].get(0), _metadata=chunked["_metadata"]
        )

        self._hybrid: Any = None
        if retriever_factory in ("knn", "hybrid"):
            if self.embedder is None:
                raise ValueError("knn retrieval needs an embedder")
            if dimensions is None:
                get_dim = getattr(self.embedder, "get_embedding_dimension", None)
                if get_dim is None:
                    raise ValueError("pass dimensions= for this embedder")
                dimensions = get_dim()
            data = self.chunks.select(
                text=self.chunks.text,
                _metadata=self.chunks["_metadata"],
                emb=self.embedder(self.chunks.text),
            )
            factory = DeviceKnnFactory(
                dimensions=dimensions,
                metric=metric,
                capacity=index_capacity,
                device=device,
            )
            self.indexed = data
            self.index = DataIndex(data, factory, data.emb)
            self._query_is_vector = True
            if retriever_factory == "hybrid":
                # RRF of dense KNN + BM25 over the same chunks
                bm25 = DataIndex(data, TantivyBM25Factory(), data.text)
                self._hybrid = HybridIndex([self.index, bm25])
        elif retriever_factory == "bm25":
            self.indexed = self.chunks
            self.index = DataIndex(
                self.chunks, TantivyBM25Factory(), self.chunks.text
            )
            self._query_is_vector = False
        else:
            # custom InnerIndexFactory over the text column
            self.indexed = self.chunks
            self.index = DataIndex(
                self.chunks, retriever_factory, self.chunks.text
            )
            self._query_is_vector = False

    # -- queries -------------------------------------------------------------

    def retrieve_query(self, query_table: Table) -> Table:
        """``query_table(query: str, k: int[, metadata_filter: str]
        [, filepath_globpattern: str])`` -> ``result`` column: tuple of
        ``{"text", "metadata", "dist"}`` dicts (reference DocumentStore
        retrieve format :188-211).

        ``metadata_filter`` is a JMESPath-subset expression over each
        chunk's metadata (globmatch/contains supported,
        internals/jmespath_lite.py); ``filepath_globpattern`` glob-matches
        the metadata ``path`` field. Filtered retrieval over-fetches
        (3k + 10 candidates) before filtering, like the reference's
        filter-aware index wrapper (external_integration/mod.rs:373)."""
        qcols = query_table.column_names()
        has_filters = (
            "metadata_filter" in qcols or "filepath_globpattern" in qcols
        )
        sel: dict[str, Any] = {
            "query": query_table.query,
            "k": query_table.k,
        }
        if "metadata_filter" in qcols:
            sel["metadata_filter"] = query_table.metadata_filter
        if "filepath_globpattern" in qcols:
            sel["filepath_globpattern"] = query_table.filepath_globpattern
        if self._query_is_vector:
            sel["_qv"] = self.embedder(query_table.query)
        prepped = query_table.select(**sel)
        qcol = prepped["_qv"] if self._query_is_vector else prepped["query"]
        fetch_k = (
            pw_apply(lambda kk: 3 * kk + 10, prepped.k)
            if has_filters
            else prepped.k
        )
        if self._hybrid is not None:
            reply = self._hybrid.query_as_of_now(
                prepped, [qcol, prepped["query"]], number_of_matches=fetch_k
            )
            hits = fetch_docs_for_hits(
                self.indexed,
                prepped,
                explode_reply(reply),
                doc_columns=["text", "_metadata"],
            )
        else:
            hits = self.index.query_docs_as_of_now(
                prepped,
                qcol,
                doc_columns=["text", "_metadata"],
                number_of_matches=fetch_k,
            )

        # Map higher-is-better scores to the reference's distance scale per
        # metric: cos similarity -> 1 - sim in [0, 2]; l2sq score is -distance² ->
        # distance² = -score; dot/bm25/RRF -> -score.
        if self._hybrid is None and self._query_is_vector and self.metric == "cos":
            to_dist = lambda s: 1.0 - float(s)  # noqa: E731
        else:
            to_dist = lambda s: -float(s)  # noqa: E731

        def to_result(
            texts: tuple,
            metas: tuple,
            scores: tuple,
            kk: int,
            meta_filter=None,
            glob_pattern=None,
        ) -> tuple:
            out = []
            for t, m, s in zip(texts, metas, scores):
                meta = _plain(m)
                if meta_filter:
                    try:
                        if jmespath_lite.search(meta_filter, meta) is not True:
                            continue
                    except jmespath_lite.JMESPathError:
                        continue
                if glob_pattern:
                    path = str(meta.get("path", ""))
                    if not jmespath_lite.globmatch(glob_pattern, path):
                        continue
                out.append(
                    {"text": t, "metadata": meta, "dist": to_dist(s)}
                )
                if len(out) >= kk:
                    break
            return tuple(out)

        pq = prepped.restrict(hits)
        filter_kwargs = {
            name: pq[name]
            for name in ("metadata_filter", "filepath_globpattern")
            if name in prepped.column_names()
        }
        # absent filters fall back to to_result's None defaults — no dummy
        # per-row columns
        kw_map = {
            "metadata_filter": "meta_filter",
            "filepath_globpattern": "glob_pattern",
        }
        return hits.select(
            result=pw_apply(
                to_result,
                hits["text"],
                hits["_metadata"],
                hits["_pw_index_reply_scores"],
                pq["k"],
                **{kw_map[n]: e for n, e in filter_kwargs.items()},
            )
        )

    def _broadcast_to_queries(
        self, query_table: Table, singleton: Table, **cols: Any
    ) -> Table:
        """Left-join every query row against a single aggregate row."""
        first_col = query_table.column_names()[0]
        one_q = query_table.select(
            _one=pw_apply(lambda *_a: 1, query_table[first_col])
        )
        agg_k = singleton.select(
            _one=pw_apply(lambda *_a: 1, singleton[singleton.column_names()[0]]),
            **{n: singleton[n] for n in singleton.column_names()},
        )
        joined = one_q.join_left(
            agg_k, one_q["_one"] == agg_k["_one"], id=one_q.id
        )
        return joined.select(**{n: agg_k[n] for n in cols})

    def statistics_query(self, query_table: Table) -> Table:
        """Indexed chunk count per request (reference statistics endpoint)."""
        stats = self.chunks.reduce(count=count())
        return self._broadcast_to_queries(query_table, stats, count=stats.count)

    def inputs_query(self, query_table: Table) -> Table:
        """Metadata of all input documents (reference /v1/inputs)."""
        docs = self.input_docs
        metas = docs.select(m=pw_apply(_plain, docs["_metadata"]))
        agg = metas.reduce(result=tuple_reducer(metas.m))
        return self._broadcast_to_queries(query_table, agg, result=agg.result)
