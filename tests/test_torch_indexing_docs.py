"""The port's retrieval indexes and their document-fetching queries
(``pathway_tpu_torch/stdlib/indexing``: ``bm25.py``, ``hybrid_index.py``,
``data_index.py``'s ``query_docs_as_of_now``, ``collapse_rows=False``,
``explode_reply`` and ``fetch_docs_for_hits``) against the JAX package's on the same
seeded inputs. BM25 scores, RRF scores and orders, hit ids, ranks and the fetched
document tuples are compared bit for bit (host float arithmetic in the same order on
both sides); vectors come from ``mocks.fake_embeddings_model`` and the KNN side runs
the exact f32 host index (``HostKnnFactory``) in both packages."""

from __future__ import annotations

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu.stdlib import indexing as jidx
from pathway_tpu_torch.engine import device_ops
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.stdlib import indexing as tidx

_WORDS = "stream table index vector engine commit window join reduce shard tensor batch".split()


@pytest.fixture(autouse=True)
def _cpu_operators(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")
    device_ops.configure(device="cpu")
    yield
    device_ops.configure()
    TG.clear()
    JG.clear()


def _texts(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(_WORDS[j] for j in rng.integers(0, len(_WORDS), 3 + int(rng.integers(0, 8))))
            for _ in range(n)]


def _canon(v):
    if isinstance(v, tuple):
        return tuple(_canon(x) for x in v)
    if isinstance(v, dict):
        return {k: _canon(x) for k, x in v.items()}
    if hasattr(v, "value") and not isinstance(v, (int, float, str)):
        return ("json", _canon(v.value))
    if type(v).__name__ == "Pointer":
        return ("ptr", int(v))
    return v


def _dicts(pw, table):
    data, names = pw.debug.table_to_dicts(table)
    return names, {int(k): {n: _canon(x) for n, x in row.items()} for k, row in data.items()}


# -- BM25 on its own ----------------------------------------------------------------


@pytest.mark.parametrize("k1, b", [(1.2, 0.75), (2.0, 0.3)])
def test_bm25_scores_match_jax(k1, b):
    """The same adds, a replacement and removes; every query's ranked (key, score)
    list equal, float for float."""
    from pathway_tpu.engine.value import Pointer as JPointer
    from pathway_tpu_torch.engine.value import Pointer as TPointer

    docs = _texts(30, seed=1)
    queries = _texts(8, seed=2) + ["", "unknown words only", "stream stream stream"]
    answers = []
    for factory, pointer in ((tidx.TantivyBM25Factory(k1=k1, b=b), TPointer),
                             (jidx.TantivyBM25Factory(k1=k1, b=b), JPointer)):
        index = factory.build()
        index.add([pointer(i + 1) for i in range(30)], docs)
        index.add([pointer(3)], ["window window join"])  # a replacement
        index.remove([pointer(5), pointer(99)])  # a live key and an unknown one
        res = index.search(queries, 7)
        answers.append([[(int(key), score) for key, score in hits] for hits in res])
    assert answers[0] == answers[1]
    assert any(len(h) == 7 for h in answers[0]) and answers[0][8] == []


def test_bm25_state_round_trips():
    from pathway_tpu_torch.engine.value import Pointer

    index = tidx.TantivyBM25Factory().build()
    index.add([Pointer(1), Pointer(2)], ["a b c", "b c d"])
    copy = tidx.TantivyBM25Factory().build()
    copy.restore_op_state(index.op_state())
    assert copy.search(["b d"], 2) == index.search(["b d"], 2)


# -- through the Table API ------------------------------------------------------------


def _corpus(pw, n: int = 24):
    texts = _texts(n, seed=7)
    return pw.debug.table_from_rows(
        pw.schema_from_types(text=str, owner=int),
        [(t, i % 3) for i, t in enumerate(texts)],
    )


def _queries(pw):
    return pw.debug.table_from_rows(
        pw.schema_from_types(query=str, k=int),
        [("stream join", 3), ("tensor batch shard", 5), ("nothing matches this", 2), ("window", 0)],
    )


def _with_vectors(pw, mocks, table, column):
    return table.select(
        *[table[n] for n in table.column_names()],
        vec=pw.apply(lambda s: tuple(float(x) for x in mocks.fake_embeddings_model(s, 8)), table[column]),
    )


def _knn_factory(idx):
    return idx.HostKnnFactory(dimensions=8, capacity=32)


def _program(pw, idx, mocks, kind):
    docs = _corpus(pw)
    queries = _queries(pw)
    if kind == "bm25":
        index = idx.DataIndex(docs, idx.TantivyBM25Factory(), docs.text)
        return index, docs, queries, queries.query
    docs = _with_vectors(pw, mocks, docs, "text")
    queries = _with_vectors(pw, mocks, queries, "query")
    index = idx.DataIndex(docs, _knn_factory(idx), docs.vec)
    return index, docs, queries, queries.vec


PACKAGES = {
    "port": (tpw, tidx, "pathway_tpu_torch.xpacks.llm.mocks"),
    "jax": (jpw, jidx, "pathway_tpu.xpacks.llm.mocks"),
}


def _both(fn):
    import importlib

    out = []
    for pw, idx, mocks in PACKAGES.values():
        out.append(fn(pw, idx, importlib.import_module(mocks)))
    return out


@pytest.mark.parametrize("kind", ["bm25", "knn"])
def test_query_as_of_now_collapsed_and_flat_match_jax(kind):
    def run(pw, idx, mocks):
        index, _docs, queries, qcol = _program(pw, idx, mocks, kind)
        collapsed = index.query_as_of_now(queries, qcol, number_of_matches=queries.k)
        flat = index.query_as_of_now(queries, qcol, number_of_matches=queries.k, collapse_rows=False)
        return _dicts(pw, collapsed), _dicts(pw, flat)

    ours, theirs = _both(run)
    assert ours == theirs
    (_, collapsed), (_, flat) = ours
    # one flat row per hit, and one sentinel row (rank -1) per query without a hit
    n_hits = sum(len(r["_pw_index_reply_ids"]) for r in collapsed.values())
    empty = sum(1 for r in collapsed.values() if not r["_pw_index_reply_ids"])
    assert len(flat) == n_hits + empty and empty >= 1
    assert sum(1 for r in flat.values() if r["_pw_index_reply_rank"] == -1) == empty


@pytest.mark.parametrize("kind", ["bm25", "knn"])
def test_query_docs_as_of_now_matches_jax(kind):
    """Per query, each doc column's values in rank order and the scores tuple; a query
    with no hit answers with empty tuples; query columns select beside the reply."""

    def run(pw, idx, mocks):
        index, _docs, queries, qcol = _program(pw, idx, mocks, kind)
        hits = index.query_docs_as_of_now(
            queries, qcol, doc_columns=["text", "owner"], number_of_matches=queries.k
        )
        beside = queries.restrict(hits).select(
            query=queries.query, texts=hits.text, scores=hits["_pw_index_reply_scores"]
        )
        return _dicts(pw, hits), _dicts(pw, beside)

    ours, theirs = _both(run)
    assert ours == theirs
    (names, hits), (_, beside) = ours
    assert names == ["text", "owner", "_pw_index_reply_scores"]
    assert len(hits) == len(beside) == 4
    assert any(r["text"] == () and r["_pw_index_reply_scores"] == () for r in hits.values())
    for key, row in hits.items():
        assert len(row["text"]) == len(row["owner"]) == len(row["_pw_index_reply_scores"])
        assert beside[key]["texts"] == row["text"]
        scores = row["_pw_index_reply_scores"]
        assert list(scores) == sorted(scores, reverse=True)


@pytest.mark.parametrize("n", [3, "column"])
def test_hybrid_rrf_matches_jax(n):
    """RRF of the KNN and BM25 replies: the same fused ids (in order) and scores."""

    def run(pw, idx, mocks):
        docs = _with_vectors(pw, mocks, _corpus(pw), "text")
        queries = _with_vectors(pw, mocks, _queries(pw), "query")
        knn = idx.DataIndex(docs, _knn_factory(idx), docs.vec)
        bm25 = idx.DataIndex(docs, idx.TantivyBM25Factory(), docs.text)
        hybrid = idx.HybridIndex([knn, bm25], k=30)
        fused = hybrid.query_as_of_now(
            queries, [queries.vec, queries.query],
            number_of_matches=n if n != "column" else queries.k,
        )
        flat = idx.data_index.explode_reply(fused)
        docs_for = idx.data_index.fetch_docs_for_hits(docs, queries, flat, ["text"])
        return _dicts(pw, fused), _dicts(pw, docs_for)

    ours, theirs = _both(run)
    assert ours == theirs
    (_, fused), _ = ours
    for row in fused.values():
        scores = row["_pw_index_reply_scores"]
        assert list(scores) == sorted(scores, reverse=True)
        assert all(s <= 2.0 / 31 for s in scores)  # two lists of 1/(30 + rank)


def test_hybrid_needs_two_indexes_and_one_column_each():
    docs = _corpus(tpw)
    one = tidx.DataIndex(docs, tidx.TantivyBM25Factory(), docs.text)
    with pytest.raises(ValueError, match="at least two"):
        tidx.HybridIndex([one])
    with pytest.raises(ValueError, match="one query column per retriever"):
        tidx.HybridIndex([one, one]).query_as_of_now(_queries(tpw), [_queries(tpw).query])


def test_none_text_is_reported_not_indexed():
    """A ``None`` text in the indexed column is left out and reported, as in the JAX
    engine; the other rows answer as before."""

    def run(pw, idx, mocks):
        docs = pw.debug.table_from_rows(
            pw.schema_from_types(text=str | None), [("stream join",), (None,), ("join window",)]
        )
        queries = pw.debug.table_from_rows(pw.schema_from_types(query=str), [("join",)])
        index = idx.DataIndex(docs, idx.TantivyBM25Factory(), docs.text)
        res = index.query_as_of_now(queries, queries.query, number_of_matches=5)
        return _dicts(pw, res)

    ours, theirs = _both(run)
    assert ours == theirs
    (_, rows), = [ours]
    (row,) = rows.values()
    assert len(row["_pw_index_reply_ids"]) == 2
