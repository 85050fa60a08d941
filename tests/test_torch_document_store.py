"""The port's ``DocumentStore`` and ``VectorStoreServer``
(``pathway_tpu_torch/xpacks/llm``) against the JAX package's on the same docs and
queries, through ``pw.debug.table_to_dicts`` and through a streaming ``pw.run``.

With ``mocks.FakeEmbedder`` (the same seeded host vectors in both packages) every
answer is compared bit for bit: KNN, BM25 and hybrid retrieval, their texts, metadata
and ``dist`` (KNN's ``dist`` within 1e-6: its cosine is an f32 matmul that torch and
XLA sum in another order), with metadata and path-glob filters and several ``docs``
tables, the statistics and inputs queries. The KNN index runs on the CPU in the port
and as the JAX package's own CPU index there.

The slice as a whole: the store over the port's ``EncoderEmbedder`` (hidden 64, 2
layers: the ``tests/fixtures/tiny_bert`` checkpoint, in f32) with its weights carried
from a JAX ``TpuEncoderEmbedder`` by ``params_from_jax``, against the JAX store: the
same top-k texts and metadata, and ``dist`` within 1e-4 (f32 model math on the CPU,
summed in another order; JAX's attention runs as its own CPU tests run it)."""

from __future__ import annotations

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
import pathway_tpu.xpacks.llm as jllm
import pathway_tpu_torch.xpacks.llm as tllm
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch.engine import device_ops
from pathway_tpu_torch.internals.parse_graph import G as TG

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_bert")
WAIT_S = 60.0  # every wait is bounded: a stalled pipeline fails, never hangs
DIST_TOL = 1e-4
KNN_DIST_TOL = 1e-6  # one f32 cosine, rounded apart by the order of its sums

_WORDS = "stream table index vector engine commit window join reduce shard tensor batch".split()


@pytest.fixture(autouse=True)
def _cpu_operators(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")
    device_ops.configure(device="cpu")
    yield
    device_ops.configure()
    TG.clear()
    JG.clear()


def _text(i: int) -> str:
    rng = np.random.default_rng(100 + i)
    return " ".join(_WORDS[j] for j in rng.integers(0, len(_WORDS), 4 + int(rng.integers(0, 6))))


def _docs(n: int, offset: int = 0) -> list[tuple]:
    return [
        (_text(offset + i), {"path": f"/d/{'a' if (offset + i) % 2 else 'b'}/{offset + i}.txt",
                             "owner": ["alice", "bob", "carol"][(offset + i) % 3]})
        for i in range(n)
    ]


QUERIES = [
    {"query": _text(3), "k": 3},
    {"query": "stream join window", "k": 4, "metadata_filter": "owner == 'alice'"},
    {"query": "tensor batch", "k": 2, "filepath_globpattern": "/d/a/*"},
    {"query": _text(7), "k": 5, "metadata_filter": "owner != 'bob' && contains(path, '/d/')",
     "filepath_globpattern": "**/*.txt"},
    {"query": "commit", "k": 2, "metadata_filter": "owner == ", "filepath_globpattern": "*"},
    {"query": "index", "k": 3, "metadata_filter": "owner == 'nobody'"},
]


def _canon(v):
    if isinstance(v, tuple):
        return tuple(_canon(x) for x in v)
    if isinstance(v, list):
        return [_canon(x) for x in v]
    if isinstance(v, dict):
        return {k: _canon(x) for k, x in v.items()}
    if type(v).__name__ == "Json":
        return _canon(v.value)
    if type(v).__name__ == "Pointer":
        return ("ptr", int(v))
    return v


def _dicts(pw, table):
    data, names = pw.debug.table_to_dicts(table)
    return names, {int(k): {n: _canon(x) for n, x in row.items()} for k, row in data.items()}


def _query_table(pw, columns):
    types = {"query": str, "k": int, "metadata_filter": str | None,
             "filepath_globpattern": str | None}
    schema = pw.schema_from_types(**{c: types[c] for c in columns})
    return pw.debug.table_from_rows(schema, [tuple(q.get(c) for c in columns) for q in QUERIES])


def _store(pw, llm, factory, tables: int = 1, **kw):
    schema = pw.schema_from_types(data=str, _metadata=dict)
    docs = [pw.debug.table_from_rows(schema, _docs(8, offset=8 * i)) for i in range(tables)]
    extra = {"device": "cpu"} if llm is tllm else {}
    if factory == "custom":
        factory = tidx_bm25() if llm is tllm else jidx_bm25()
    return llm.DocumentStore(docs, embedder=llm.mocks.FakeEmbedder(12), retriever_factory=factory,
                             **extra, **kw)


def tidx_bm25():
    from pathway_tpu_torch.stdlib.indexing import TantivyBM25Factory

    return TantivyBM25Factory(k1=1.5, b=0.5)


def jidx_bm25():
    from pathway_tpu.stdlib.indexing import TantivyBM25Factory

    return TantivyBM25Factory(k1=1.5, b=0.5)


COLUMNS = {
    "plain": ["query", "k"],
    "filters": ["query", "k", "metadata_filter", "filepath_globpattern"],
    "metadata_filter": ["query", "k", "metadata_filter"],
}


@pytest.mark.parametrize("columns", sorted(COLUMNS))
@pytest.mark.parametrize("factory", ["knn", "bm25", "hybrid", "custom"])
@pytest.mark.parametrize("tables", [1, 3])
def test_retrieve_query_matches_jax(factory, columns, tables):
    """Texts, metadata and order bit for bit for every retriever; ``dist`` bit for bit
    for BM25 and hybrid (host arithmetic, and RRF of ranks), within ``KNN_DIST_TOL``
    for KNN, whose cosines are a matmul in f32 that torch and XLA sum in another
    order."""
    answers = []
    for pw, llm in ((tpw, tllm), (jpw, jllm)):
        store = _store(pw, llm, factory, tables=tables)
        answers.append(_dicts(pw, store.retrieve_query(_query_table(pw, COLUMNS[columns]))))
    if factory == "knn":
        _assert_same_hits(answers[0], answers[1], KNN_DIST_TOL)
    else:
        assert answers[0] == answers[1]
    names, rows = answers[0]
    assert names == ["result"] and len(rows) == len(QUERIES)
    results = [r["result"] for r in rows.values()]
    assert any(results) and all(len(r) <= 5 for r in results)
    assert all(set(hit) == {"text", "metadata", "dist"} for result in results for hit in result)
    if columns != "plain":
        # the "nobody" filter and the malformed one let nothing through
        assert sum(1 for result in results if not result) >= 2


def _assert_same_hits(ours, theirs, tol):
    """The same rows and hits (texts, metadata, order), ``dist`` within ``tol``."""
    (names, rows), (their_names, their_rows) = ours, theirs
    assert names == their_names and sorted(rows) == sorted(their_rows)
    for key, row in rows.items():
        got, want = row["result"], their_rows[key]["result"]
        assert [(h["text"], h["metadata"]) for h in got] == [(h["text"], h["metadata"]) for h in want]
        np.testing.assert_allclose([h["dist"] for h in got], [h["dist"] for h in want],
                                   rtol=0, atol=tol)


def test_knn_dist_is_one_minus_cosine():
    """``dist`` for cos is 1 - the exact f32 cosine; the top hit of a doc's own text is
    that doc, at dist ~0."""
    store = _store(tpw, tllm, "knn")
    docs = _docs(8)
    q = tpw.debug.table_from_rows(tpw.schema_from_types(query=str, k=int), [(docs[5][0], 8)])
    (_, rows) = _dicts(tpw, store.retrieve_query(q))
    (row,) = rows.values()
    qv = tllm.mocks.fake_embeddings_model(docs[5][0], 12)
    first = row["result"][0]
    assert first["text"] == docs[5][0] and abs(first["dist"]) < 1e-6
    for hit in row["result"]:
        v = tllm.mocks.fake_embeddings_model(hit["text"], 12)
        cos = float(np.dot(qv, v) / (np.linalg.norm(qv) * np.linalg.norm(v)))
        assert abs(hit["dist"] - (1.0 - cos)) < 1e-6


@pytest.mark.parametrize("factory", ["knn", "bm25"])
def test_statistics_and_inputs_queries_match_jax(factory):
    """The chunk count per query row equals the JAX store's. ``inputs_query`` answers
    every query row with the input documents' metadata dicts, as the reference does;
    the JAX package's calls ``dict`` on the engine's ``Json`` and answers ``None``, so
    its rows are held to the docs' own metadata instead."""
    answers = []
    for pw, llm in ((tpw, tllm), (jpw, jllm)):
        store = _store(pw, llm, factory, tables=2)
        q = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(1,), (2,)])
        answers.append((_dicts(pw, store.statistics_query(q)), _dicts(pw, store.inputs_query(q))))
    (stats, inputs), (their_stats, their_inputs) = answers
    assert stats == their_stats
    assert [r["count"] for r in stats[1].values()] == [16, 16]
    assert inputs[0] == their_inputs[0] == ["result"]
    assert sorted(inputs[1]) == sorted(their_inputs[1])
    assert all(r["result"] is None for r in their_inputs[1].values())
    want = sorted((m for _t, m in _docs(16)), key=lambda m: m["path"])
    for row in inputs[1].values():
        assert sorted(row["result"], key=lambda m: m["path"]) == want


def test_parser_and_splitter_chunks_match_jax():
    """A splitter that cuts docs into several chunks and a parser from bytes: the
    chunks table and the answers equal the JAX store's."""
    answers = []
    for pw, llm in ((tpw, tllm), (jpw, jllm)):
        schema = pw.schema_from_types(data=bytes, _metadata=dict)
        docs = pw.debug.table_from_rows(
            schema, [(" ".join([_text(i)] * 3).encode(), {"path": f"/p/{i}"}) for i in range(5)]
        )
        store = llm.DocumentStore(
            docs, embedder=llm.mocks.FakeEmbedder(6), parser=llm.parsers.ParseUtf8(),
            splitter=llm.splitters.TokenCountSplitter(min_tokens=3, max_tokens=7),
            **({"device": "cpu"} if llm is tllm else {}),
        )
        q = pw.debug.table_from_rows(pw.schema_from_types(query=str, k=int), [(_text(2), 4)])
        answers.append((_dicts(pw, store.chunks), _dicts(pw, store.retrieve_query(q))))
    assert answers[0] == answers[1]
    (_, chunks), _ = answers[0]
    assert len(chunks) > 5


def test_knn_needs_an_embedder_and_a_dimension():
    schema = tpw.schema_from_types(data=str)
    docs = tpw.debug.table_from_rows(schema, [("a",)])
    with pytest.raises(ValueError, match="needs an embedder"):
        tllm.DocumentStore(docs, retriever_factory="knn")
    with pytest.raises(ValueError, match="dimensions="):
        tllm.DocumentStore(docs, embedder=tpw.udf(lambda t: (1.0,)), device="cpu")


def test_vector_store_server_is_a_knn_store():
    answers = []
    for pw, llm in ((tpw, tllm), (jpw, jllm)):
        schema = pw.schema_from_types(data=str, _metadata=dict)
        a = pw.debug.table_from_rows(schema, _docs(6))
        b = pw.debug.table_from_rows(schema, _docs(6, offset=6))
        server = llm.VectorStoreServer(a, b, embedder=llm.mocks.FakeEmbedder(12), index_capacity=4,
                                       **({"device": "cpu"} if llm is tllm else {}))
        answers.append(_dicts(pw, server.retrieve_query(_query_table(pw, COLUMNS["filters"]))))
    _assert_same_hits(answers[0], answers[1], KNN_DIST_TOL)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        server_port = tllm.VectorStoreServer(
            tpw.debug.table_from_rows(tpw.schema_from_types(data=str), [("x",)]),
            embedder=tllm.mocks.FakeEmbedder(4), device="cpu",
        )
        server_port.run_server()
    client = tllm.VectorStoreClient(port=1)
    assert client.base == jllm.VectorStoreClient(port=1).base == "http://127.0.0.1:1"


# -- the slice as a whole: a streaming run over the port's encoder ---------------------


def _streaming_store(pw, llm, embedder, n_docs, n_queries, **store_kw):
    """``bench.py::vector_store_leg``'s program at tiny size: docs with ``_metadata``
    through ``pw.io.python`` into a ``VectorStoreServer``; queries of docs' own texts
    sent one at a time once every chunk has arrived. -> (indexed rows, answers)."""
    corpus = [_text(i) for i in range(n_docs)]
    ingest_done, answer_seen = threading.Event(), threading.Event()
    chunks: dict = {}
    answers: dict = {}
    failures: list = []

    class DocFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for i in range(n_docs):
                self.next(data=corpus[i], _metadata={"path": f"/d/{i}"})

    class QueryFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            if not ingest_done.wait(WAIT_S):
                failures.append("docs did not all arrive")
                return
            for i in range(n_queries):
                answer_seen.clear()
                self.next(query=corpus[(i * 5) % n_docs], k=4)
                if not answer_seen.wait(WAIT_S):
                    failures.append(f"no answer to query {i}")
                    return

    docs = pw.io.python.read(DocFeed(), schema=pw.schema_from_types(data=str, _metadata=dict),
                             autocommit_duration_ms=20)
    store = llm.VectorStoreServer(docs, embedder=embedder, index_capacity=16, **store_kw)
    queries = pw.io.python.read(QueryFeed(), schema=pw.schema_from_types(query=str, k=int),
                                autocommit_duration_ms=None)
    res = store.retrieve_query(queries)

    def on_chunk(key, row, time, is_addition):
        if is_addition:
            chunks[int(key)] = (row["text"], np.asarray(row["emb"], np.float32))
            if len(chunks) == n_docs:
                ingest_done.set()

    def on_answer(key, row, time, is_addition):
        if is_addition:
            answers[len(answers)] = _canon(row["result"])
            answer_seen.set()

    pw.io.subscribe(store.indexed, on_change=on_chunk)
    pw.io.subscribe(res, on_change=on_answer)
    runner = threading.Thread(target=pw.run, daemon=True)
    runner.start()
    runner.join(4 * WAIT_S)
    assert not runner.is_alive(), "pw.run did not end"
    assert not failures, failures
    return corpus, chunks, answers


@pytest.fixture(scope="module")
def encoder_runs():
    from pathway_tpu.models import hf_import as jhf
    from pathway_tpu.xpacks.llm.embedders import TpuEncoderEmbedder
    from pathway_tpu_torch.engine import device_ops as tdo
    from pathway_tpu_torch.models import load_sentence_transformer, params_from_jax
    from pathway_tpu_torch.xpacks.llm import EncoderEmbedder

    import jax
    import jax.numpy as jnp

    load = jhf.load_sentence_transformer

    def load_f32(path, **kw):
        params, cfg, tok = load(path, **kw)
        return params, dataclasses.replace(cfg, dtype=jnp.float32), tok

    mp = pytest.MonkeyPatch()
    mp.setenv("PATHWAY_TPU_DEVICE_OPS", "0")
    tdo.configure(device="cpu")
    mp.setattr(jhf, "load_sentence_transformer", load_f32)
    try:
        JG.clear()
        jemb = TpuEncoderEmbedder(FIXTURE, max_len=32, max_batch_size=8)
        theirs = _streaming_store(jpw, jllm, jemb, n_docs=24, n_queries=6)
        state = params_from_jax(jax.tree_util.tree_map(np.asarray, jemb._params))
    finally:
        mp.undo()
        JG.clear()
    _, cfg, tok = load_sentence_transformer(FIXTURE)
    temb = EncoderEmbedder(dataclasses.replace(cfg, dtype=torch.float32), params=state,
                           tokenizer=tok, max_len=32, max_batch_size=8, device="cpu")
    assert temb.config.hidden == 64 and temb.config.layers == 2
    try:
        ours = _streaming_store(tpw, tllm, temb, n_docs=24, n_queries=6, device="cpu")
    finally:
        TG.clear()
        tdo.configure()
    return ours, theirs


def test_store_over_the_encoder_matches_the_jax_store(encoder_runs):
    (corpus, chunks, ours), (_, their_chunks, theirs) = encoder_runs
    assert set(chunks) == set(their_chunks)  # chunk keys bit for bit
    for key, (text, emb) in chunks.items():
        assert text == their_chunks[key][0]
        np.testing.assert_allclose(emb, their_chunks[key][1], rtol=0, atol=DIST_TOL)
    assert sorted(ours) == sorted(theirs) == list(range(6))
    for i, result in ours.items():
        other = theirs[i]
        assert [(h["text"], h["metadata"]) for h in result] == \
            [(h["text"], h["metadata"]) for h in other]
        np.testing.assert_allclose([h["dist"] for h in result], [h["dist"] for h in other],
                                   rtol=0, atol=DIST_TOL)
        assert result[0]["text"] == corpus[(i * 5) % len(corpus)]


def test_store_answers_equal_an_exact_host_search(encoder_runs):
    """Each answer is the top-k of an exact f32 search over the vectors the index
    received, with dist = 1 - cos."""
    (corpus, chunks, ours), _ = encoder_runs
    keys = sorted(chunks)
    texts = [chunks[k][0] for k in keys]
    mat = np.stack([chunks[k][1] for k in keys])
    for i, result in ours.items():
        qv = mat[texts.index(corpus[(i * 5) % len(corpus)])]
        cos = mat @ qv / (np.linalg.norm(mat, axis=1) * np.linalg.norm(qv))
        order = np.argsort(-cos, kind="stable")[: len(result)]
        assert [h["text"] for h in result] == [texts[j] for j in order]
        np.testing.assert_allclose([h["dist"] for h in result], 1.0 - cos[order], rtol=0, atol=1e-5)
