"""The streaming-RAG pipeline as ``bench.py::pipeline_leg`` writes it (python connector
-> embedder UDF -> DataIndex -> as-of-now query -> subscribe), at tiny size, run through
``pathway_tpu.run()`` with ``TpuEncoderEmbedder`` and through ``pathway_tpu_torch.run()``
with ``EncoderEmbedder``, both on the committed ``tests/fixtures/tiny_bert`` checkpoint
in f32 on the CPU. Every doc is committed before the first query is sent, so as-of-now
answers are deterministic.

Tolerances: doc keys and reply ids bit for bit (the keys are content hashes, the hits
an exact f32 search whose order both packages fix the same way); embeddings and reply
scores within 1e-5 (f32 model math on the CPU, where only the order of sums differs).
"""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_bert")
N_DOCS = 40
N_QUERIES = 6
K = 4
WAIT_S = 60.0  # every wait is bounded: a stalled pipeline fails, never hangs
TOL = 1e-5

_WORDS = (
    "stream table index vector engine commit window join reduce shard "
    "tensor batch query embed token device mesh scatter gather fuse"
).split()


def _doc_text(i: int) -> str:
    """The bench's generated doc text (bench.py ``_doc_text``)."""
    rng = np.random.default_rng(i)
    n = 8 + int(rng.integers(0, 24))
    return " ".join(_WORDS[j] for j in rng.integers(0, len(_WORDS), n))


def _pipeline(pw, data_index_cls, factory, embedder) -> tuple[dict, dict]:
    """``pipeline_leg``'s program against the package ``pw`` -> ({doc key: (doc_id,
    embedding)}, {query_id: (reply ids, reply scores, query embedding)})."""
    ingest_done = threading.Event()
    answer_seen = threading.Event()
    docs_seen: dict = {}
    answers: dict = {}
    failures: list = []
    corpus = [_doc_text(i) for i in range(N_DOCS)]

    class DocFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for i in range(N_DOCS):
                self.next(doc_id=i, text=corpus[i])

    class QueryFeed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            if not ingest_done.wait(WAIT_S):
                failures.append("docs did not all arrive")
                return
            for i in range(N_QUERIES):
                answer_seen.clear()
                self.next(query_id=i, text=_doc_text(i * 7 % N_DOCS))
                if not answer_seen.wait(WAIT_S):
                    failures.append(f"no answer to query {i}")
                    return

    docs = pw.io.python.read(
        DocFeed(), schema=pw.schema_from_types(doc_id=int, text=str),
        autocommit_duration_ms=50,
    )
    docs = docs.select(doc_id=pw.this.doc_id, emb=embedder(pw.this.text))
    queries = pw.io.python.read(
        QueryFeed(), schema=pw.schema_from_types(query_id=int, text=str),
        autocommit_duration_ms=None,
    )
    queries = queries.select(query_id=pw.this.query_id, qemb=embedder(pw.this.text))
    res = data_index_cls(docs, factory, docs.emb).query_as_of_now(
        queries, queries.qemb, number_of_matches=K
    )

    def on_doc(key, row, time, is_addition):
        if is_addition:
            docs_seen[key] = (row["doc_id"], np.asarray(row["emb"], np.float32))
            if len(docs_seen) == N_DOCS:
                ingest_done.set()

    def on_answer(key, row, time, is_addition):
        if is_addition:
            answers[row["query_id"]] = (
                tuple(row["_pw_index_reply_ids"]),
                tuple(row["_pw_index_reply_scores"]),
                np.asarray(row["qemb"], np.float32),
            )
            answer_seen.set()

    pw.io.subscribe(docs, on_change=on_doc)
    pw.io.subscribe(res, on_change=on_answer)
    runner = threading.Thread(target=pw.run, daemon=True)
    runner.start()
    runner.join(4 * WAIT_S)
    assert not runner.is_alive(), "pw.run did not end"
    assert not failures, failures
    return docs_seen, answers


@pytest.fixture(scope="module")
def runs():
    import pathway_tpu as jpw
    from pathway_tpu.internals.parse_graph import G as JG
    from pathway_tpu.models import hf_import as jhf
    from pathway_tpu.stdlib.indexing import DataIndex as JDataIndex
    from pathway_tpu.stdlib.indexing import TpuKnnFactory
    from pathway_tpu.xpacks.llm.embedders import TpuEncoderEmbedder

    import pathway_tpu_torch as tpw
    from pathway_tpu_torch.models import load_sentence_transformer
    from pathway_tpu_torch.stdlib.indexing import DataIndex, DeviceKnnFactory
    from pathway_tpu_torch.xpacks.llm import EncoderEmbedder

    import jax.numpy as jnp

    # f32 compute on both sides: the JAX embedder takes its config from the
    # checkpoint loader, so the test hands it an f32 config through that seam
    load = jhf.load_sentence_transformer

    def load_f32(path, **kw):
        params, cfg, tok = load(path, **kw)
        return params, dataclasses.replace(cfg, dtype=jnp.float32), tok

    mp = pytest.MonkeyPatch()
    mp.setattr(jhf, "load_sentence_transformer", load_f32)
    try:
        JG.clear()
        jemb = TpuEncoderEmbedder(FIXTURE, max_len=32, max_batch_size=16)
        jdim = jemb.get_embedding_dimension()
        theirs = _pipeline(jpw, JDataIndex, TpuKnnFactory(dimensions=jdim, capacity=16), jemb)
    finally:
        mp.undo()

    state, cfg, tok = load_sentence_transformer(FIXTURE)
    temb = EncoderEmbedder(
        dataclasses.replace(cfg, dtype=torch.float32), params=state, tokenizer=tok,
        max_len=32, max_batch_size=16, device="cpu",
    )
    factory = DeviceKnnFactory(dimensions=temb.get_embedding_dimension(), capacity=16, device="cpu")
    ours = _pipeline(tpw, DataIndex, factory, temb)
    return ours, theirs


def test_doc_keys_and_embeddings_match_the_jax_pipeline(runs):
    (ours, _), (theirs, _) = runs
    assert len(ours) == len(theirs) == N_DOCS
    assert set(ours) == set(theirs)  # keys bit for bit
    assert all(int(k) == int(j) for k, j in zip(sorted(ours), sorted(theirs)))
    for key, (doc_id, emb) in ours.items():
        their_id, their_emb = theirs[key]
        assert doc_id == their_id
        assert emb.shape == their_emb.shape == (64,)
        np.testing.assert_allclose(emb, their_emb, rtol=0, atol=TOL)


def test_replies_match_the_jax_pipeline(runs):
    (_, ours), (_, theirs) = runs
    assert sorted(ours) == sorted(theirs) == list(range(N_QUERIES))
    for qid, (ids, scores, qemb) in ours.items():
        their_ids, their_scores, their_qemb = theirs[qid]
        assert len(ids) == K
        assert ids == their_ids  # exactly: the same keys in the same order
        np.testing.assert_allclose(scores, their_scores, rtol=0, atol=TOL)
        np.testing.assert_allclose(qemb, their_qemb, rtol=0, atol=TOL)


def test_every_query_finds_its_own_doc(runs):
    (docs, answers), _ = runs
    key_of = {doc_id: key for key, (doc_id, _emb) in docs.items()}
    for qid, (ids, _scores, _qemb) in answers.items():
        assert ids[0] == key_of[qid * 7 % N_DOCS]


def test_collapse_rows_false_is_not_ported_yet():
    """``query_as_of_now(collapse_rows=False)``: one row per (query, hit), with the
    query id, rank, hit id and score, and a rank -1 sentinel row for a query with no
    hit; row ids, hits and scores equal the JAX package's bit for bit."""
    import pathway_tpu as jpw
    import pathway_tpu_torch as tpw
    from pathway_tpu.stdlib.indexing import DataIndex as JDataIndex
    from pathway_tpu.stdlib.indexing import HostKnnFactory as JHostKnnFactory
    from pathway_tpu_torch.stdlib.indexing import DataIndex, HostKnnFactory

    rng = np.random.default_rng(3)
    vecs = [tuple(float(x) for x in v) for v in rng.normal(size=(6, 4)).astype(np.float32)]
    qvecs = [tuple(float(x) for x in v) for v in rng.normal(size=(3, 4)).astype(np.float32)]

    def program(pw, data_index, factory):
        docs = pw.debug.table_from_rows(pw.schema_from_types(v=tuple), [(v,) for v in vecs])
        queries = pw.debug.table_from_rows(
            pw.schema_from_types(q=tuple, k=int), [(qvecs[0], 2), (qvecs[1], 0), (qvecs[2], 4)]
        )
        index = data_index(docs, factory(dimensions=4, capacity=8), docs.v)
        flat = index.query_as_of_now(
            queries, queries.q, number_of_matches=queries.k, collapse_rows=False
        )
        data, names = pw.debug.table_to_dicts(flat)
        return names, {int(k): {n: (int(v) if n.endswith("_id") and v is not None else v)
                                 for n, v in row.items()} for k, row in data.items()}

    ours = program(tpw, DataIndex, HostKnnFactory)
    theirs = program(jpw, JDataIndex, JHostKnnFactory)
    assert ours == theirs
    names, rows = ours
    assert names == ["_pw_query_id", "_pw_index_reply_rank", "_pw_index_reply_id",
                     "_pw_index_reply_score"]
    ranks = sorted(r["_pw_index_reply_rank"] for r in rows.values())
    assert ranks == [-1, 0, 0, 1, 1, 2, 3]  # k = 2 and 4 hits, and the k = 0 sentinel
