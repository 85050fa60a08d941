"""The port's RAG question answerers (``pathway_tpu_torch/xpacks/llm/question_answering``)
against the JAX package's on the same store, prompts and chats: ``BaseRAGQuestionAnswerer``
and ``AdaptiveRAGQuestionAnswerer`` (its async UDF over ``llm.execute_rows``) through
``pw.debug.table_to_dicts``, with the mock chats, a scripted chat that finds its answer
only once it sees enough documents, and a remote chat over an injected async client;
``answer_with_geometric_rag_strategy`` on its own; ``summarize_query``. The store is
BM25 or KNN over ``mocks.FakeEmbedder``; everything compared is exact text, but the
context docs' KNN ``dist``, held within 1e-6 (an f32 matmul summed in another order)."""

from __future__ import annotations

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu.xpacks.llm as jllm
import pathway_tpu_torch as tpw
import pathway_tpu_torch.xpacks.llm as tllm
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch.engine import device_ops
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.internals.udfs.executors import stop_event_loop

_WORDS = "stream table index vector engine commit window join reduce shard tensor batch".split()
PROMPTS = ["stream join", "tensor batch shard", "window", "nothing here"]
KNN_DIST_TOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu_operators(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")
    device_ops.configure(device="cpu")
    yield
    device_ops.configure()
    stop_event_loop()
    TG.clear()
    JG.clear()


def _docs(n: int = 12) -> list[tuple]:
    rng = np.random.default_rng(9)
    return [
        (" ".join(_WORDS[j] for j in rng.integers(0, len(_WORDS), 5)), {"path": f"/r/{i}"})
        for i in range(n)
    ]


def _canon(v):
    if isinstance(v, tuple):
        return tuple(_canon(x) for x in v)
    if isinstance(v, dict):
        return {k: _canon(x) for k, x in v.items()}
    if type(v).__name__ == "Json":
        return _canon(v.value)
    return v


def _store(pw, llm, factory):
    docs = pw.debug.table_from_rows(pw.schema_from_types(data=str, _metadata=dict), _docs())
    return llm.DocumentStore(docs, embedder=llm.mocks.FakeEmbedder(8), retriever_factory=factory,
                             **({"device": "cpu"} if llm is tllm else {}))


def _scripted(udfs, enough: int):
    """A chat that answers only when its prompt holds at least ``enough`` articles,
    else says it found nothing (``prompt_qa`` separates articles by blank lines)."""

    def chat(prompt: str) -> str:
        articles = prompt.split("Articles:\n", 1)[1].split("\n\nQuestion:", 1)[0]
        n = len(articles.split("\n\n")) if articles else 0
        return f"answer from {n} articles" if n >= enough else "No information found."

    return udfs.udf(chat)


def _remote(llm):
    async def client(model, prompt, **kw):
        return f"{model}:{len(prompt)}"

    return llm.llms.OpenAIChat(model="remote", client=client)


CHATS = {
    "identity": lambda pw, llm: llm.mocks.IdentityMockChat("m"),
    "fake": lambda pw, llm: llm.mocks.FakeChatModel("canned"),
    "scripted": lambda pw, llm: _scripted(pw, enough=3),
    "remote": lambda pw, llm: _remote(llm),
}


def _answers(pw, table):
    data, names = pw.debug.table_to_dicts(table)
    return names, [
        (data[key]["result"], _canon(data[key]["context_docs"])) for key in sorted(data, key=int)
    ]


def _same(ours, theirs, factory):
    (names, rows), (their_names, their_rows) = ours, theirs
    assert names == their_names == ["result", "context_docs"]
    assert len(rows) == len(their_rows) == len(PROMPTS)
    for (result, docs), (their_result, their_docs) in zip(rows, their_rows):
        assert result == their_result
        assert [(d["text"], d["metadata"]) for d in docs] == \
            [(d["text"], d["metadata"]) for d in their_docs]
        tol = KNN_DIST_TOL if factory == "knn" else 0.0
        np.testing.assert_allclose([d["dist"] for d in docs], [d["dist"] for d in their_docs],
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("chat", sorted(CHATS))
@pytest.mark.parametrize("factory", ["bm25", "knn"])
def test_base_rag_matches_jax(chat, factory):
    out = []
    for pw, llm in ((tpw, tllm), (jpw, jllm)):
        store = _store(pw, llm, factory)
        rag = llm.BaseRAGQuestionAnswerer(CHATS[chat](pw, llm), store, search_topk=4)
        q = pw.debug.table_from_rows(pw.schema_from_types(prompt=str), [(p,) for p in PROMPTS])
        out.append(_answers(pw, rag.answer_query(q)))
    _same(out[0], out[1], factory)


@pytest.mark.parametrize("chat", sorted(CHATS))
@pytest.mark.parametrize("factory", ["bm25", "knn"])
def test_adaptive_rag_matches_jax(chat, factory):
    """The async expansion UDF: the same replies; the scripted chat answers after one
    expansion (2 then 4 documents), the echo never finds its answer."""
    out = []
    for pw, llm in ((tpw, tllm), (jpw, jllm)):
        store = _store(pw, llm, factory)
        rag = llm.AdaptiveRAGQuestionAnswerer(
            CHATS[chat](pw, llm), store, n_starting_documents=2, factor=2, max_iterations=3,
            search_topk=6,
        )
        q = pw.debug.table_from_rows(pw.schema_from_types(prompt=str), [(p,) for p in PROMPTS])
        out.append(_answers(pw, rag.answer_query(q)))
    _same(out[0], out[1], factory)
    results = [r for r, _d in out[0][1]]
    if chat == "scripted":
        assert "answer from 4 articles" in results
    if chat == "identity":
        assert set(results) == {"No information found."}


@pytest.mark.parametrize("n_docs", [0, 1, 3, 9])
@pytest.mark.parametrize("enough", [1, 3, 8, 50])
def test_geometric_strategy_matches_jax(n_docs, enough):
    docs = [f"doc {i}" for i in range(n_docs)]
    calls: dict = {"port": [], "jax": []}

    def make(name):
        def llm_call(prompt):
            calls[name].append(prompt)
            n = prompt.count("doc ")
            return "found it" if n >= enough else "sorry: no information found."

        return llm_call

    ours = tllm.answer_with_geometric_rag_strategy("q?", docs, make("port"), max_iterations=5)
    theirs = jllm.answer_with_geometric_rag_strategy("q?", docs, make("jax"), max_iterations=5)
    assert ours == theirs and calls["port"] == calls["jax"]


def test_summarize_query_matches_jax():
    out = []
    for pw, llm in ((tpw, tllm), (jpw, jllm)):
        store = _store(pw, llm, "bm25")
        rag = llm.question_answering.SummaryQuestionAnswerer(llm.mocks.IdentityMockChat("s"), store)
        q = pw.debug.table_from_rows(
            pw.schema_from_types(text_list=tuple), [(("a", "b"),), (("one",),)]
        )
        data, _ = pw.debug.table_to_dicts(rag.summarize_query(q))
        out.append(sorted(r["result"] for r in data.values()))
    assert out[0] == out[1] and len(out[0]) == 2


def test_rag_client_endpoints():
    ours, theirs = tllm.RAGClient(port=9), jllm.RAGClient(port=9)
    assert ours.base == theirs.base == "http://127.0.0.1:9"
    assert tllm.RAGClient.pw_ai_answer is tllm.RAGClient.answer
