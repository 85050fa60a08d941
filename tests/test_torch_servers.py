"""The port's REST servers (``xpacks/llm/servers.py``: ``BaseRestServer``,
``DocumentStoreServer``, ``QARestServer``, ``QASummaryRestServer``),
``VectorStoreServer.run_server`` and the remote embedders (``OpenAIEmbedder``,
``LiteLLMEmbedder``, ``GeminiEmbedder``) against the JAX package's.

Each server runs threaded on a free port of its own in both packages over the same
seeded documents (``mocks.FakeEmbedder``) and answers the same requests; the answers
are compared: texts, metadata and order exactly, ``dist`` within ``KNN_DIST_TOL``
(an f32 cosine that torch and XLA sum in another order), counts, inputs and chat
answers exactly. The port's servers are stopped, and their ports are closed after;
the JAX package's have no stop and run on as daemon threads. The remote embedders
run over an injected client, sync or async, with no network. Every HTTP call has its
own timeout.
"""

from __future__ import annotations

import asyncio
import json
import socket
import time
import urllib.error
import urllib.request

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

KNN_DIST_TOL = 1e-6
WAIT_S = 30.0
_WORDS = "stream table index vector engine commit window join reduce shard tensor batch".split()
BOTH = ((tpw, tllm), (jpw, jllm))


@pytest.fixture(autouse=True)
def _cpu_operators(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")
    device_ops.configure(device="cpu")
    yield
    device_ops.configure()
    stop_event_loop()
    TG.clear()
    JG.clear()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _post(port: int, path: str, payload: dict, timeout: float = 10.0):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _post_until(port: int, path: str, payload: dict, done=bool):
    """POST until ``done(body)`` (the docs' commit may not have landed yet)."""
    deadline = time.monotonic() + WAIT_S
    while True:
        try:
            status, body = _post(port, path, payload)
            if done(body) or time.monotonic() > deadline:
                return status, body
        except (urllib.error.URLError, ConnectionError):
            if time.monotonic() > deadline:
                raise
        time.sleep(0.05)


def _closed(port: int) -> bool:
    try:
        socket.create_connection(("127.0.0.1", port), timeout=2).close()
    except OSError:
        return True
    return False


def _text(i: int) -> str:
    rng = np.random.default_rng(200 + i)
    return " ".join(_WORDS[j] for j in rng.integers(0, len(_WORDS), 5))


def _docs(pw, n: int = 10):
    schema = pw.schema_from_types(data=str, _metadata=dict)
    return pw.debug.table_from_rows(schema, [(_text(i), {"path": f"/s/{i}.txt"}) for i in range(n)])


def _cpu(llm) -> dict:
    return {"device": "cpu"} if llm is tllm else {}


def _assert_same_hits(ours, theirs):
    assert [(h["text"], h["metadata"]) for h in ours] == [(h["text"], h["metadata"]) for h in theirs]
    np.testing.assert_allclose([h["dist"] for h in ours], [h["dist"] for h in theirs],
                               rtol=0, atol=KNN_DIST_TOL)


def test_qa_style_server_class():
    """``BaseRestServer.serve`` and a threaded run, the shape every xpack server has
    (``tests/test_rest_roundtrip.py::test_qa_style_server_class``)."""
    answers = []
    handle = None
    for pw, llm in BOTH:
        servers = __import__(f"{pw.__name__}.xpacks.llm.servers", fromlist=["x"])
        port = _free_port()
        server = servers.BaseRestServer("127.0.0.1", port)
        server.serve("/echo", pw.schema_from_types(text=str),
                     lambda q, pw=pw: q.select(result=pw.this.text + "!"))
        h = server.run(threaded=True)
        if pw is tpw:
            handle, port_ours = h, port
        answers.append(_post_until(port, "/echo", {"text": "hello"}))
    assert answers[0] == answers[1] == (200, "hello!")
    handle.stop()
    assert _closed(port_ours) and not handle.thread.is_alive()


def test_document_store_server_roundtrip():
    """``DocumentStoreServer``'s three routes answer as the JAX package's
    (``tests/test_xpack_llm.py``'s ``test_document_store_server_roundtrip``)."""
    answers = []
    for pw, llm in BOTH:
        servers = __import__(f"{pw.__name__}.xpacks.llm.servers", fromlist=["x"])
        store = llm.DocumentStore(_docs(pw), embedder=llm.mocks.FakeEmbedder(dim=16),
                                  index_capacity=32, **_cpu(llm))
        port = _free_port()
        handle = servers.DocumentStoreServer("127.0.0.1", port, store).run(threaded=True)
        retrieved = [_post_until(port, "/v1/retrieve", {"query": _text(i), "k": 3})[1]
                     for i in (1, 4, 7)]
        _, stats = _post_until(port, "/v1/statistics", {}, done=lambda b: b.get("count") == 10)
        _, inputs = _post(port, "/v1/inputs", {})
        answers.append((retrieved, stats,
                        None if inputs is None else sorted(json.dumps(m, sort_keys=True) for m in inputs)))
        if pw is tpw:
            handle.stop()
            assert _closed(port)
    (r0, s0, i0), (r1, s1, i1) = answers
    for ours, theirs in zip(r0, r1):
        _assert_same_hits(ours, theirs)
    assert [hits[0]["text"] for hits in r0] == [_text(i) for i in (1, 4, 7)]
    assert s0 == s1 == {"count": 10}
    # the port answers /v1/inputs with every document's metadata; the JAX package's
    # server answers it with null (a fault of the reference, ROADMAP queue 3)
    assert i0 == sorted(json.dumps({"path": f"/s/{i}.txt"}) for i in range(10))
    assert i1 is None


def test_run_server_answers_as_the_jax_package():
    """``VectorStoreServer.run_server`` (threaded) and ``VectorStoreClient``: the
    port's ``/v1/retrieve`` answers equal the JAX package's on the same docs."""
    answers = []
    for pw, llm in BOTH:
        server = llm.VectorStoreServer(_docs(pw, 12), embedder=llm.mocks.FakeEmbedder(12),
                                       index_capacity=16, **_cpu(llm))
        port = _free_port()
        handle = server.run_server(port=port, threaded=True)
        client = llm.VectorStoreClient(port=port)
        deadline = time.monotonic() + WAIT_S
        while not _post_until(port, "/v1/retrieve", {"query": _text(0), "k": 1})[1] and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        answers.append([client.query(_text(i), k=4) for i in range(0, 12, 3)])
        if pw is tpw:
            assert client.get_vectorstore_statistics() == {"count": 12}
            handle.stop()
            assert _closed(port)
    for ours, theirs in zip(*answers):
        _assert_same_hits(ours, theirs)
        assert len(ours) == 4
    assert [hits[0]["text"] for hits in answers[0]] == [_text(i) for i in range(0, 12, 3)]


def test_qa_rest_server_and_summary_route():
    """``QARestServer`` (``/v1/pw_ai_answer`` and its ``/v1/retrieve`` passthrough)
    and ``QASummaryRestServer`` (``/v1/pw_ai_summary``) answer as the JAX package's,
    over the identity mock chat."""
    answers = []
    for pw, llm in BOTH:
        servers = __import__(f"{pw.__name__}.xpacks.llm.servers", fromlist=["x"])
        store = llm.DocumentStore(_docs(pw, 8), embedder=llm.mocks.FakeEmbedder(dim=16),
                                  index_capacity=16, **_cpu(llm))
        rag = llm.BaseRAGQuestionAnswerer(llm.mocks.IdentityMockChat(), store, search_topk=2)
        port = _free_port()
        handle = servers.QASummaryRestServer("127.0.0.1", port, rag).run(threaded=True)
        _, retrieved = _post_until(port, "/v1/retrieve", {"query": _text(2), "k": 2})
        _, answer = _post_until(port, "/v1/pw_ai_answer", {"prompt": _text(2)},
                                done=lambda b: _text(2) in json.dumps(b.get("context_docs", [])))
        _, summary = _post(port, "/v1/pw_ai_summary", {"text_list": ["one", "two"]})
        answers.append((retrieved, answer, summary))
        if pw is tpw:
            handle.stop()
            assert _closed(port)
    (r0, a0, s0), (r1, a1, s1) = answers
    _assert_same_hits(r0, r1)
    assert r0[0]["text"] == _text(2)
    assert a0["result"] == a1["result"] and a0["result"].startswith("mock: ")
    _assert_same_hits(a0["context_docs"], a1["context_docs"])
    assert s0 == s1 and "one" in s0 and "two" in s0


def test_a_threaded_run_that_raises_reaches_join_and_stop(monkeypatch):
    """Deliberate difference: what a threaded server run raises is kept on its
    ``ServerHandle`` and raised by ``join`` and ``stop``; the reference's thread
    drops it."""
    from pathway_tpu_torch.internals import runner as runner_mod
    from pathway_tpu_torch.xpacks.llm import servers

    def broken(self):
        raise RuntimeError("CUDA error: device-side assert triggered")

    monkeypatch.setattr(runner_mod.GraphRunner, "run", broken)
    port = _free_port()
    server = servers.BaseRestServer("127.0.0.1", port)
    server.serve("/echo", tpw.schema_from_types(text=str), lambda q: q.select(result=tpw.this.text))
    handle = server.run(threaded=True)
    handle.thread.join(WAIT_S)
    with pytest.raises(RuntimeError, match="device-side assert"):
        handle.join()
    with pytest.raises(RuntimeError, match="device-side assert"):
        handle.stop()
    assert _closed(port)


def _vector_of(text: str, dim: int = 5) -> list[float]:
    rng = np.random.default_rng(sum(map(ord, text)))
    return rng.standard_normal(dim).astype(np.float32).tolist()


@pytest.mark.parametrize("name", ["OpenAIEmbedder", "LiteLLMEmbedder", "GeminiEmbedder"])
@pytest.mark.parametrize("asynchronous", [False, True])
def test_remote_embedders_over_an_injected_client(name, asynchronous):
    """Each remote embedder calls its client with its model and the text and returns
    the client's vector as host f32, in a ``select`` as the JAX package's does."""
    answers = []
    for pw, _llm in BOTH:
        embedders = __import__(f"{pw.__name__}.xpacks.llm.embedders", fromlist=["x"])
        calls: list = []

        def sync_client(model, input, **kw):
            calls.append((model, input, kw))
            return _vector_of(input)

        async def async_client(model, input, **kw):
            await asyncio.sleep(0)
            return sync_client(model, input, **kw)

        embedder = getattr(embedders, name)(client=async_client if asynchronous else sync_client,
                                            user="t")
        texts = pw.debug.table_from_rows(pw.schema_from_types(text=str),
                                         [(_text(i),) for i in range(4)])
        rows, _ = pw.debug.table_to_dicts(texts.select(text=texts.text, emb=embedder(texts.text)))
        got = sorted((r["text"], np.asarray(r["emb"]).dtype.name, np.asarray(r["emb"]).tolist())
                     for r in rows.values())
        assert {c[0] for c in calls} == {embedder.model} and {c[2]["user"] for c in calls} == {"t"}
        answers.append(got)
    assert answers[0] == answers[1]
    assert [g[1] for g in answers[0]] == ["float32"] * 4
    assert [g[2] for g in answers[0]] == [_vector_of(t) for t, _, _ in answers[0]]
