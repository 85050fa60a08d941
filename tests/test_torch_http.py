"""``pw.io.http`` of the port against the JAX package's: the same ``rest_connector``
programs answering the same POSTs from concurrent clients (a doubling ``select``, and a
retrieval program over the ``tests/fixtures/tiny_bert`` checkpoint with ``DataIndex``),
the ``/_schema`` description, CORS, malformed JSON (400), timeouts (504) and the query
table's update stream with and without ``delete_completed_queries``; the writers
(``http.write``, ``logstash.write``) over an injected ``request_fn`` with their retries;
and the polling reader. Then the port alone: a server whose port is taken raises on the
caller's thread, and ``stop`` closes the port and ends the run.

Each program is built with ``GraphRunner()``, ``attach(result, runner)`` and
``runner.run()`` on a thread, as the reference's servers run it. The JAX package's run
is ended by closing its query reader (its webserver has no stop and serves on, a daemon
thread); the port's by ``PathwayWebserver.stop``.

Tolerances: reply bodies equal; the retrieval program's reply ids equal and its scores
within 1e-5 (two frameworks' f32 model math on the CPU, as ``test_torch_pipeline.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu.internals.runner import GraphRunner as JRunner
from pathway_tpu_torch.engine import device_ops as dops
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.internals.runner import GraphRunner as TRunner

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_bert")
PACKAGES = {"torch": (tpw, TRunner), "jax": (jpw, JRunner)}
WAIT_S = 60.0  # every wait is bounded: a stalled run fails, never hangs
SCORE_TOL = 1e-5


@pytest.fixture(autouse=True)
def _clean():
    dops.configure(device="cpu")
    TG.clear()
    JG.clear()
    yield
    TG.clear()
    JG.clear()
    dops.configure()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(port: int, path: str, body: bytes | None = None, method: str | None = None,
             timeout: float = WAIT_S) -> tuple[int, dict, bytes]:
    """-> (status, headers, body) of one request; an HTTP error status is returned."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method=method,
        headers={"Content-Type": "application/json"} if body is not None else {},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post(port: int, path: str, payload) -> tuple[int, object]:
    code, _h, body = _request(port, path, json.dumps(payload).encode())
    return code, json.loads(body)


class _Served:
    """A rest program of one package, running on a thread: ``build(pw, queries,
    runner)`` -> the result table; the query table's update stream is recorded."""

    def __init__(self, name: str, build, schema_types: dict, route: str = "/q", **kwargs) -> None:
        self.pw, runner_cls = PACKAGES[name]
        self.name = name
        self.port = _free_port()
        self.server = self.pw.io.http.PathwayWebserver(
            "127.0.0.1", self.port, with_cors=kwargs.pop("with_cors", False)
        )
        queries, attach = self.pw.io.http.rest_connector(
            schema=self.pw.schema_from_types(**schema_types), route=route, webserver=self.server,
            **kwargs,
        )
        self.updates: list = []
        self.runner = runner_cls()
        node = self.runner.build(queries)
        self.runner.scope.subscribe_table(
            node, on_change=lambda key, row, time, diff: self.updates.append((diff, tuple(row[1:])))
        )
        attach(build(self.pw, queries, self.runner), self.runner)
        self.thread = threading.Thread(target=self.runner.run, daemon=True)
        self.thread.start()

    def stop(self) -> None:
        if self.name == "torch":
            self.server.stop()
        else:
            for d in self.runner.drivers:
                d.reader.close()
        self.thread.join(WAIT_S)
        assert not self.thread.is_alive(), f"the {self.name} run did not end"


def _concurrent(port: int, path: str, payloads: list) -> list:
    """POST every payload from its own client thread -> the (status, body) of each."""
    out: list = [None] * len(payloads)

    def client(i: int) -> None:
        out[i] = _post(port, path, payloads[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    return out


def test_concurrent_requests_get_the_same_answers_in_both_packages():
    answers = {}
    for name in PACKAGES:
        served = _Served(name, lambda pw, q, _r: q.select(result=pw.this.x * 2), {"x": int},
                         route="/double")
        try:
            answers[name] = _concurrent(served.port, "/double", [{"x": i} for i in range(8)])
        finally:
            served.stop()
    assert answers["torch"] == answers["jax"] == [(200, 2 * i) for i in range(8)]


def test_the_schema_description_and_cors_are_the_same():
    got = {}
    for name in PACKAGES:
        served = _Served(name, lambda pw, q, _r: q.select(result=pw.this.q), {"q": str, "k": int},
                         route="/v1/retrieve", with_cors=True)
        try:
            port = served.port
            code, headers, body = _request(port, "/_schema?format=json")
            desc = json.loads(body)
            assert desc.pop("servers") == [{"url": f"http://127.0.0.1:{port}"}]
            yaml_code, yaml_headers, yaml_body = _request(port, "/_schema")
            answer = _request(port, "/v1/retrieve", json.dumps({"q": "x", "k": 1}).encode())
            preflight = _request(port, "/v1/retrieve", method="OPTIONS")
            get = _request(port, "/v1/retrieve?q=y&k=2", method="GET")
            cors = lambda h: {k: v for k, v in h.items() if k.startswith("Access-Control")}  # noqa: E731
            got[name] = {
                "schema": (code, desc, cors(headers)),
                "yaml": (yaml_code, yaml_headers["Content-Type"],
                         yaml_body.decode().replace(str(port), "PORT")),
                "answer": (answer[0], json.loads(answer[2]), cors(answer[1])),
                "preflight": (preflight[0], cors(preflight[1])),
                "get": (get[0], json.loads(get[2])),
                "bad_format": _request(port, "/_schema?format=xml")[::2],
            }
        finally:
            served.stop()
    assert got["torch"] == got["jax"]
    schema, answer = got["torch"]["schema"], got["torch"]["answer"]
    assert schema[1]["paths"]["/v1/retrieve"]["post"]["requestBody"]["content"][
        "application/json"]["schema"]["properties"] == {"q": {"type": "string"}, "k": {"type": "integer"}}
    assert answer[:2] == (200, "x") and answer[2]["Access-Control-Allow-Origin"] == "*"
    assert got["torch"]["get"] == (200, "y")
    assert got["torch"]["preflight"][1]["Access-Control-Allow-Methods"] == "GET, POST, OPTIONS"


def test_malformed_json_and_timeouts_answer_alike():
    got = {}
    for name in PACKAGES:
        # the filter drops negative x: their answer never comes, so they time out
        served = _Served(name, lambda pw, q, _r: q.filter(pw.this.x >= 0).select(result=pw.this.x),
                         {"x": int}, request_timeout=0.5)
        try:
            port = served.port
            got[name] = [
                _request(port, "/q", b"{not json")[::2],
                _request(port, "/q", b"[1, 2]")[::2],
                _request(port, "/q", json.dumps({"x": -1}).encode())[::2],
                _request(port, "/q", json.dumps({"x": 3}).encode())[::2],
                _request(port, "/q?x=5", method="GET")[::2],
            ]
        finally:
            served.stop()
    assert got["torch"] == got["jax"]
    # a GET's query string stays text, which the filter cannot compare with 0: the row
    # is an error row, never answered, in both packages
    assert [c for c, _b in got["torch"]] == [400, 400, 504, 200, 504]
    assert json.loads(got["torch"][0][1]) == {"error": "invalid json"}
    assert json.loads(got["torch"][1][1]) == {"error": "request body must be a JSON object"}
    assert json.loads(got["torch"][2][1]) == {"error": "timeout"}


@pytest.mark.parametrize("delete_completed_queries", [True, False])
def test_the_query_tables_update_stream_is_the_same(delete_completed_queries):
    streams = {}
    for name in PACKAGES:
        served = _Served(name, lambda pw, q, _r: q.select(result=pw.this.x + 1), {"x": int},
                         delete_completed_queries=delete_completed_queries)
        try:
            for i in range(3):  # one at a time: the stream's order is the requests'
                assert _post(served.port, "/q", {"x": i}) == (200, i + 1)
            deadline = time.monotonic() + WAIT_S
            want = 6 if delete_completed_queries else 3
            while len(served.updates) < want and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            served.stop()
        streams[name] = served.updates
    assert streams["torch"] == streams["jax"]
    want = [(1, (i,)) for i in range(3)]
    if delete_completed_queries:
        want = [u for i in range(3) for u in ((1, (i,)), (-1, (i,)))]
    assert streams["torch"] == want


# -- the retrieval program over tiny_bert -----------------------------------------------

_WORDS = (
    "stream table index vector engine commit window join reduce shard "
    "tensor batch query embed token device mesh scatter gather fuse"
).split()
N_DOCS = 24
K = 4


def _doc_text(i: int) -> str:
    rng = np.random.default_rng(i)
    return " ".join(_WORDS[j] for j in rng.integers(0, len(_WORDS), 8 + int(rng.integers(0, 16))))


def _embedders():
    """Both packages' embedders on the tiny_bert checkpoint, f32 on the CPU."""
    import jax.numpy as jnp

    from pathway_tpu.models import hf_import as jhf
    from pathway_tpu.xpacks.llm.embedders import TpuEncoderEmbedder
    from pathway_tpu_torch.models import load_sentence_transformer
    from pathway_tpu_torch.xpacks.llm import EncoderEmbedder

    load = jhf.load_sentence_transformer

    def load_f32(path, **kw):
        params, cfg, tok = load(path, **kw)
        return params, dataclasses.replace(cfg, dtype=jnp.float32), tok

    mp = pytest.MonkeyPatch()
    mp.setattr(jhf, "load_sentence_transformer", load_f32)
    try:
        jemb = TpuEncoderEmbedder(FIXTURE, max_len=32, max_batch_size=16)
    finally:
        mp.undo()
    state, cfg, tok = load_sentence_transformer(FIXTURE)
    temb = EncoderEmbedder(dataclasses.replace(cfg, dtype=torch.float32), params=state,
                           tokenizer=tok, max_len=32, max_batch_size=16, device="cpu")
    return {"torch": temb, "jax": jemb}


def _retrieval(name: str, embedder) -> tuple[dict, list]:
    """Docs from a static table, embedded and held by DataIndex; each POSTed query text
    embedded by the same UDF and answered as of now with its top-K reply ids and scores.
    -> ({doc key as text: doc_id}, the replies of 8 concurrent clients)."""
    if name == "torch":
        from pathway_tpu_torch.stdlib.indexing import DataIndex, DeviceKnnFactory

        factory = DeviceKnnFactory(dimensions=embedder.get_embedding_dimension(), capacity=32,
                                   device="cpu")
    else:
        from pathway_tpu.stdlib.indexing import DataIndex, TpuKnnFactory

        factory = TpuKnnFactory(dimensions=embedder.get_embedding_dimension(), capacity=32)
    docs_seen: dict = {}
    all_docs = threading.Event()

    def build(pw, queries, runner):
        docs = pw.debug.table_from_rows(pw.schema_from_types(doc_id=int, text=str),
                                        [(i, _doc_text(i)) for i in range(N_DOCS)])
        docs = docs.select(doc_id=pw.this.doc_id, emb=embedder(pw.this.text))
        node = runner.build(docs)

        def on_doc(key, row, time, diff):
            docs_seen[str(key)] = row[0]
            if len(docs_seen) == N_DOCS:
                all_docs.set()

        runner.scope.subscribe_table(node, on_change=on_doc)
        q = queries.select(qemb=embedder(pw.this.text))
        res = DataIndex(docs, factory, docs.emb).query_as_of_now(q, q.qemb, number_of_matches=K)
        return res.select(ids=pw.this._pw_index_reply_ids, scores=pw.this._pw_index_reply_scores)

    served = _Served(name, build, {"text": str})
    try:
        assert all_docs.wait(WAIT_S), f"{len(docs_seen)} of {N_DOCS} docs reached the subscriber"
        replies = _concurrent(served.port, "/q", [{"text": _doc_text(i * 5 % N_DOCS)} for i in range(8)])
    finally:
        served.stop()
    return docs_seen, replies


def test_retrieval_over_http_answers_as_the_jax_package():
    embedders = _embedders()
    got = {name: _retrieval(name, embedders[name]) for name in PACKAGES}
    (tdocs, tans), (jdocs, jans) = got["torch"], got["jax"]
    assert tdocs == jdocs  # the doc keys, as text, bit for bit
    for i, ((tcode, tbody), (jcode, jbody)) in enumerate(zip(tans, jans)):
        assert tcode == jcode == 200
        assert set(tbody) == set(jbody) == {"ids", "scores"}
        assert tbody["ids"] == jbody["ids"] and len(tbody["ids"]) == K
        np.testing.assert_allclose(tbody["scores"], jbody["scores"], rtol=0, atol=SCORE_TOL)
        assert tdocs[tbody["ids"][0]] == i * 5 % N_DOCS  # each query finds its own doc


# -- the writers and the polling reader -------------------------------------------------


def test_http_and_logstash_writers_post_the_same_payloads():
    got = {}
    for name in PACKAGES:
        pw, _ = PACKAGES[name]
        posts: list = []
        t = pw.debug.table_from_rows(pw.schema_from_types(a=int, s=str), [(1, "x"), (2, "y")])
        pw.io.http.write(t, "http://example/in", request_fn=lambda url, p: posts.append(("http", url, p)))
        u = pw.debug.table_from_rows(pw.schema_from_types(a=int), [(5,)])
        pw.io.logstash.write(u, "http://logstash:8012",
                             request_fn=lambda url, p: posts.append(("logstash", url, p)))
        pw.run()
        got[name] = posts
    assert got["torch"] == got["jax"]  # the same payloads in the same order
    assert sorted(p["a"] for _w, _u, p in got["torch"]) == [1, 2, 5]
    assert all(p["diff"] == 1 and "time" in p for _w, _u, p in got["torch"])


@pytest.mark.parametrize("fail_times,n_retries", [(2, 2), (3, 2)])
def test_http_write_retries_follow_the_retry_policy(monkeypatch, fail_times, n_retries):
    got = {}
    for name in PACKAGES:
        pw, _ = PACKAGES[name]
        sleeps: list = []
        calls: list = []
        monkeypatch.setattr(time, "sleep", lambda s: sleeps.append(s))

        def request_fn(url, payload):
            calls.append(payload["a"])
            if len(calls) <= fail_times:
                raise ConnectionError("refused")

        t = pw.debug.table_from_rows(pw.schema_from_types(a=int), [(7,)])
        pw.io.http.write(t, "http://example/in", n_retries=n_retries, request_fn=request_fn,
                         retry_policy=pw.io.http.RetryPolicy(first_delay_ms=100, backoff_factor=3.0))
        try:
            pw.run()
            outcome = "ok"
        except ConnectionError as e:
            outcome = repr(e)
        finally:
            monkeypatch.undo()
        got[name] = (outcome, calls, sleeps)
    assert got["torch"] == got["jax"]
    if fail_times <= n_retries:
        assert got["torch"] == ("ok", [7] * (fail_times + 1), pytest.approx([0.1, 0.3]))
    else:
        assert got["torch"][0] == "ConnectionError('refused')" and len(got["torch"][1]) == n_retries + 1


def test_the_polling_reader_replaces_instead_of_accumulating():
    bodies = ['{"a": 1}\n{"a": 2}', '{"a": 1}\n{"a": 2}', '{"a": 7}\n{"a": 8}']
    got = {}
    for name in PACKAGES:
        pw, runner_cls = PACKAGES[name]
        calls = {"n": 0}

        def fake_get(url):
            i = min(calls["n"], len(bodies) - 1)
            calls["n"] += 1
            return bodies[i]

        t = pw.io.http.read("http://x/feed", schema=pw.schema_from_types(a=int), poll_interval_ms=0,
                            request_fn=fake_get)
        runner = runner_cls()
        node = runner.build(t)
        sched = __import__(f"{pw.__name__}.engine.graph", fromlist=["Scheduler"]).Scheduler(runner.scope)
        states = []
        for _ in range(3):
            for d in runner.drivers:
                d.poll()
            sched.commit()
            states.append(sorted((int(k), v) for k, v in node.current.items()))
        got[name] = states
    assert got["torch"] == got["jax"]
    assert [sorted(v[0] for _k, v in s) for s in got["torch"]] == [[1, 2], [1, 2], [7, 8]]


# -- the port alone -------------------------------------------------------------------


def test_a_server_whose_port_is_taken_raises_on_the_callers_thread():
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen()
        port = busy.getsockname()[1]
        server = tpw.io.http.PathwayWebserver("127.0.0.1", port)
        with pytest.raises(OSError):
            server.start()
        assert not server._thread.is_alive()


def test_stop_closes_the_port_and_ends_the_run():
    served = _Served("torch", lambda pw, q, _r: q.select(result=pw.this.x), {"x": int})
    assert _post(served.port, "/q", {"x": 4}) == (200, 4)
    served.stop()
    with pytest.raises(ConnectionRefusedError):
        socket.create_connection(("127.0.0.1", served.port), timeout=5).close()
    assert not served.server._thread.is_alive()
