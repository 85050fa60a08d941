"""The port's rerankers (``pathway_tpu_torch.xpacks.llm.rerankers``) and cross-encoder
(``CrossEncoder``, ``cross_encode``) against the JAX package's on the same weights,
carried over by ``params_from_jax``. Texts come from the bench's generator with a seed.

Tolerances: scores are logits, compared relative to max(1, |x|): 1e-4 in f32 (the same
arithmetic, summed in another order) and 2e-2 in bf16 (bf16 activations round an ulp
apart here and there); cosine scores of f32 embeddings 1e-5. ``rerank_topk_filter``
and the LLM judge's scores are exact.
"""

import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.models import transformer as jt
from pathway_tpu_torch.models import transformer as tt

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_bert")
SMALL = dict(vocab_size=512, hidden=64, layers=2, heads=4, intermediate=128, max_len=64)
WAIT_S = 60.0  # every wait is bounded: a stalled pipeline fails, never hangs

_WORDS = (
    "stream table index vector engine commit window join reduce shard "
    "tensor batch query embed token device mesh scatter gather fuse"
).split()


def _doc_text(i: int) -> str:
    """The bench's generated doc text (bench.py ``_doc_text``)."""
    rng = np.random.default_rng(i)
    n = 8 + int(rng.integers(0, 24))
    return " ".join(_WORDS[j] for j in rng.integers(0, len(_WORDS), n))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())


def _state(jax_tree):
    return tt.params_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree))


@pytest.fixture(scope="module")
def minilm_params():
    return jt.init_cross_encoder_params(jax.random.key(1), jt.minilm_l6())


def test_cross_encoder_param_names_follow_the_jax_pytree(minilm_params):
    model = tt.CrossEncoder(tt.EncoderConfig(**SMALL), device="cpu", seed=3)
    small = jt.init_cross_encoder_params(jax.random.key(0), jt.EncoderConfig(**SMALL))
    assert set(_state(small)) == set(model.state_dict())
    assert model.head_w.shape == (64, 1) and model.head_w.dtype == torch.float32
    assert float(model.head_w.std()) > 0 and torch.equal(model.head_b, torch.zeros(1))


@pytest.mark.parametrize(
    "jdtype,tdtype,tol", [(jnp.float32, torch.float32, 1e-4), (jnp.bfloat16, torch.bfloat16, 2e-2)]
)
def test_cross_encode_matches_jax(jdtype, tdtype, tol):
    params = jt.init_cross_encoder_params(jax.random.key(2), jt.EncoderConfig(**SMALL))
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 512, (6, 16)).astype(np.int32)
    mask = np.arange(16)[None, :] < rng.integers(3, 17, 6)[:, None]
    ids[~mask] = 0
    theirs = jt.cross_encode(params, jnp.asarray(ids), jnp.asarray(mask),
                             jt.EncoderConfig(**SMALL, dtype=jdtype))
    model = tt.CrossEncoder(tt.EncoderConfig(**SMALL, dtype=tdtype), device="cpu", seed=None)
    model.load_state_dict(_state(params))
    ours = tt.cross_encode(model, torch.from_numpy(ids), torch.from_numpy(mask))
    assert ours.shape == (6,) and ours.dtype == torch.float32
    assert _rel(ours.numpy(), theirs) < tol


def _pairs(n):
    return [_doc_text(i) for i in range(n)], [_doc_text(i * 7 + 1) for i in range(n)]


def test_cross_encoder_reranker_matches_jax(minilm_params):
    """MiniLM-L6 at full width in bf16, as both rerankers run it, on 11 pairs padded
    to a batch of 16."""
    from pathway_tpu.xpacks.llm.rerankers import CrossEncoderReranker as JReranker
    from pathway_tpu_torch.xpacks.llm import CrossEncoderReranker

    docs, queries = _pairs(11)
    theirs = JReranker(params=minilm_params)._fn(docs, queries)
    ours = CrossEncoderReranker(params=_state(minilm_params), device="cpu")._fn(docs, queries)
    assert len(ours) == 11 and all(isinstance(s, float) for s in ours)
    assert _rel(ours, theirs) < 2e-2


def test_cross_encoder_reranker_through_pw_run_gives_the_direct_scores(minilm_params):
    """A two-column batch UDF in ``select``: each (doc, query) row's score through the
    port's ``pw.run`` equals the direct call's on the same chunk of pairs (the chunk
    sets the padded shape, and a bf16 matmul's rows may round apart across shapes)."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.xpacks.llm import CrossEncoderReranker

    docs, queries = _pairs(10)
    rr = CrossEncoderReranker(params=_state(minilm_params), max_batch_size=4, device="cpu")
    chunks, score_batch = [], rr._fn

    def recorded(d, q):
        chunks.append((list(d), list(q)))
        return score_batch(d, q)

    rr._fn = recorded
    scores, done = {}, threading.Event()

    class Feed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for i, (d, q) in enumerate(zip(docs, queries)):
                self.next(pair_id=i, doc=d, query=q)

    rows = pw.io.python.read(Feed(), schema=pw.schema_from_types(pair_id=int, doc=str, query=str),
                             autocommit_duration_ms=50)
    scored = rows.select(pair_id=pw.this.pair_id, score=rr(pw.this.doc, pw.this.query))

    def on_change(key, row, time, is_addition):
        if is_addition:
            scores[row["pair_id"]] = row["score"]
            if len(scores) == len(docs):
                done.set()

    pw.io.subscribe(scored, on_change=on_change)
    runner = threading.Thread(target=pw.run, daemon=True)
    runner.start()
    runner.join(4 * WAIT_S)
    assert not runner.is_alive(), "pw.run did not end"
    assert done.is_set()
    assert chunks and max(len(d) for d, _q in chunks) <= 4
    direct = {d: s for dd, qq in chunks for d, s in zip(dd, score_batch(dd, qq))}
    assert sorted(direct) == sorted(docs)
    assert [scores[i] for i in range(len(docs))] == [direct[d] for d in docs]


def test_rerank_topk_filter_matches_jax():
    from pathway_tpu.xpacks.llm.rerankers import rerank_topk_filter as jfilter
    from pathway_tpu_torch.xpacks.llm import rerank_topk_filter

    docs = tuple(f"d{i}" for i in range(7))
    scores = (0.3, 0.9, -1.0, 0.9, 0.5, 0.1, 0.7)  # a tie, kept in doc order
    for k in (1, 3, 5, 10):
        assert rerank_topk_filter(docs, scores, k) == jfilter(docs, scores, k)
    assert rerank_topk_filter(docs, scores, 3) == (("d1", "d3", "d6"), (0.9, 0.9, 0.7))


def test_encoder_reranker_matches_jax(monkeypatch):
    """Cosine scores over the hidden-64 ``tests/fixtures/tiny_bert`` embedder in f32,
    the port's ``EncoderEmbedder`` (lazy rows, read through ``__array__``) against the
    JAX package's."""
    from pathway_tpu.models import hf_import as jhf
    from pathway_tpu.xpacks.llm.embedders import TpuEncoderEmbedder
    from pathway_tpu.xpacks.llm.rerankers import EncoderReranker as JEncoderReranker
    from pathway_tpu_torch.models import load_sentence_transformer
    from pathway_tpu_torch.xpacks.llm import EncoderEmbedder, EncoderReranker

    load = jhf.load_sentence_transformer

    def load_f32(path, **kw):
        params, cfg, tok = load(path, **kw)
        return params, dataclasses.replace(cfg, dtype=jnp.float32), tok

    monkeypatch.setattr(jhf, "load_sentence_transformer", load_f32)
    theirs_emb = TpuEncoderEmbedder(FIXTURE, max_len=32)
    state, cfg, tok = load_sentence_transformer(FIXTURE)
    ours_emb = EncoderEmbedder(dataclasses.replace(cfg, dtype=torch.float32), params=state,
                               tokenizer=tok, max_len=32, device="cpu")
    assert ours_emb.get_embedding_dimension() == 64
    docs, queries = _pairs(5)
    theirs = JEncoderReranker(theirs_emb)._fn(docs, queries)
    ours = EncoderReranker(ours_emb)._fn(docs, queries)
    assert all(-1.0 - 1e-6 <= s <= 1.0 + 1e-6 for s in ours)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)
    assert EncoderReranker(ours_emb)._fn(docs[:1], docs[:1])[0] == pytest.approx(1.0, abs=1e-6)


def test_llm_reranker_over_a_stub_chat_matches_jax():
    from pathway_tpu.internals.udfs import UDF as JUDF
    from pathway_tpu.xpacks.llm.rerankers import LLMReranker as JLLMReranker
    from pathway_tpu_torch.internals.udfs import UDF
    from pathway_tpu_torch.xpacks.llm import LLMReranker

    def reply(prompt: str) -> str:
        if "fail" in prompt:
            return "no idea"  # no digit 1-5: the judge scores 1
        return f"Score: {len(prompt) % 7}"  # 0 and 6 fall back to the first 1-5 digit or 1

    docs = ["alpha doc", "beta", "a fail case", "gamma gamma", "delta"]
    queries = ["q1", "query two", "q3", "q", "the fourth query"]
    ours = LLMReranker(UDF(reply))._fn(docs, queries)
    theirs = JLLMReranker(JUDF(reply))._fn(docs, queries)
    assert ours == theirs
    assert ours[2] == 1.0 and all(1.0 <= s <= 5.0 for s in ours)

    def broken(prompt: str) -> str:
        raise RuntimeError("down")

    with pytest.raises(RuntimeError, match="LLM reranker call failed"):
        LLMReranker(UDF(broken))._fn(docs[:1], queries[:1])
