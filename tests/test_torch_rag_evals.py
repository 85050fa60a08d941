"""The port's RAG evaluation harness (``pathway_tpu_torch/xpacks/llm/rag_evals.py``)
against the JAX package's: the cases of ``tests/test_xpack_llm.py::TestRagEvals`` run
through both packages on the same documents, samples and chats (an oracle UDF keyed on
the question, a chat that answers wrong, the identity chat), with a KNN store over
``mocks.FakeEmbedder`` (the port's index on the CPU). The reports must be equal field
for field, ``per_sample`` included; the metric functions and the JSONL loader give the
same values."""

from __future__ import annotations

import dataclasses

import pytest

import pathway_tpu as jpw
import pathway_tpu.xpacks.llm as jllm
import pathway_tpu.xpacks.llm.rag_evals  # noqa: F401  (the reference's xpack does not import it)
import pathway_tpu_torch as tpw
import pathway_tpu_torch.xpacks.llm as tllm
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch.engine import device_ops
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.internals.udfs.executors import stop_event_loop

DOCS = [
    "pathway is a streaming dataflow framework",
    "the tpu has a systolic array matrix unit",
    "bread baking needs flour water salt yeast",
]
SAMPLES = [
    ("what does bread baking need", "flour water salt yeast", "bread baking"),
    ("what unit does the tpu have", "systolic array matrix unit", "systolic array"),
]
ANSWERS = {q: a for q, a, _s in SAMPLES}


@pytest.fixture(autouse=True)
def _cpu_operators(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")
    device_ops.configure(device="cpu")
    yield
    device_ops.configure()
    stop_event_loop()
    TG.clear()
    JG.clear()


def _answerer(pw, llm, chat=None, topk=2):
    docs = pw.debug.table_from_rows(pw.schema_from_types(data=str), [(d,) for d in DOCS])
    store = llm.DocumentStore(docs, embedder=llm.mocks.FakeEmbedder(dim=16), index_capacity=32,
                              **({"device": "cpu"} if llm is tllm else {}))
    return llm.BaseRAGQuestionAnswerer(chat or llm.mocks.IdentityMockChat(), store,
                                       search_topk=topk)


def _samples(llm):
    return [llm.rag_evals.RagEvalSample(question=q, answer=a, source=s) for q, a, s in SAMPLES]


def _oracle(pw):
    # keyed on the question: the context docs also appear in the prompt
    @pw.udfs.udf
    def oracle(prompt: str) -> str:
        for key, answer in ANSWERS.items():
            if key in prompt:
                return answer
        return "No information found."

    return oracle


CHATS = {
    "oracle": lambda pw, llm: _oracle(pw),
    "wrong": lambda pw, llm: llm.mocks.FakeChatModel(answer="wrong"),
    "identity": lambda pw, llm: llm.mocks.IdentityMockChat(),
}


def _report(pw, llm, chat: str, topk: int = 2):
    answerer = _answerer(pw, llm, CHATS[chat](pw, llm), topk=topk)
    return llm.rag_evals.RagEvaluator(answerer).evaluate(_samples(llm))


@pytest.mark.parametrize("topk", [1, 2, 3])
@pytest.mark.parametrize("chat", sorted(CHATS))
def test_report_matches_the_reference_field_for_field(chat, topk):
    ours = _report(tpw, tllm, chat, topk)
    theirs = _report(jpw, jllm, chat, topk)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.as_dict() == theirs.as_dict()
    assert ours.to_markdown() == theirs.to_markdown()


def test_oracle_llm_scores_perfectly():
    report = _report(tpw, tllm, "oracle")
    assert report.n_samples == 2 and report.n_missing == 0
    assert report.answer_exact_match == report.answer_token_f1 == report.retrieval_hit_rate == 1.0
    assert report.context_precision > 0
    assert "answer_exact_match" in report.to_markdown()


def test_bad_llm_scores_zero_answers_but_retrieval_counts():
    report = _report(tpw, tllm, "wrong")
    assert report.answer_exact_match == 0.0
    assert 0.0 <= report.answer_token_f1 < 0.5
    assert report.retrieval_hit_rate == 1.0


@pytest.mark.parametrize("pred, gold", [
    ("flour and water", "flour water salt yeast"), ("unrelated words", "flour water"),
    ("The Flour, Water!", "flour water"), ("", ""), ("", "x"), ("a an the", "the"),
    ("yeast yeast flour", "flour yeast"),
])
def test_metrics_match_the_reference(pred, gold):
    ours, theirs = tllm.rag_evals, jllm.rag_evals
    assert ours.token_f1(pred, gold) == theirs.token_f1(pred, gold)
    assert ours.exact_match(pred, gold) == theirs.exact_match(pred, gold)
    assert ours._normalize(pred) == theirs._normalize(pred)


def test_token_f1_partial_credit():
    token_f1 = tllm.rag_evals.token_f1
    assert token_f1("flour and water", "flour water salt yeast") > 0.4
    assert token_f1("unrelated words", "flour water") == 0.0
    assert token_f1("The Flour, Water!", "flour water") == 1.0


def test_experiment_sweep_matches_the_reference():
    rows = [
        llm.rag_evals.run_experiment(
            lambda topk: _answerer(pw, llm, topk=topk), _samples(llm), [{"topk": 1}, {"topk": 2}]
        )
        for pw, llm in ((tpw, tllm), (jpw, jllm))
    ]
    assert rows[0] == rows[1]
    assert [r["topk"] for r in rows[0]] == [1, 2]
    assert all("retrieval_hit_rate" in r for r in rows[0])


def test_jsonl_dataset_loader_matches_the_reference(tmp_path):
    p = tmp_path / "ds.jsonl"
    p.write_text(
        '{"question": "q1", "answer": "a1", "source": "s1"}\n\n'
        '{"question": "q2", "answer": "a2"}\n'
    )
    ours = tllm.load_dataset(str(p))
    theirs = jllm.rag_evals.load_dataset(str(p))
    assert [dataclasses.asdict(s) for s in ours] == [dataclasses.asdict(s) for s in theirs]
    assert len(ours) == 2 and ours[0].source == "s1" and ours[1].source is None


def test_missing_answers_are_counted():
    """A sample whose question the pipeline never answers is scored 0 and counted."""

    class Dropping:
        def __init__(self, inner):
            self.inner = inner

        def answer_query(self, queries):
            return self.inner.answer_query(queries.filter(queries.prompt.str.startswith("what does")))

    got = []
    for pw, llm in ((tpw, tllm), (jpw, jllm)):
        report = llm.rag_evals.RagEvaluator(Dropping(_answerer(pw, llm, _oracle(pw)))).evaluate(
            _samples(llm))
        got.append(dataclasses.asdict(report))
    assert got[0] == got[1]
    assert got[0]["n_missing"] == 1 and got[0]["answer_exact_match"] == 0.5
