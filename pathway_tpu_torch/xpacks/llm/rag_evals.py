"""RAG evaluation harness: labelled question/answer samples through a question answerer,
scored offline with judge-free metrics.

Counterpart of ``pathway_tpu/xpacks/llm/rag_evals.py``, whole:

- ``answer_exact_match``: normalized exact match of answer against expected.
- ``answer_token_f1``: token-level F1 (normalize, split, overlap).
- ``retrieval_hit_rate``: the share of questions where some retrieved context holds the
  expected answer (or the sample's ``source``).
- ``context_precision``: the share of retrieved docs per question that hold a token of
  the expected answer, averaged.

Datasets are lists of :class:`RagEvalSample` or a JSONL file of
``{"question": ..., "answer": ...}`` rows (``load_dataset``). The answerer runs
in-process, as one static run of the port's engine.
"""

from __future__ import annotations

import dataclasses
import json
import re
import string
from typing import Any, Callable, Sequence

from pathway_tpu_torch.internals import schema as schema_mod


@dataclasses.dataclass(frozen=True)
class RagEvalSample:
    question: str
    answer: str
    #: optional substring identifying the gold document (path or content)
    source: str | None = None


def load_dataset(path: str) -> list[RagEvalSample]:
    """JSONL rows {"question", "answer"[, "source"]} -> samples."""
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            out.append(
                RagEvalSample(
                    question=row["question"],
                    answer=row["answer"],
                    source=row.get("source"),
                )
            )
    return out


def _normalize(text: str) -> str:
    """SQuAD-style normalization: lowercase, strip punctuation/articles."""
    text = text.lower()
    text = "".join(c if c not in string.punctuation else " " for c in text)
    text = re.sub(r"\b(a|an|the)\b", " ", text)
    return " ".join(text.split())


def token_f1(prediction: str, expected: str) -> float:
    pred = _normalize(prediction).split()
    gold = _normalize(expected).split()
    if not pred or not gold:
        return float(pred == gold)
    common: dict[str, int] = {}
    for tok in gold:
        common[tok] = common.get(tok, 0) + 1
    overlap = 0
    for tok in pred:
        if common.get(tok, 0) > 0:
            common[tok] -= 1
            overlap += 1
    if overlap == 0:
        return 0.0
    precision = overlap / len(pred)
    recall = overlap / len(gold)
    return 2 * precision * recall / (precision + recall)


def exact_match(prediction: str, expected: str) -> float:
    return float(_normalize(prediction) == _normalize(expected))


@dataclasses.dataclass
class RagEvalReport:
    n_samples: int
    answer_exact_match: float
    answer_token_f1: float
    retrieval_hit_rate: float
    context_precision: float
    per_sample: list[dict]
    #: samples the pipeline never answered (no result row for the
    #: question) — zero-scored AND surfaced, so silently dropped rows
    #: can't masquerade as model mistakes
    n_missing: int = 0

    def as_dict(self) -> dict:
        return {
            "n_samples": self.n_samples,
            "n_missing": self.n_missing,
            "answer_exact_match": round(self.answer_exact_match, 4),
            "answer_token_f1": round(self.answer_token_f1, 4),
            "retrieval_hit_rate": round(self.retrieval_hit_rate, 4),
            "context_precision": round(self.context_precision, 4),
        }

    def to_markdown(self) -> str:
        head = self.as_dict()
        lines = [
            "| metric | value |",
            "|---|---|",
            *(f"| {k} | {v} |" for k, v in head.items()),
        ]
        return "\n".join(lines)


class RagEvaluator:
    """Drive a question answerer over a labeled dataset and score it.

    ``answerer`` is any object with the BaseRAGQuestionAnswerer contract:
    ``answer_query(table(prompt)) -> table(result, context_docs)``. The
    harness builds the query table, runs the dataflow to completion (one static
    ``GraphRunner().capture``), and scores answers and retrieved contexts per
    sample.
    """

    def __init__(self, answerer: Any) -> None:
        self.answerer = answerer

    def _run(self, samples: Sequence[RagEvalSample]) -> list[tuple]:
        import pathway_tpu_torch as pw
        from pathway_tpu_torch.internals.runner import GraphRunner

        queries = pw.debug.table_from_rows(
            schema_mod.schema_from_types(prompt=str),
            [(s.question,) for s in samples],
        )
        result = self.answerer.answer_query(queries)
        with_prompt = result.select(
            prompt=queries.restrict(result).prompt,
            result=result.result,
            context_docs=result.context_docs,
        )
        (snap,) = GraphRunner().capture(with_prompt)
        return list(snap.values())

    @staticmethod
    def _doc_text(doc: Any) -> str:
        if isinstance(doc, dict):
            return str(doc.get("text", doc))
        return str(doc)

    def evaluate(self, samples: Sequence[RagEvalSample]) -> RagEvalReport:
        rows = self._run(samples)
        by_prompt = {prompt: (res, docs) for prompt, res, docs in rows}
        per_sample = []
        n_missing = 0
        for s in samples:
            missing = s.question not in by_prompt
            if missing:
                n_missing += 1
            res, docs = by_prompt.get(s.question, ("", ()))
            res = str(res or "")  # a None/errored answer scores 0, not crash
            docs = list(docs or ())
            gold_tokens = set(_normalize(s.answer).split())
            needle = _normalize(s.source or s.answer)
            texts = [_normalize(self._doc_text(d)) for d in docs]
            hit = any(needle in t for t in texts)
            relevant = [
                t for t in texts if gold_tokens & set(t.split())
            ]
            per_sample.append(
                {
                    "question": s.question,
                    "answer": res,
                    "expected": s.answer,
                    "exact_match": exact_match(res, s.answer),
                    "token_f1": token_f1(res, s.answer),
                    "retrieval_hit": float(hit),
                    "context_precision": (
                        len(relevant) / len(texts) if texts else 0.0
                    ),
                    "missing": missing,
                }
            )
        n = len(per_sample) or 1

        def mean(key: str) -> float:
            return sum(p[key] for p in per_sample) / n

        return RagEvalReport(
            n_samples=len(per_sample),
            answer_exact_match=mean("exact_match"),
            answer_token_f1=mean("token_f1"),
            retrieval_hit_rate=mean("retrieval_hit"),
            context_precision=mean("context_precision"),
            per_sample=per_sample,
            n_missing=n_missing,
        )


def run_experiment(
    make_answerer: Callable[..., Any],
    samples: Sequence[RagEvalSample],
    configs: Sequence[dict],
) -> list[dict]:
    """Evaluate a family of configurations (e.g. a top-k sweep) and return one
    scored row per configuration."""
    out = []
    for config in configs:
        report = RagEvaluator(make_answerer(**config)).evaluate(samples)
        out.append({**config, **report.as_dict()})
    return out
