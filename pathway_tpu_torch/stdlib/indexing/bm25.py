"""BM25 full-text index on the host.

Counterpart of ``pathway_tpu/stdlib/indexing/bm25.py`` (the reference's TantivyBM25):
an in-memory inverted index with Okapi BM25 scoring, behind the same as-of-now operator
as the KNN index (``engine/external_index.py::ExternalIndexNode``, which feeds any index
through ``add``/``remove``/``search``). Text scoring is branchy integer and dictionary
work, so it stays on the host. Scores and ties (higher score first, then the lower key)
follow the JAX package's float for float.
"""

from __future__ import annotations

import dataclasses
import math
import re
from collections import Counter, defaultdict
from typing import Any, Sequence

from pathway_tpu_torch.engine.value import Pointer

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def _tokenize(text: str) -> list[str]:
    return _TOKEN_RE.findall(str(text).lower())


class BM25Index:
    """Okapi BM25 over an in-memory inverted index (ExternalIndex protocol)."""

    def __init__(self, k1: float = 1.2, b: float = 0.75) -> None:
        self.k1 = k1
        self.b = b
        self.postings: dict[str, dict[Pointer, int]] = defaultdict(dict)
        self.doc_tokens: dict[Pointer, list[str]] = {}  # inverse of postings
        self.doc_len: dict[Pointer, int] = {}
        self.total_len = 0

    def add(self, keys: Sequence[Pointer], docs: Sequence[Any]) -> None:
        for key, doc in zip(keys, docs):
            if key in self.doc_len:
                self.remove([key])
            toks = _tokenize(doc)
            self.doc_len[key] = len(toks)
            self.total_len += len(toks)
            counts = Counter(toks)
            self.doc_tokens[key] = list(counts)
            for tok, cnt in counts.items():
                self.postings[tok][key] = cnt

    def remove(self, keys: Sequence[Pointer]) -> None:
        for key in keys:
            length = self.doc_len.pop(key, None)
            if length is None:
                continue
            self.total_len -= length
            for tok in self.doc_tokens.pop(key, ()):
                tok_docs = self.postings.get(tok)
                if tok_docs is not None:
                    tok_docs.pop(key, None)
                    if not tok_docs:
                        del self.postings[tok]

    def op_state(self) -> dict:
        return {
            "postings": {t: dict(d) for t, d in self.postings.items()},
            "doc_tokens": dict(self.doc_tokens),
            "doc_len": dict(self.doc_len),
            "total_len": self.total_len,
        }

    def restore_op_state(self, state: dict) -> None:
        self.postings = defaultdict(dict)
        for t, d in state["postings"].items():
            self.postings[t] = dict(d)
        self.doc_tokens = dict(state["doc_tokens"])
        self.doc_len = dict(state["doc_len"])
        self.total_len = state["total_len"]

    def search(
        self, queries: Sequence[Any], k: int
    ) -> list[list[tuple[Pointer, float]]]:
        n_docs = len(self.doc_len)
        avg_len = (self.total_len / n_docs) if n_docs else 0.0
        out: list[list[tuple[Pointer, float]]] = []
        for query in queries:
            scores: dict[Pointer, float] = defaultdict(float)
            for tok in set(_tokenize(query)):
                tok_docs = self.postings.get(tok)
                if not tok_docs:
                    continue
                df = len(tok_docs)
                idf = math.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
                for key, tf in tok_docs.items():
                    dl = self.doc_len[key]
                    denom = tf + self.k1 * (
                        1 - self.b + self.b * dl / max(avg_len, 1e-9)
                    )
                    scores[key] += idf * tf * (self.k1 + 1) / denom
            ranked = sorted(scores.items(), key=lambda kv: (-kv[1], int(kv[0])))
            out.append([(key, float(s)) for key, s in ranked[:k]])
        return out


@dataclasses.dataclass
class TantivyBM25Factory:
    """Reference-compatible factory name (bm25.py:41)."""

    k1: float = 1.2
    b: float = 0.75

    def build(self) -> BM25Index:
        return BM25Index(k1=self.k1, b=self.b)
