"""Rerankers: (doc, query) -> relevance score UDFs.

Counterpart of ``pathway_tpu/xpacks/llm/rerankers.py``: ``CrossEncoderReranker`` (the
MiniLM-L6 cross-encoder of ``models/transformer.py`` on the card, micro-batched by the
UDF's batch executor, attention in the flash forward kernel), ``EncoderReranker``
(cosine of a bi-encoder's embeddings), ``LLMReranker`` (a chat as a 1-5 judge) and
``rerank_topk_filter``.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.internals.udfs import UDF, batch_executor
from pathway_tpu_torch.models.transformer import CrossEncoder, cross_encode, minilm_l6
from pathway_tpu_torch.xpacks.llm._tokenizer import HashTokenizer, pad_to_buckets


class CrossEncoderReranker(UDF):
    """Cross-encoder on the card: ``[CLS] doc [SEP] query [SEP]`` -> logit.

    The tower is always MiniLM-L6 (``model_name`` is kept for the reference's
    signature; the ms-marco MiniLM class maps to it); weights are seeded random unless
    ``params`` (a ``CrossEncoder`` state_dict) is given."""

    def __init__(
        self,
        model_name: str = "cross-encoder/ms-marco-TinyBERT-L-2-v2",
        *,
        max_len: int = 256,
        max_batch_size: int = 128,
        params: dict[str, torch.Tensor] | None = None,
        seed: int = 0,
        device: "str | torch.device | None" = None,
    ) -> None:
        self.config = minilm_l6()
        self.max_len = max_len
        self.device = resolve_device(device)
        self._tok = HashTokenizer(self.config.vocab_size)
        self.model = CrossEncoder(
            self.config, device=self.device, seed=None if params is not None else seed
        )
        if params is not None:
            self.model.load_state_dict(params)
        super().__init__(
            self.score_batch,
            executor=batch_executor(max_batch_size=max_batch_size),
            deterministic=True,
        )

    def tokenize(self, docs: list, queries: list) -> tuple[torch.Tensor, torch.Tensor, int]:
        """-> (ids ``[B, T]``, mask ``[B, T]`` on the device, real batch size), batch
        and sequence padded to the power-of-two buckets."""
        ids, mask = self._tok.encode_pair_batch(
            [str(d) for d in docs], [str(q) for q in queries], self.max_len
        )
        ids, mask, real = pad_to_buckets(ids, mask)
        return torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device), real

    def score_batch(self, docs: list, queries: list) -> list[float]:
        """The UDF's body: one executor chunk of (doc, query) pairs -> one score each."""
        ids, mask, real = self.tokenize(docs, queries)
        scores = cross_encode(self.model, ids, mask)[:real].cpu().numpy()
        return [float(s) for s in scores]


class EncoderReranker(UDF):
    """Bi-encoder similarity reranker: embeds doc and query with the given embedder
    UDF and scores by cosine."""

    def __init__(self, embedder: Any) -> None:
        inner = embedder

        def score_batch(docs: list, queries: list) -> list:
            d = inner.execute_rows([(str(x),) for x in docs])
            q = inner.execute_rows([(str(x),) for x in queries])
            out = []
            for (ok_d, dv), (ok_q, qv) in zip(d, q):
                if not (ok_d and ok_q):
                    raise RuntimeError("embedding failed in EncoderReranker")
                dv = np.asarray(dv, np.float32)
                qv = np.asarray(qv, np.float32)
                denom = np.linalg.norm(dv) * np.linalg.norm(qv)
                out.append(float(dv @ qv / max(denom, 1e-30)))
            return out

        super().__init__(score_batch, executor=batch_executor(), deterministic=True)


class LLMReranker(UDF):
    """LLM-as-judge 1-5 relevance score."""

    PROMPT = (
        "Given a query and a document, rate how relevant the document is to "
        "the query on a scale 1 to 5. Answer with a single digit.\n"
        "Query: {query}\nDocument: {doc}\nScore:"
    )

    def __init__(self, llm: Any) -> None:
        chat = llm

        def score_batch(docs: list, queries: list) -> list:
            prompts = [self.PROMPT.format(query=q, doc=d) for d, q in zip(docs, queries)]
            replies = chat.execute_rows([(p,) for p in prompts])
            out = []
            for ok, text in replies:
                if not ok:
                    raise RuntimeError(f"LLM reranker call failed: {text!r}")
                m = re.search(r"[1-5]", str(text))
                out.append(float(m.group()) if m else 1.0)
            return out

        super().__init__(score_batch, executor=batch_executor())


def rerank_topk_filter(docs: tuple, scores: tuple, k: int = 5) -> tuple[tuple, tuple]:
    """Keep the k best (doc, score) pairs; an apply-ready helper over collapsed doc and
    score tuples."""
    order = sorted(range(len(docs)), key=lambda i: -scores[i])[:k]
    return tuple(docs[i] for i in order), tuple(scores[i] for i in order)
