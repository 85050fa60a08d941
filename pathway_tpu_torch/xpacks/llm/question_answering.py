"""RAG question answering.

Counterpart of ``pathway_tpu/xpacks/llm/question_answering.py``:

- ``BaseRAGQuestionAnswerer``: retrieve -> prompt -> answer, as dataflow.
- ``AdaptiveRAGQuestionAnswerer``: geometric document-count expansion
  (:func:`answer_with_geometric_rag_strategy`): ask with few documents, ask again with
  geometrically more while the model reports that it found no answer. As in the
  reference, each query row runs its own expansion loop inside an async UDF.
- ``RAGClient``: the HTTP client of the question-answering REST server.
"""

from __future__ import annotations

import asyncio
import json
import urllib.request
from typing import Any, Sequence

from pathway_tpu_torch.internals.expression import apply as pw_apply
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.udfs import UDF
from pathway_tpu_torch.xpacks.llm import prompts
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore

NOT_FOUND = "No information found."


class BaseRAGQuestionAnswerer:
    def __init__(
        self,
        llm: Any,
        indexer: DocumentStore,
        *,
        search_topk: int = 6,
        prompt_template: Any = prompts.prompt_qa,
    ) -> None:
        self.llm = llm
        self.indexer = indexer
        self.search_topk = search_topk
        self.prompt_template = prompt_template

    def answer_query(self, query_table: Table) -> Table:
        """``query_table(prompt: str)`` -> ``(result: str, context_docs)``."""
        topk = self.search_topk
        prepped = query_table.select(
            query=query_table.prompt,
            k=pw_apply(lambda _q: topk, query_table.prompt),
        )
        hits = self.indexer.retrieve_query(prepped)
        template = self.prompt_template
        with_prompt = query_table.restrict(hits).select(
            prompt=query_table.prompt,
            docs=hits.result,
            full_prompt=pw_apply(
                lambda q, docs: template(q, [d["text"] for d in docs]),
                query_table.prompt,
                hits.result,
            ),
        )
        return with_prompt.select(
            result=self.llm(with_prompt.full_prompt),
            context_docs=with_prompt.docs,
        )

    # convenience aliases mirroring the reference server surface
    def summarize_query(self, query_table: Table) -> Table:
        texts = query_table.text_list
        return query_table.select(
            result=self.llm(
                pw_apply(lambda ts: prompts.prompt_summarize(ts), texts)
            )
        )


def answer_with_geometric_rag_strategy(
    question: str,
    documents: Sequence[str],
    llm_call: Any,
    n_starting_documents: int = 2,
    factor: int = 2,
    max_iterations: int = 4,
    not_found_response: str = NOT_FOUND,
) -> str:
    """Reference question_answering.py:97: ask with n docs; if the answer is
    'not found', retry with n*factor docs until exhausted."""
    n = n_starting_documents
    for _ in range(max_iterations):
        docs = list(documents[:n])
        answer = str(llm_call(prompts.prompt_qa(question, docs, not_found_response)))
        if not_found_response.lower() not in answer.lower():
            return answer
        if n >= len(documents):
            break
        n *= factor
    return not_found_response


class AdaptiveRAGQuestionAnswerer(BaseRAGQuestionAnswerer):
    def __init__(
        self,
        llm: Any,
        indexer: DocumentStore,
        *,
        n_starting_documents: int = 2,
        factor: int = 2,
        max_iterations: int = 4,
        search_topk: int = 16,
    ) -> None:
        super().__init__(llm, indexer, search_topk=search_topk)
        self.n_starting_documents = n_starting_documents
        self.factor = factor
        self.max_iterations = max_iterations

    def answer_query(self, query_table: Table) -> Table:
        topk = self.search_topk
        prepped = query_table.select(
            query=query_table.prompt,
            k=pw_apply(lambda _q: topk, query_table.prompt),
        )
        hits = self.indexer.retrieve_query(prepped)
        llm = self.llm
        n0, factor, iters = (
            self.n_starting_documents,
            self.factor,
            self.max_iterations,
        )

        def adaptive_sync(question: str, docs: tuple) -> str:
            def llm_call(prompt: str) -> str:
                results = llm.execute_rows([(prompt,)])
                ok, value = results[0]
                if not ok:
                    raise value
                return str(value)

            return answer_with_geometric_rag_strategy(
                question,
                [d["text"] for d in docs],
                llm_call,
                n_starting_documents=n0,
                factor=factor,
                max_iterations=iters,
            )

        # an async UDF, so the expansion loops of all queries in a commit fan out
        # concurrently instead of serializing on the scheduler thread (the reference
        # runs these as coroutines too); each loop runs on a worker thread of the
        # event loop, and a chat on the card uses its own explicit device there
        async def adaptive(question: str, docs: tuple) -> str:
            return await asyncio.to_thread(adaptive_sync, question, docs)

        adaptive_udf = UDF(adaptive, cache_name=f"AdaptiveRAG:{id(self)}")
        base = query_table.restrict(hits)
        return base.select(
            result=adaptive_udf(query_table.prompt, hits.result),
            context_docs=hits.result,
        )


class SummaryQuestionAnswerer(BaseRAGQuestionAnswerer):
    pass


class RAGClient:
    """HTTP client for the QA REST server (reference :854)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8755) -> None:
        self.base = f"http://{host}:{port}"

    def _post(self, path: str, payload: dict) -> Any:
        req = urllib.request.Request(
            self.base + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req) as resp:
            return json.loads(resp.read())

    def answer(self, prompt: str) -> Any:
        return self._post("/v1/pw_ai_answer", {"prompt": prompt})

    pw_ai_answer = answer
