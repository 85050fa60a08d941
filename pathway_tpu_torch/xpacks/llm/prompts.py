"""Prompt templates of the RAG question answerers.

Counterpart of ``pathway_tpu/xpacks/llm/prompts.py``: the same texts, character for
character, so a chat sees the same prompt from either package.
"""

from __future__ import annotations

from typing import Sequence


def prompt_qa(
    query: str,
    docs: Sequence[str],
    information_not_found_response: str = "No information found.",
) -> str:
    """Short-answer RAG prompt (reference prompts.py prompt_qa)."""
    context = "\n\n".join(str(d) for d in docs)
    return (
        "Use the below articles to answer the subsequent question. If the "
        "answer cannot be found in the articles, write "
        f'"{information_not_found_response}".\n\n'
        f"Articles:\n{context}\n\nQuestion: {query}\nAnswer:"
    )


def prompt_citing_qa(query: str, docs: Sequence[str]) -> str:
    context = "\n\n".join(f"[{i+1}] {d}" for i, d in enumerate(docs))
    return (
        "Answer the question using the sources below; cite sources as "
        f"[n].\n\nSources:\n{context}\n\nQuestion: {query}\nAnswer:"
    )


def prompt_summarize(texts: Sequence[str]) -> str:
    joined = "\n".join(str(t) for t in texts)
    return f"Summarize the following texts briefly:\n\n{joined}\n\nSummary:"
