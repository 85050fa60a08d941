"""Document splitters.

Counterpart of ``pathway_tpu/xpacks/llm/splitters.py``. ``TokenCountSplitter`` packs
whitespace-separated words greedily into chunks of ``min_tokens`` to ``max_tokens``
tokens, counted by the local models' ``HashTokenizer`` (the reference counts with
tiktoken), so chunk budgets match what the encoder sees. Splitters return a tuple of
``(chunk_text, metadata)`` pairs, as in the reference.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.udfs import UDF, SyncExecutor
from pathway_tpu_torch.xpacks.llm._tokenizer import HashTokenizer


class TokenCountSplitter(UDF):
    """Greedy sentence-ish packing between min_tokens and max_tokens."""

    def __init__(
        self, min_tokens: int = 50, max_tokens: int = 500, encoding_name: str = ""
    ) -> None:
        self.min_tokens = min_tokens
        self.max_tokens = max_tokens
        self._tok = HashTokenizer()

        def split(text: str, metadata: dict | None = None) -> tuple:
            meta = dict(metadata or {})
            words = str(text).split()
            chunks: list[tuple[str, dict]] = []
            cur: list[str] = []
            count = 0
            for word in words:
                n = max(1, self._tok.count_tokens(word))
                if count + n > self.max_tokens and count >= self.min_tokens:
                    chunks.append((" ".join(cur), meta))
                    cur, count = [], 0
                cur.append(word)
                count += n
            if cur:
                chunks.append((" ".join(cur), meta))
            return tuple(chunks)

        super().__init__(split, executor=SyncExecutor(), deterministic=True)


class NullSplitter(UDF):
    """Whole document as one chunk (reference: null_splitter :13)."""

    def __init__(self) -> None:
        def split(text: str, metadata: dict | None = None) -> tuple:
            return ((str(text), dict(metadata or {})),)

        super().__init__(split, executor=SyncExecutor(), deterministic=True)


def null_splitter(text: str, metadata: dict | None = None) -> tuple:
    return ((str(text), dict(metadata or {})),)
