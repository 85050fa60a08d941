"""Offline fake models for tests and examples.

Counterpart of ``pathway_tpu/xpacks/llm/mocks.py``: ``fake_embeddings_model`` draws a
unit vector seeded from a BLAKE2s hash of the text (the same floats as the JAX
package's), and the chats answer without a model.
"""

from __future__ import annotations

import hashlib
from typing import Any

import numpy as np

from pathway_tpu_torch.internals.udfs import UDF, SyncExecutor


def fake_embeddings_model(text: str, dim: int = 16) -> np.ndarray:
    """Deterministic unit vector from a text hash."""
    seed = int.from_bytes(
        hashlib.blake2s(str(text).encode(), digest_size=8).digest(), "little"
    )
    rng = np.random.default_rng(seed)
    v = rng.normal(size=dim).astype(np.float32)
    return v / np.linalg.norm(v)


class FakeEmbedder(UDF):
    def __init__(self, dim: int = 16) -> None:
        self.dim = dim

        def embed(text: str) -> np.ndarray:
            return fake_embeddings_model(text, self.dim)

        super().__init__(embed, executor=SyncExecutor(), deterministic=True)

    def get_embedding_dimension(self) -> int:
        return self.dim


class IdentityMockChat(UDF):
    """Echoes 'model: prompt' (reference mocks.py IdentityMockChat)."""

    def __init__(self, model: str = "mock") -> None:
        self.model = model

        def chat(prompt: Any) -> str:
            return f"{self.model}: {prompt}"

        super().__init__(chat, executor=SyncExecutor(), deterministic=True)


class FakeChatModel(UDF):
    """Always answers with a canned string (reference mocks.py FakeChatModel)."""

    def __init__(self, answer: str = "Text") -> None:
        def chat(prompt: Any) -> str:
            return answer

        super().__init__(chat, executor=SyncExecutor(), deterministic=True)
