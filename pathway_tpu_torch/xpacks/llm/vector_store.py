"""VectorStoreServer and its HTTP client.

Counterpart of ``pathway_tpu/xpacks/llm/vector_store.py``: a ``DocumentStore`` with a
mandatory embedder and KNN retrieval on the card (docs -> parse -> split -> embed ->
index). ``run_server`` (the REST endpoints ``/v1/retrieve``, ``/v1/statistics``,
``/v1/inputs``) needs the HTTP servers of ``servers.py``, which are not ported yet
(ROADMAP queue 1 item 8); the client speaks to any server with those endpoints.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Any

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore


class VectorStoreServer(DocumentStore):
    def __init__(
        self,
        *docs: Table,
        embedder: Any,
        parser: Any = None,
        splitter: Any = None,
        index_capacity: int = 1024,
        dimensions: int | None = None,
        metric: str = "cos",
        device: Any = None,
    ) -> None:
        super().__init__(
            list(docs),
            embedder=embedder,
            parser=parser,
            splitter=splitter,
            retriever_factory="knn",
            dimensions=dimensions,
            index_capacity=index_capacity,
            metric=metric,
            device=device,
        )

    def run_server(
        self,
        host: str = "127.0.0.1",
        port: int = 8754,
        *,
        threaded: bool = False,
        with_cache: bool = False,
    ) -> Any:
        """Serve /v1/retrieve, /v1/statistics and /v1/inputs over REST."""
        raise NotImplementedError(
            "the REST servers (servers.py) are not ported yet (ROADMAP queue 1 item 8)"
        )


class VectorStoreClient:
    """HTTP client for a VectorStoreServer (reference vector_store.py:651)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8754) -> None:
        self.base = f"http://{host}:{port}"

    def _post(self, path: str, payload: dict) -> Any:
        req = urllib.request.Request(
            self.base + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req) as resp:
            return json.loads(resp.read())

    def query(self, query: str, k: int = 3) -> list[dict]:
        return self._post("/v1/retrieve", {"query": query, "k": k})

    __call__ = query

    def get_vectorstore_statistics(self) -> dict:
        return self._post("/v1/statistics", {})
