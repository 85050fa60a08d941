"""REST servers for document stores and RAG pipelines.

Counterpart of ``pathway_tpu/xpacks/llm/servers.py``: ``BaseRestServer``,
``DocumentStoreServer`` (``/v1/retrieve``, ``/v1/statistics``, ``/v1/inputs``),
``QARestServer`` and ``QASummaryRestServer``. Routes are ``rest_connector`` pairs over
one ``PathwayWebserver`` (``io/http.py``); the whole app is one streaming dataflow run.

The port's ``ServerHandle`` also stops the server: :meth:`ServerHandle.stop` closes
the port, which ends every route's query stream and so the run. What a threaded run
raised (a card error in the embedder, say) is kept and raised by ``join`` and
``stop`` on the caller's thread; the reference's thread drops it (ROADMAP: deliberate
differences).
"""

from __future__ import annotations

import threading
from typing import Any, Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.runner import GraphRunner
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io.http import PathwayWebserver, rest_connector


class ServerHandle:
    def __init__(
        self,
        runner: GraphRunner,
        thread: threading.Thread | None,
        webserver: PathwayWebserver | None = None,
    ):
        self.runner = runner
        self.thread = thread
        self.webserver = webserver
        #: what the threaded run raised, raised again by ``join`` and ``stop``
        self.error: BaseException | None = None

    def join(self, timeout: float | None = None) -> None:
        """Wait for the run to end; raise what it raised."""
        if self.thread is not None:
            self.thread.join(timeout)
        if self.error is not None:
            raise self.error

    def stop(self, timeout: float = 30.0) -> None:
        """Close the port, so the run ends once it has answered what it holds, and
        wait for it."""
        if self.webserver is not None:
            self.webserver.stop(timeout)
        self.join(timeout)


class BaseRestServer:
    def __init__(self, host: str, port: int, **kwargs: Any) -> None:
        self.host = host
        self.port = port
        self.webserver = PathwayWebserver(host, port)
        self._routes: list[tuple[Table, Callable]] = []

    def serve(
        self,
        route: str,
        schema: schema_mod.SchemaMetaclass,
        handler: Callable[[Table], Table],
        **kwargs: Any,
    ) -> None:
        query_table, attach = rest_connector(
            schema=schema, route=route, webserver=self.webserver, **kwargs
        )
        result = handler(query_table)
        self._routes.append((result, attach))

    def run(
        self, *, threaded: bool = False, with_cache: bool = False
    ) -> ServerHandle:
        """Build the dataflow, open the port, run the streaming loop."""
        if with_cache:
            # UDF-level caches (DiskCache) already persist under
            # PATHWAY_TPU_UDF_CACHE; nothing extra to wire here yet.
            pass
        runner = GraphRunner()
        for result, attach in self._routes:
            attach(result, runner)
        if threaded:
            handle = ServerHandle(runner, None, self.webserver)

            def run() -> None:
                try:
                    runner.run()
                except BaseException as exc:  # noqa: BLE001 — raised by join / stop
                    handle.error = exc

            handle.thread = threading.Thread(target=run, name="pw-server-run", daemon=True)
            handle.thread.start()
            return handle
        handle = ServerHandle(runner, None, self.webserver)
        runner.run()
        return handle


class DocumentStoreServer(BaseRestServer):
    """/v1/retrieve, /v1/statistics, /v1/inputs (reference :92)."""

    def __init__(self, host: str, port: int, document_store: Any) -> None:
        super().__init__(host, port)
        store = document_store
        retrieve_schema = schema_mod.schema_from_dict(
            {"query": dt.STR, "k": dt.INT}, name="RetrieveQuerySchema"
        )
        empty_schema = schema_mod.schema_from_dict(
            {}, name="EmptyQuerySchema"
        )
        self.serve("/v1/retrieve", retrieve_schema, store.retrieve_query)
        self.serve("/v1/statistics", empty_schema, store.statistics_query)
        self.serve("/v1/inputs", empty_schema, store.inputs_query)


class QARestServer(BaseRestServer):
    """/v1/pw_ai_answer (+ retrieval passthrough) (reference :140)."""

    def __init__(self, host: str, port: int, rag_question_answerer: Any) -> None:
        super().__init__(host, port)
        rag = rag_question_answerer
        answer_schema = schema_mod.schema_from_dict(
            {"prompt": dt.STR}, name="QASchema"
        )
        retrieve_schema = schema_mod.schema_from_dict(
            {"query": dt.STR, "k": dt.INT}, name="RetrieveQuerySchema"
        )
        self.serve("/v1/pw_ai_answer", answer_schema, rag.answer_query)
        self.serve(
            "/v1/retrieve", retrieve_schema, rag.indexer.retrieve_query
        )


class QASummaryRestServer(QARestServer):
    """Adds /v1/pw_ai_summary (reference :193)."""

    def __init__(self, host: str, port: int, rag: Any) -> None:
        super().__init__(host, port, rag)
        summary_schema = schema_mod.schema_from_dict(
            {"text_list": dt.ANY}, name="SummarySchema"
        )
        self.serve("/v1/pw_ai_summary", summary_schema, rag.summarize_query)
