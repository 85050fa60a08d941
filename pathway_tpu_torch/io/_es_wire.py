"""The Elasticsearch HTTP wire: a ``_bulk`` client and an in-process server.

Counterpart of ``pathway_tpu/io/_es_wire.py``, sending the same bodies:

- :class:`EsBulkClient` buffers ``index(index_name, document)`` calls and sends them at
  ``flush`` (or at ``max_batch`` documents) as one NDJSON ``POST /_bulk``: an ``index``
  action line and a source line a document. Item errors raise :class:`EsError` after
  the buffer is cleared (the bulk API is per item: the good documents are stored, and a
  retried flush must not post them again).
- :func:`auth_header_basic`, :func:`auth_header_bearer` and :func:`auth_header_apikey`
  spell the three ``Authorization`` headers.
- :class:`FakeElasticsearchServer` answers ``POST /_bulk``, ``GET /{index}/_search`` and
  ``GET /{index}/_count`` on a local port, checking the header it was given.
"""

from __future__ import annotations

import base64
import http.client
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
from urllib.parse import urlparse


class EsError(Exception):
    """Bulk item failure or HTTP-level error from the server."""


class EsBulkClient:
    """``index(index_name, document)`` + ``flush()``: documents buffer
    locally and travel as one ``/_bulk`` NDJSON request per flush (or
    when the buffer reaches ``max_batch``)."""

    def __init__(
        self,
        host: str,
        *,
        auth_header: str | None = None,
        max_batch: int = 2000,
        timeout: float = 30.0,
    ) -> None:
        parsed = urlparse(host if "://" in host else f"http://{host}")
        self._https = parsed.scheme == "https"
        self._host = parsed.hostname or "127.0.0.1"
        self._port = parsed.port or (443 if self._https else 9200)
        self._auth = auth_header
        self._timeout = timeout
        self.max_batch = max_batch
        self._buffer: list[tuple[str, dict]] = []

    def index(self, index_name: str, document: dict) -> None:
        self._buffer.append((index_name, document))
        if len(self._buffer) >= self.max_batch:
            self.flush()

    def flush(self) -> None:
        if not self._buffer:
            return
        lines = []
        for index_name, doc in self._buffer:
            lines.append(json.dumps({"index": {"_index": index_name}}))
            lines.append(json.dumps(doc))
        body = ("\n".join(lines) + "\n").encode("utf-8")
        resp = self._request("POST", "/_bulk", body)
        if resp.get("errors"):
            failed = [
                item["index"].get("error")
                for item in resp.get("items", ())
                if item.get("index", {}).get("error")
            ]
            # ES bulk is PER-ITEM: the good documents are already
            # indexed. Clear the buffer before raising so a retried
            # flush cannot re-post (duplicate) them; the failed items
            # surface through the error, not a resend loop.
            self._buffer = []
            raise EsError(f"bulk errors: {failed[:3]!r}")
        self._buffer = []

    def _request(self, method: str, path: str, body: bytes) -> dict:
        conn_cls = (
            http.client.HTTPSConnection
            if self._https
            else http.client.HTTPConnection
        )
        conn = conn_cls(self._host, self._port, timeout=self._timeout)
        try:
            headers = {"Content-Type": "application/x-ndjson"}
            if self._auth:
                headers["Authorization"] = self._auth
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status >= 400:
                raise EsError(
                    f"{resp.status}: {payload[:200].decode('utf-8', 'replace')}"
                )
            return json.loads(payload) if payload else {}
        finally:
            conn.close()

    def close(self) -> None:
        self.flush()


def auth_header_basic(username: str, password: str) -> str:
    cred = base64.b64encode(f"{username}:{password}".encode()).decode()
    return f"Basic {cred}"


def auth_header_bearer(token: str) -> str:
    return f"Bearer {token}"


def auth_header_apikey(apikey_id: str, apikey: str) -> str:
    cred = base64.b64encode(f"{apikey_id}:{apikey}".encode()).decode()
    return f"ApiKey {cred}"


class FakeElasticsearchServer:
    """In-process ES speaking the bulk/search endpoints over HTTP."""

    def __init__(self, *, auth_header: str | None = None) -> None:
        self.auth_header = auth_header
        #: index name -> list of stored documents, in arrival order
        self.indices: dict[str, list[dict]] = {}
        self.bulk_requests: list[int] = []  # docs per _bulk call
        self._lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args: Any) -> None:
                pass

            def _reply(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _authed(self) -> bool:
                if server.auth_header is None:
                    return True
                if self.headers.get("Authorization") == server.auth_header:
                    return True
                self._reply(
                    401,
                    {"error": {"type": "security_exception"}},
                )
                return False

            def do_POST(self) -> None:  # noqa: N802 — http.server API
                if not self._authed():
                    return
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length).decode("utf-8")
                if self.path.rstrip("/") != "/_bulk":
                    self._reply(404, {"error": "no route"})
                    return
                lines = [ln for ln in body.split("\n") if ln.strip()]
                items = []
                count = 0
                i = 0
                while i < len(lines):
                    action = json.loads(lines[i])
                    if "index" not in action:
                        items.append(
                            {
                                "index": {
                                    "status": 400,
                                    "error": {
                                        "type": "illegal_argument",
                                        "reason": f"unsupported action "
                                        f"{list(action)[:1]}",
                                    },
                                }
                            }
                        )
                        i += 1
                        continue
                    doc = json.loads(lines[i + 1])
                    idx = action["index"]["_index"]
                    with server._lock:
                        server.indices.setdefault(idx, []).append(doc)
                    items.append(
                        {"index": {"_index": idx, "status": 201}}
                    )
                    count += 1
                    i += 2
                with server._lock:
                    server.bulk_requests.append(count)
                self._reply(
                    200,
                    {
                        "took": 1,
                        "errors": any(
                            it["index"].get("error") for it in items
                        ),
                        "items": items,
                    },
                )

            def do_GET(self) -> None:  # noqa: N802 — http.server API
                if not self._authed():
                    return
                parts = self.path.strip("/").split("/")
                if len(parts) == 2 and parts[1] == "_search":
                    with server._lock:
                        docs = list(server.indices.get(parts[0], ()))
                    self._reply(
                        200,
                        {
                            "hits": {
                                "total": {"value": len(docs)},
                                "hits": [
                                    {"_source": d} for d in docs
                                ],
                            }
                        },
                    )
                    return
                if len(parts) == 2 and parts[1] == "_count":
                    with server._lock:
                        n = len(server.indices.get(parts[0], ()))
                    self._reply(200, {"count": n})
                    return
                self._reply(404, {"error": "no route"})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        # request threads are joined at server_close
        self._httpd.daemon_threads = False
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fake-elasticsearch", daemon=True
        )
        self._thread.start()

    def host(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def close(self) -> None:
        """Stop serving and join the server's threads."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()
