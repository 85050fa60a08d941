"""The Iceberg REST catalog protocol: a client and an in-process catalog server.

Counterpart of ``pathway_tpu/io/_iceberg_rest.py``, with the REST spec's endpoints:

- ``GET /v1/config``;
- ``POST /v1/namespaces`` (create a namespace; 409 if it exists);
- ``POST /v1/namespaces/{ns}/tables`` (create a table);
- ``GET /v1/namespaces/{ns}/tables/{table}`` (load a table; 404 if there is none);
- ``POST /v1/namespaces/{ns}/tables/{table}`` (commit: a CommitTableRequest of
  ``assert-table-uuid`` and ``assert-ref-snapshot-id`` requirements and
  ``add-snapshot`` and ``set-snapshot-ref`` updates).

:class:`RestCatalogClient` speaks them over urllib with an optional bearer token; an
HTTP error raises :class:`IcebergRestError` with its status. :class:`FakeIcebergRestServer`
keeps each table's metadata document in memory and its files under ``warehouse`` on the
local disk, checks the bearer token, and answers a commit whose ref has moved (a stale
``assert-ref-snapshot-id``) with 409, so that concurrent writers lose cleanly.
"""

from __future__ import annotations

import json
import os
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Sequence


class IcebergRestError(Exception):
    """Catalog-reported error; ``code`` carries the HTTP status."""

    def __init__(self, code: int, message: str) -> None:
        super().__init__(f"{code}: {message}")
        self.code = code


class RestCatalogClient:
    """Minimal REST catalog client over urllib (stdlib-only)."""

    def __init__(
        self,
        uri: str,
        *,
        token: str | None = None,
        timeout: float = 20.0,
    ) -> None:
        self.uri = uri.rstrip("/")
        self.token = token
        self.timeout = timeout

    def _request(
        self, method: str, path: str, body: dict | None = None
    ) -> dict:
        url = f"{self.uri}{path}"
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as exc:
            detail = exc.read().decode("utf-8", "replace")
            try:
                detail = json.loads(detail)["error"]["message"]
            except (ValueError, KeyError, TypeError):
                pass  # not the spec's error document: keep the raw body
            raise IcebergRestError(exc.code, detail) from None
        return json.loads(payload) if payload else {}

    # -- endpoints ----------------------------------------------------------

    def config(self) -> dict:
        return self._request("GET", "/v1/config")

    def create_namespace(self, namespace: Sequence[str]) -> None:
        try:
            self._request(
                "POST", "/v1/namespaces", {"namespace": list(namespace)}
            )
        except IcebergRestError as exc:
            if exc.code != 409:  # AlreadyExists is fine
                raise

    def load_table(
        self, namespace: Sequence[str], table: str
    ) -> dict | None:
        """LoadTableResult ``{metadata-location, metadata}`` or None."""
        try:
            return self._request(
                "GET",
                f"/v1/namespaces/{'.'.join(namespace)}/tables/{table}",
            )
        except IcebergRestError as exc:
            if exc.code == 404:
                return None
            raise

    def create_table(
        self,
        namespace: Sequence[str],
        table: str,
        schema: dict,
        location: str | None = None,
    ) -> dict:
        body: dict = {"name": table, "schema": schema}
        if location is not None:
            body["location"] = location
        return self._request(
            "POST", f"/v1/namespaces/{'.'.join(namespace)}/tables", body
        )

    def commit_table(
        self,
        namespace: Sequence[str],
        table: str,
        requirements: list[dict],
        updates: list[dict],
    ) -> dict:
        return self._request(
            "POST",
            f"/v1/namespaces/{'.'.join(namespace)}/tables/{table}",
            {"requirements": requirements, "updates": updates},
        )


# -- fake server -------------------------------------------------------------


class FakeIcebergRestServer:
    """In-process REST catalog: metadata documents in memory, table
    locations under ``warehouse`` on the local filesystem."""

    def __init__(
        self, warehouse: str, *, token: str | None = None
    ) -> None:
        self.warehouse = os.fspath(warehouse)
        self.token = token
        self.namespaces: set[str] = set()
        #: "ns.table" -> metadata document (the catalog's copy of truth)
        self.tables: dict[str, dict] = {}
        self.requests: list[tuple[str, str]] = []  # (method, path) log
        self.conflicts = 0
        self._lock = threading.Lock()
        catalog = self

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

            def _error(self, code: int, message: str) -> None:
                self._reply(
                    code,
                    {
                        "error": {
                            "message": message,
                            "type": "CatalogError",
                            "code": code,
                        }
                    },
                )

            def _authed(self) -> bool:
                if catalog.token is None:
                    return True
                got = self.headers.get("Authorization", "")
                if got == f"Bearer {catalog.token}":
                    return True
                self._error(401, "invalid token")
                return False

            def do_GET(self) -> None:  # noqa: N802 — http.server API
                with catalog._lock:
                    catalog.requests.append(("GET", self.path))
                if not self._authed():
                    return
                parts = self.path.strip("/").split("/")
                if parts == ["v1", "config"]:
                    self._reply(
                        200,
                        {"defaults": {}, "overrides": {
                            "warehouse": catalog.warehouse
                        }},
                    )
                    return
                if (
                    len(parts) == 5
                    and parts[:2] == ["v1", "namespaces"]
                    and parts[3] == "tables"
                ):
                    key = f"{parts[2]}.{parts[4]}"
                    with catalog._lock:
                        meta = catalog.tables.get(key)
                    if meta is None:
                        self._error(404, f"table {key} not found")
                        return
                    self._reply(
                        200,
                        {
                            "metadata-location": f"{catalog.uri()}"
                            f"/metadata/{key}",
                            "metadata": meta,
                        },
                    )
                    return
                self._error(404, f"no route {self.path}")

            def do_POST(self) -> None:  # noqa: N802 — http.server API
                with catalog._lock:
                    catalog.requests.append(("POST", self.path))
                if not self._authed():
                    return
                length = int(self.headers.get("Content-Length", "0"))
                body = (
                    json.loads(self.rfile.read(length)) if length else {}
                )
                parts = self.path.strip("/").split("/")
                if parts == ["v1", "namespaces"]:
                    ns = ".".join(body["namespace"])
                    with catalog._lock:
                        if ns in catalog.namespaces:
                            self._error(409, f"namespace {ns} exists")
                            return
                        catalog.namespaces.add(ns)
                    self._reply(200, {"namespace": body["namespace"]})
                    return
                if (
                    len(parts) == 4
                    and parts[:2] == ["v1", "namespaces"]
                    and parts[3] == "tables"
                ):
                    self._create_table(parts[2], body)
                    return
                if (
                    len(parts) == 5
                    and parts[:2] == ["v1", "namespaces"]
                    and parts[3] == "tables"
                ):
                    self._commit_table(f"{parts[2]}.{parts[4]}", body)
                    return
                self._error(404, f"no route {self.path}")

            def _create_table(self, ns: str, body: dict) -> None:
                name = body["name"]
                key = f"{ns}.{name}"
                with catalog._lock:
                    if key in catalog.tables:
                        self._error(409, f"table {key} exists")
                        return
                    location = body.get("location") or os.path.join(
                        catalog.warehouse, *ns.split("."), name
                    )
                    import time as _t
                    import uuid as _uuid

                    meta = {
                        "format-version": 2,
                        "table-uuid": str(_uuid.uuid4()),
                        "location": location,
                        "last-sequence-number": 0,
                        "last-updated-ms": int(_t.time() * 1000),
                        "last-column-id": len(
                            body["schema"].get("fields", [])
                        ),
                        "current-schema-id": 0,
                        "schemas": [body["schema"]],
                        "default-spec-id": 0,
                        "partition-specs": [{"spec-id": 0, "fields": []}],
                        "last-partition-id": 999,
                        "default-sort-order-id": 0,
                        "sort-orders": [{"order-id": 0, "fields": []}],
                        "properties": body.get("properties", {}),
                        "current-snapshot-id": -1,
                        "snapshots": [],
                        "snapshot-log": [],
                        "metadata-log": [],
                        "refs": {},
                    }
                    catalog.tables[key] = meta
                os.makedirs(os.path.join(location, "metadata"), exist_ok=True)
                os.makedirs(os.path.join(location, "data"), exist_ok=True)
                self._reply(
                    200,
                    {
                        "metadata-location": f"{catalog.uri()}"
                        f"/metadata/{key}",
                        "metadata": meta,
                    },
                )

            def _commit_table(self, key: str, body: dict) -> None:
                with catalog._lock:
                    meta = catalog.tables.get(key)
                    if meta is None:
                        self._error(404, f"table {key} not found")
                        return
                    for req in body.get("requirements", ()):
                        kind = req.get("type")
                        if kind == "assert-table-uuid":
                            if req.get("uuid") != meta["table-uuid"]:
                                catalog.conflicts += 1
                                self._error(409, "table uuid mismatch")
                                return
                        elif kind == "assert-ref-snapshot-id":
                            current = meta.get("refs", {}).get(
                                req.get("ref", "main"), {}
                            ).get("snapshot-id")
                            if current != req.get("snapshot-id"):
                                catalog.conflicts += 1
                                self._error(
                                    409,
                                    f"ref {req.get('ref')} is at "
                                    f"{current}, not "
                                    f"{req.get('snapshot-id')}",
                                )
                                return
                        else:
                            self._error(
                                400, f"unsupported requirement {kind!r}"
                            )
                            return
                    for upd in body.get("updates", ()):
                        action = upd.get("action")
                        if action == "add-snapshot":
                            snap = upd["snapshot"]
                            meta["snapshots"].append(snap)
                            meta["last-sequence-number"] = max(
                                meta["last-sequence-number"],
                                snap.get("sequence-number", 0),
                            )
                            meta["last-updated-ms"] = snap.get(
                                "timestamp-ms",
                                meta["last-updated-ms"],
                            )
                            meta["snapshot-log"].append(
                                {
                                    "snapshot-id": snap["snapshot-id"],
                                    "timestamp-ms": snap.get(
                                        "timestamp-ms", 0
                                    ),
                                }
                            )
                        elif action == "set-snapshot-ref":
                            meta.setdefault("refs", {})[
                                upd.get("ref-name", "main")
                            ] = {
                                "snapshot-id": upd["snapshot-id"],
                                "type": upd.get("type", "branch"),
                            }
                            meta["current-snapshot-id"] = upd[
                                "snapshot-id"
                            ]
                        else:
                            self._error(
                                400, f"unsupported update {action!r}"
                            )
                            return
                    out = dict(meta)
                self._reply(
                    200,
                    {
                        "metadata-location": f"{catalog.uri()}"
                        f"/metadata/{key}",
                        "metadata": out,
                    },
                )

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        # request threads are joined at server_close
        self._httpd.daemon_threads = False
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fake-iceberg-rest", daemon=True
        )
        self._thread.start()

    def uri(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def close(self) -> None:
        """Stop serving and join the server's threads."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()
