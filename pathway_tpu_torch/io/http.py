"""``pw.io.http``: the REST ingress (a webserver and the request/response connector
pair), and the polling HTTP reader and the POSTing writer.

Counterpart of ``pathway_tpu/io/http.py``. Each HTTP request to a
:func:`rest_connector` route becomes a row of its query table, keyed by a fresh request
id; a writer subscribed to the result table resolves the request's pending future when
the row's answer arrives, and the handler replies with the answer's columns as JSON
(a single ``result`` column is unwrapped). With ``delete_completed_queries`` the
request's row is deleted once it has its answer (or timed out). Malformed JSON answers
400, an answer later than ``request_timeout`` 504.

One :class:`PathwayWebserver` (aiohttp, on a thread of its own with its own event loop)
serves any number of routes, an OpenAPI 3.0.3 description of them at ``/_schema``
(``?format=json``, or YAML by default) and, with ``with_cors``, the CORS headers and
preflight answers. The server starts when a route's response writer is attached;
``start`` returns once it listens, and a server thread that fails (a port already
bound) raises its exception on the caller's thread. ``stop`` closes the port and ends
the query stream of every route, so a run over them can end.

The futures are resolved on the run thread, by the result table's subscriber: a query's
answer reaches it when its commit completes (under the async device pipeline, when the
card's work of that commit is done), so every request waits at least one commit.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import copy
import json
import threading
import time as _time
import uuid
from typing import Any, Callable, Sequence

from pathway_tpu_torch.engine.connectors import (
    IdentityParser,
    JsonLinesParser,
    ParsedEvent,
    QueueReader,
    Reader,
)
from pathway_tpu_torch.engine.value import Json, Pointer, ref_scalar
from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io._utils import attach_writer, input_table

__all__ = [
    "PathwayWebserver",
    "RestResponseWriter",
    "RetryPolicy",
    "read",
    "rest_connector",
    "write",
]

_REQUEST_ID = "_pw_request_id"
#: seconds ``PathwayWebserver.start`` waits for the server thread to listen
_START_TIMEOUT_S = 10.0


def _openapi_type(dtype: Any) -> dict:
    """A pw dtype -> its OpenAPI property schema, matched on the dtype's repr: scalars
    print as upper-case names (INT, STR, ...), composites as constructors (List(INT),
    Tuple(...), Array(...), Pointer)."""
    base = dtype.strip_optional() if hasattr(dtype, "strip_optional") else dtype
    name = repr(base)
    mapping = {
        "INT": {"type": "integer"},
        "FLOAT": {"type": "number", "format": "double"},
        "BOOL": {"type": "boolean"},
        "STR": {"type": "string"},
        "BYTES": {"type": "string", "format": "byte"},
        "DATE_TIME_NAIVE": {"type": "string", "format": "date-time"},
        "DATE_TIME_UTC": {"type": "string", "format": "date-time"},
        "DURATION": {"type": "string"},
        "JSON": {},  # free-form
    }
    for key, spec in mapping.items():
        if name.startswith(key):
            return dict(spec)
    if name.startswith(("List", "Tuple", "Array")):
        return {"type": "array"}
    if name.startswith("Pointer"):
        return {"type": "string"}
    return {}


class PathwayWebserver:
    """One aiohttp server shared by any number of :func:`rest_connector` routes, with
    the OpenAPI description at ``/_schema`` (``with_schema_endpoint``) and CORS
    (``with_cors``: ``Access-Control-Allow-*`` on every response, preflight
    ``OPTIONS`` answered)."""

    _CORS_HEADERS = {
        "Access-Control-Allow-Origin": "*",
        "Access-Control-Allow-Headers": "*",
        "Access-Control-Allow-Methods": "GET, POST, OPTIONS",
        "Access-Control-Expose-Headers": "*",
    }

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8080,
        with_schema_endpoint: bool = True,
        with_cors: bool = False,
    ) -> None:
        self.host = host
        self.port = port
        self.with_cors = with_cors
        self._routes: dict[str, Callable] = {}
        self._started = False
        self._loop: asyncio.AbstractEventLoop | None = None
        self._ready = threading.Event()
        self._thread: threading.Thread | None = None
        #: what the server thread raised before it listened
        self._error: BaseException | None = None
        #: called by ``stop``: each route's query stream closes
        self._on_stop: list[Callable[[], None]] = []
        self._openapi: dict[str, Any] = {
            "openapi": "3.0.3",
            "info": {
                "title": "pathway_tpu generated openapi description",
                "version": "1.0.0",
            },
            "paths": {},
            "servers": [{"url": f"http://{host}:{port}/"}],
        }
        if with_schema_endpoint:
            self._routes["/_schema"] = self._schema_handler

    def add_route(
        self,
        route: str,
        handler: Callable,
        schema: Any | None = None,
        methods: Sequence[str] = ("GET", "POST"),
    ) -> None:
        if self._started:
            raise RuntimeError("cannot add routes after the server started")
        self._routes[route] = handler
        if schema is not None:
            self._openapi["paths"][route] = self._route_docs(schema, methods)

    def _route_docs(self, schema: Any, methods: Sequence[str]) -> dict:
        columns = schema.column_names()
        dtypes = dict(schema.dtypes())
        required = [n for n in columns if not getattr(dtypes[n], "is_optional", lambda: False)()]
        properties = {n: _openapi_type(dtypes[n]) for n in columns}
        docs: dict[str, Any] = {}
        if "POST" in methods:
            docs["post"] = {
                "requestBody": {
                    "content": {
                        "application/json": {
                            "schema": {
                                "type": "object",
                                "properties": properties,
                                "required": required,
                            }
                        }
                    },
                    "required": True,
                },
                "responses": {"200": {"description": "OK"}},
            }
        if "GET" in methods:
            docs["get"] = {
                "parameters": [
                    {
                        "name": n,
                        "in": "query",
                        "required": n in required,
                        "schema": properties[n] or {"type": "string"},
                    }
                    for n in columns
                ],
                "responses": {"200": {"description": "OK"}},
            }
        return docs

    def openapi_description_json(self, origin: str | None = None) -> dict:
        desc = copy.deepcopy(self._openapi)
        if origin:
            desc["servers"] = [{"url": origin}]
        return desc

    async def _schema_handler(self, request: Any):
        from aiohttp import web

        origin = f"{request.scheme}://{request.host}"
        fmt = request.query.get("format", "yaml")
        desc = self.openapi_description_json(origin)
        if fmt == "json":
            return web.json_response(desc)
        if fmt != "yaml":
            return web.json_response(
                {"error": f"unknown format {fmt!r}; use 'json' or 'yaml'"}, status=400
            )
        import yaml

        return web.Response(text=yaml.safe_dump(desc, sort_keys=False), content_type="text/x-yaml")

    def _serve(self) -> None:
        """The server thread: its own event loop, the app, the listening socket; runs
        until ``stop``. An error before it listens is kept for ``start`` to raise."""
        loop = runner = None
        try:
            from aiohttp import web

            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            middlewares = []
            if self.with_cors:
                cors_headers = self._CORS_HEADERS

                @web.middleware
                async def cors_middleware(request, handler):
                    if request.method == "OPTIONS":
                        return web.Response(headers=cors_headers)
                    resp = await handler(request)
                    resp.headers.update(cors_headers)
                    return resp

                middlewares.append(cors_middleware)
            app = web.Application(middlewares=middlewares)
            for route, handler in self._routes.items():
                app.router.add_post(route, handler)
                app.router.add_get(route, handler)
                if self.with_cors:
                    app.router.add_route("OPTIONS", route, handler)
            runner = web.AppRunner(app)
            loop.run_until_complete(runner.setup())
            site = web.TCPSite(runner, self.host, self.port)
            loop.run_until_complete(site.start())
        except BaseException as e:  # noqa: BLE001 — raised by start() on the caller's thread
            self._error = e
            if loop is not None:
                if runner is not None:
                    loop.run_until_complete(runner.cleanup())
                loop.close()
            self._ready.set()
            return
        self._ready.set()
        try:
            loop.run_forever()
        finally:
            loop.run_until_complete(runner.cleanup())  # closes the listening socket
            loop.close()

    def start(self) -> None:
        """Start the server thread and return once it listens. A thread that fails
        first (the port already bound, aiohttp missing) raises its exception here."""
        if self._started:
            return
        self._started = True
        self._thread = threading.Thread(target=self._serve, name="pw-webserver", daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout=_START_TIMEOUT_S):
            raise TimeoutError(
                f"the webserver on {self.host}:{self.port} did not start in {_START_TIMEOUT_S} s"
            )
        if self._error is not None:
            raise self._error

    def stop(self, timeout: float = 30.0) -> None:
        """Close the port (the server thread ends) and end every route's query stream,
        so a run over them ends once it has answered what it holds."""
        loop, thread = self._loop, self._thread
        if loop is not None and thread is not None and thread.is_alive():
            loop.call_soon_threadsafe(loop.stop)
            thread.join(timeout)
        for close in self._on_stop:
            close()


class RestResponseWriter:
    """Resolves the pending HTTP futures from the result table's update stream."""

    def __init__(self, futures: dict[Pointer, concurrent.futures.Future]):
        self._futures = futures

    def attach(self, result_table: Table, runner: Any) -> None:
        node = runner.build(result_table)
        names = result_table.column_names()

        def on_change(key: Pointer, row: tuple, time: int, diff: int) -> None:
            if diff <= 0:
                return
            fut = self._futures.pop(key, None)
            if fut is not None and not fut.done():
                fut.set_result({n: v for n, v in zip(names, row)})

        runner.scope.subscribe_table(node, on_change=on_change)


def rest_connector(
    host: str = "127.0.0.1",
    port: int = 8080,
    *,
    schema: schema_mod.SchemaMetaclass,
    route: str = "/",
    webserver: PathwayWebserver | None = None,
    delete_completed_queries: bool = True,
    request_timeout: float = 30.0,
) -> tuple[Table, Callable[[Table, Any], None]]:
    """-> ``(query_table, attach_response)``. ``attach_response(result_table, runner)``
    (a ``GraphRunner``) subscribes the result table, which must be keyed by the query
    table's ids, and starts the webserver; call it before the run starts."""
    server = webserver or PathwayWebserver(host, port)
    reader = QueueReader()
    futures: dict[Pointer, concurrent.futures.Future] = {}
    columns = schema.column_names()
    dtypes = dict(schema.dtypes())

    class _RestParser:
        def parse(self, payload: Any) -> list[ParsedEvent]:
            kind, rid, data = payload
            values = [rid]
            for name in columns:
                v = data.get(name)
                if dtypes[name].strip_optional() == dt.JSON and v is not None:
                    v = Json(v)
                values.append(v)
            return [ParsedEvent(kind, tuple(values))]

    full_schema = schema_mod.schema_from_dict(
        {
            _REQUEST_ID: {"dtype": dt.STR, "primary_key": True},
            **{n: dtypes[n] for n in columns},
        },
        name="RestRequestSchema",
    )

    async def handler(request: Any):
        from aiohttp import web

        try:
            if request.method == "GET":
                data = dict(request.query)
            else:
                data = await request.json()
        except (json.JSONDecodeError, ValueError):
            return web.json_response({"error": "invalid json"}, status=400)
        if not isinstance(data, dict):
            return web.json_response({"error": "request body must be a JSON object"}, status=400)
        rid = uuid.uuid4().hex
        key = ref_scalar(rid)
        fut: concurrent.futures.Future = concurrent.futures.Future()
        futures[key] = fut
        reader.push(("insert", rid, data), source_id=rid)
        try:
            result = await asyncio.wait_for(asyncio.wrap_future(fut), timeout=request_timeout)
        except asyncio.TimeoutError:
            futures.pop(key, None)
            return web.json_response({"error": "timeout"}, status=504)
        finally:
            if delete_completed_queries:
                reader.push(("delete", rid, data), source_id=rid)
        if isinstance(result, dict) and set(result) == {"result"}:
            result = result["result"]
        return web.json_response(_jsonable(result))

    server.add_route(route, handler, schema=schema)
    server._on_stop.append(reader.close)

    table = input_table(
        full_schema,
        make_reader=lambda: reader,
        make_parser=lambda _cols: _RestParser(),
        source_name=f"rest:{route}",
    )
    writer = RestResponseWriter(futures)

    def attach_response(result_table: Table, runner: Any) -> None:
        writer.attach(result_table, runner)
        # the port opens when a graph over the route is built, not at declaration
        server.start()

    return table, attach_response


def _jsonable(value: Any) -> Any:
    import numpy as np

    if isinstance(value, Json):
        return value.value
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.floating, np.integer)):
        return value.item()
    if isinstance(value, Pointer):
        return str(value)
    return value


# -- the generic HTTP reader and writer ------------------------------------------------


class RetryPolicy:
    """The HTTP writer's retry delays: ``first_delay_ms``, then times
    ``backoff_factor`` each retry."""

    def __init__(self, first_delay_ms: int = 1000, backoff_factor: float = 2.0):
        self.first_delay_ms = first_delay_ms
        self.backoff_factor = backoff_factor

    @classmethod
    def default(cls) -> "RetryPolicy":
        return cls()


class _HttpWriter:
    """POST one flat JSON object (the row's columns, ``time`` and ``diff``) a change.
    ``request_fn(url, payload)`` is injectable; the default POSTs with ``requests``. A
    failed POST is retried ``n_retries`` times on the policy's delays, then raises."""

    def __init__(
        self,
        endpoint: str,
        column_names: Sequence[str],
        request_fn: Callable[[str, dict], Any] | None,
        n_retries: int,
        retry_policy: RetryPolicy,
    ) -> None:
        self.endpoint = endpoint
        self.column_names = list(column_names)
        if request_fn is None:
            import requests

            def request_fn(url: str, payload: dict) -> None:
                requests.post(url, json=payload, timeout=30).raise_for_status()

        self.request_fn = request_fn
        self.n_retries = n_retries
        self.retry_policy = retry_policy

    def on_change(self, key: Pointer, values: tuple, time: int, diff: int) -> None:
        payload = {}
        for name, v in zip(self.column_names, values):
            payload[name] = v.value if isinstance(v, Json) else v
        payload["time"] = time
        payload["diff"] = diff
        delay = self.retry_policy.first_delay_ms / 1000.0
        for attempt in range(self.n_retries + 1):
            try:
                self.request_fn(self.endpoint, payload)
                return
            except Exception:
                if attempt == self.n_retries:
                    raise
                _time.sleep(delay)
                delay *= self.retry_policy.backoff_factor

    def on_time_end(self, time: int) -> None:
        pass

    def on_end(self) -> None:
        pass


def write(
    table: Table,
    url: str,
    *,
    n_retries: int = 0,
    retry_policy: RetryPolicy | None = None,
    request_fn: Callable[[str, dict], Any] | None = None,
    **kwargs: Any,
) -> None:
    """POST every change of ``table`` to ``url`` as one JSON object."""
    policy = retry_policy or RetryPolicy.default()
    attach_writer(
        table, lambda column_names: _HttpWriter(url, column_names, request_fn, n_retries, policy)
    )


def read(
    url: str,
    *,
    schema: schema_mod.SchemaMetaclass | None = None,
    format: str = "json",  # noqa: A002
    poll_interval_ms: int = 1000,
    request_fn: Callable[[str], Any] | None = None,
    n_retries: int = 0,
    **kwargs: Any,
) -> Table:
    """Poll ``url`` and parse each response body as JSON lines (``format="json"``) or
    lines of text (``"plaintext"``). A body equal to the last one is skipped, and a new
    body's rows replace the last body's. ``request_fn(url) -> str`` is injectable; the
    default GETs with ``requests``."""
    if request_fn is None:

        def request_fn(u: str) -> str:
            import requests

            resp = requests.get(u, timeout=30)
            resp.raise_for_status()
            return resp.text

    if format == "plaintext":
        schema = schema_mod.schema_from_types(data=str)
    if schema is None:
        raise ValueError("schema= is required for json format")

    class _HttpPollReader(Reader):
        # a re-poll is a re-read of the same source: its rows replace the last poll's
        replaces_sources = True

        def __init__(self) -> None:
            self._last_poll = 0.0
            self._polled_once = False
            self._last_body: str | None = None

        def poll(self):
            now = _time.monotonic()
            if now - self._last_poll < poll_interval_ms / 1000.0 and self._polled_once:
                return [], False
            self._last_poll = now
            self._polled_once = True
            delay = 0.5
            for attempt in range(n_retries + 1):
                try:
                    body = request_fn(url)
                    break
                except Exception:
                    if attempt == n_retries:
                        raise
                    _time.sleep(delay)
                    delay *= 2
            if not body or body == self._last_body:
                return [], False
            self._last_body = body
            return [(body, url, {})], False

    make_parser = (
        (lambda names: JsonLinesParser(names))
        if format == "json"
        else (lambda names: IdentityParser(split_lines=True))
    )
    return input_table(schema, _HttpPollReader, make_parser, source_name=f"http:{url}")
