"""Observability: live console dashboard, per-operator probes, Prometheus.

Counterpart of ``pathway_tpu/internals/monitoring.py``, with the same names, routes,
port and exposition:

- :class:`StatsMonitor` collects run-wide stats (connector rows, commits, the last
  commit's latency, the scheduler's per-operator probe stats) and renders them as a
  live ``rich`` table (imported when the dashboard starts, as in the JAX package: a
  host without ``rich`` raises ``ImportError`` there);
- :meth:`StatsMonitor.prometheus_text` renders one exposition of three layers: the
  unlabelled local series, this process's full registry snapshot under
  ``worker="<process_id>"``, and every mesh snapshot in ``mesh_snapshots`` (on
  process 0 of a mesh, the followers' snapshots that ``DistributedGraphRunner`` feeds
  it as they arrive on the round frames; empty in one process);
- :class:`MonitoringHttpServer` serves it on port 20000 + ``PATHWAY_PROCESS_ID``
  (``/`` and ``/metrics``), with ``/timeseries`` (the history ring and SLO specs of
  ``internals/timeseries.py``), ``/requests`` (the request ring) and ``/profile`` (the
  sampling profiler's document; 404 while it is off).

``pw.run(monitoring_level=pw.MonitoringLevel.ALL, with_http_server=True)`` wires all
three; the endpoint stays scrapeable for the lifetime of the run. The read tier's
replica snapshots, which the JAX package's exposition adds under ``worker="r<id>"``,
wait for the serving tier (item 8). A route that raises in a handler thread (a card
error read by a pull collector, say) closes that connection, as in the JAX package,
and the server keeps the first such exception: :meth:`MonitoringHttpServer.stop`
raises it on the caller's thread (ROADMAP: deliberate differences).
"""

from __future__ import annotations

import enum
import http.server
import sys
import threading
import time as _time
from typing import Any


class MonitoringLevel(enum.Enum):
    AUTO = "auto"
    NONE = "none"
    IN_OUT = "in_out"  # connector stats only
    ALL = "all"  # + per-operator stats


class ConnectorStats:
    """Input-side counters (reference connectors/monitoring.rs)."""

    __slots__ = ("name", "entries", "batches", "last_entry_at", "finished")

    def __init__(self, name: str) -> None:
        self.name = name
        self.entries = 0
        self.batches = 0
        self.last_entry_at: float | None = None
        self.finished = False

    @property
    def lag_seconds(self) -> float | None:
        if self.finished or self.last_entry_at is None:
            return None
        return max(0.0, _time.monotonic() - self.last_entry_at)


class StatsMonitor:
    """Collects run-wide stats; optionally renders them as a live rich
    table (reference StatsMonitor monitoring.py:165)."""

    def __init__(
        self,
        level: MonitoringLevel = MonitoringLevel.IN_OUT,
        refresh_per_second: float = 4.0,
        console: Any = None,
    ) -> None:
        self.level = level
        #: per-operator probing costs a timing pair per node per batch;
        #: only pay it when something reads the stats (ALL dashboard or a
        #: Prometheus endpoint, which sets this True)
        self.wants_operator_stats = level == MonitoringLevel.ALL
        self.connectors: dict[str, ConnectorStats] = {}
        self.scheduler: Any = None
        #: peer process id -> piggybacked metrics snapshot; the distributed
        #: runner points this at DistributedScheduler.mesh_metrics so the
        #: leader's endpoint exposes the whole mesh with worker labels
        self.mesh_snapshots: dict[int, dict] = {}
        self.started = _time.monotonic()
        self.commits = 0
        self.output_rows = 0
        self._latency_ms: float | None = None
        self._live = None
        self._refresh = refresh_per_second
        self._console = console
        self._last_render = 0.0

    # -- collection ----------------------------------------------------------

    def connector(self, name: str) -> ConnectorStats:
        st = self.connectors.get(name)
        if st is None:
            st = self.connectors[name] = ConnectorStats(name)
        return st

    def on_commit(self, time: int, wall_start: float) -> None:
        self.commits += 1
        self._latency_ms = (_time.monotonic() - wall_start) * 1000.0
        self.maybe_render()

    # -- rendering -----------------------------------------------------------

    def _table(self):
        from rich.table import Table as RichTable

        table = RichTable(title="pathway_tpu progress")
        table.add_column("connector")
        table.add_column("entries", justify="right")
        table.add_column("batches", justify="right")
        table.add_column("lag", justify="right")
        for st in self.connectors.values():
            lag = st.lag_seconds
            table.add_row(
                st.name,
                str(st.entries),
                str(st.batches),
                "done" if st.finished else (f"{lag:.2f}s" if lag else "-"),
            )
        table.add_row(
            "[commits]",
            str(self.commits),
            "-",
            f"{self._latency_ms:.1f}ms" if self._latency_ms else "-",
        )
        if self.level == MonitoringLevel.ALL and self.scheduler is not None:
            for node in self.scheduler.scope.nodes:
                st = self.scheduler.stats.get(node.index)
                if st is None:
                    continue
                table.add_row(
                    f"  op:{node.name}#{node.index}",
                    str(st.insertions - st.deletions),
                    str(st.batches),
                    f"{st.time_spent * 1000:.0f}ms",
                )
        for peer in sorted(self.mesh_snapshots):
            snap = self.mesh_snapshots[peer]

            def total(family: str) -> float:
                fam = snap.get(family) or {}
                return sum(
                    s.get("value", 0.0) for s in fam.get("series", ())
                )

            table.add_row(
                f"[worker {peer}]",
                str(int(total("pathway_operator_rows"))),
                str(int(total("pathway_operator_batches_total"))),
                f"{total('pathway_operator_time_seconds') * 1000:.0f}ms",
            )
        return table

    def start_live(self) -> None:
        from rich.live import Live

        self._live = Live(
            self._table(),
            refresh_per_second=self._refresh,
            console=self._console,
        )
        self._live.start()

    def maybe_render(self) -> None:
        if self._live is None:
            return
        now = _time.monotonic()
        if now - self._last_render >= 1.0 / self._refresh:
            self._live.update(self._table())
            self._last_render = now

    def stop(self) -> None:
        if self._live is not None:
            self._live.update(self._table())
            self._live.stop()
            self._live = None

    # -- prometheus ----------------------------------------------------------

    def prometheus_text(self) -> str:
        """OpenMetrics text format (reference http_server.rs:96-194).

        Three layers share one exposition, each family getting exactly one
        HELP/TYPE block:

        - the legacy unlabelled local series (commits, uptime, connector
          entries, per-operator rows/time) — backwards compatible;
        - this process's full registry snapshot (exchange counters, native
          kernel hits/ns, optimizer stats, ingest->sink latency histogram)
          under ``worker="<process_id>"``;
        - in a mesh run, every follower's piggybacked snapshot under its
          own ``worker`` label — the leader exposes the whole mesh.

        Live dicts are copied before they are walked: the run thread inserts
        concurrently with scrapes.
        """
        import os

        from pathway_tpu_torch.internals import metrics as _metrics

        legacy: dict = {}
        samples = [
            (
                "pathway_commits_total",
                "counter",
                "commits completed by this run",
                {},
                self.commits,
            ),
            (
                "pathway_uptime_seconds",
                "gauge",
                "seconds since the run started",
                {},
                _time.monotonic() - self.started,
            ),
        ]
        if self._latency_ms is not None:
            samples.append(
                (
                    "pathway_commit_latency_ms",
                    "gauge",
                    "wall latency of the most recent commit",
                    {},
                    self._latency_ms,
                )
            )
        # snapshot: the run thread inserts concurrently with scrapes
        for st in list(self.connectors.values()):
            samples.append(
                (
                    "pathway_input_entries_total",
                    "counter",
                    "entries ingested per connector",
                    {"connector": st.name},
                    st.entries,
                )
            )
        _metrics.merge_samples(legacy, samples)
        if self.scheduler is not None:
            _metrics.merge_samples(
                legacy,
                _metrics.operator_samples(
                    dict(self.scheduler.stats),
                    list(self.scheduler.scope.nodes),
                ),
            )
        worker = os.environ.get("PATHWAY_PROCESS_ID", "0")
        snaps: dict[str, dict] = {"": legacy}
        snaps[worker] = _metrics.full_snapshot(self.scheduler)
        # defensive stale-incarnation filter: recovery/failover prune the
        # scheduler's mesh_metrics dict (this dict aliases it) when a
        # worker dies; a rescale that shrank the mesh relaunches with a
        # narrower width, so snapshots beyond it are a dead incarnation's
        # (a normally-finished peer's closed socket is NOT death — its
        # final snapshot stays visible)
        width = getattr(self.scheduler, "n_processes", None)
        for peer in sorted(self.mesh_snapshots):
            if width is not None and peer >= width:
                continue
            snaps[str(peer)] = self.mesh_snapshots[peer]
        return _metrics.render_snapshots(snaps)


class MonitoringHttpServer:
    """Prometheus endpoint thread on port 20000 + process_id
    (reference http_server.rs:22)."""

    BASE_PORT = 20000

    def __init__(self, monitor: StatsMonitor, port: int | None = None) -> None:
        import os

        monitor.wants_operator_stats = True
        if port is None:
            port = self.BASE_PORT + int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
        monitor_ref = monitor

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802
                from urllib.parse import parse_qs, urlparse

                parsed = urlparse(self.path)
                if parsed.path in ("/metrics", "/"):
                    body = monitor_ref.prometheus_text().encode()
                    self._reply(200, body, "text/plain; version=0.0.4")
                    return
                if parsed.path == "/timeseries":
                    self._timeseries(parse_qs(parsed.query))
                    return
                if parsed.path == "/requests":
                    self._requests()
                    return
                if parsed.path == "/profile":
                    self._profile()
                    return
                self.send_response(404)
                self.end_headers()

            def _reply(
                self, code: int, body: bytes, ctype: str = "application/json"
            ) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _timeseries(self, query: dict) -> None:
                """``/timeseries?family=...&window=...`` — windowed reads
                off the history ring (internals/timeseries.py); extra
                query params filter on series labels.  Without a family,
                an index of recorded families + ring bound stats."""
                import json as _json

                from pathway_tpu_torch.internals import timeseries as _ts

                family = (query.get("family") or [None])[0]
                if not family:
                    payload = {
                        "families": _ts.STORE.families(),
                        "stats": _ts.STORE.stats(),
                        "slos": [s.to_dict() for s in _ts.SENTINEL.specs()],
                    }
                    self._reply(200, _json.dumps(payload).encode())
                    return
                try:
                    window = float((query.get("window") or ["60"])[0])
                except ValueError:
                    self._reply(
                        400, b'{"error": "window must be a number"}'
                    )
                    return
                labels = {
                    k: v[0]
                    for k, v in query.items()
                    if k not in ("family", "window") and v
                }
                result = _ts.STORE.query(family, window, labels)
                self._reply(200, _json.dumps(result).encode())

            def _requests(self) -> None:
                """``/requests`` — the bounded per-request wide-event
                ring (one structured record per served read-tier
                request, newest last)."""
                import json as _json

                from pathway_tpu_torch.internals import metrics as _m

                events = _m.REQUESTS.snapshot()
                payload = {"requests": events, "count": len(events)}
                self._reply(
                    200, _json.dumps(payload, default=repr).encode()
                )

            def _profile(self) -> None:
                """``/profile`` — the merged profile document (this
                worker plus, on the leader, every absorbed peer
                payload); 404 while the sampling profiler is off."""
                import json as _json

                from pathway_tpu_torch.internals import profiling as _prof

                doc = _prof.profile_document(_prof.PROFILER.mesh_payloads())
                if not doc["workers"]:
                    self._reply(
                        404,
                        b'{"error": "profiler not running '
                        b'(set PATHWAY_TPU_PROFILE=1)"}',
                    )
                    return
                self._reply(200, _json.dumps(doc, default=repr).encode())

            def log_message(self, *args: Any) -> None:
                pass

        #: the first exception a route raised in a handler thread; ``stop`` raises it
        self.error: BaseException | None = None
        watch = self

        class Server(http.server.ThreadingHTTPServer):
            def handle_error(self, request: Any, client_address: Any) -> None:
                exc = sys.exc_info()[1]
                # a client that hangs up is not the server's error
                if watch.error is None and not isinstance(exc, ConnectionError):
                    watch.error = exc
                super().handle_error(request, client_address)

        self.server = Server(("127.0.0.1", port), Handler)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(
            target=self.server.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        """Shut the server down and join its thread; then raise the first exception
        a route raised in a handler thread, if any."""
        self.server.shutdown()
        self.server.server_close()
        # join the serve thread so a raising run cannot leak it (nor keep
        # the port bound through a lingering accept loop); idempotent
        thread = getattr(self, "_thread", None)
        if thread is not None and thread.is_alive():
            thread.join(timeout=5.0)
        error, self.error = self.error, None
        if error is not None:
            raise error
