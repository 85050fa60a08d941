"""The port's monitoring plane against the JAX package's (``internals/monitoring.py``):
``MonitoringLevel``; for the same connector, commit and operator state (with the
monitor's clock pinned and fresh registries) ``StatsMonitor.prometheus_text()`` is
byte-equal and the rich dashboard table renders the same text; the HTTP endpoint's
routes give the same status codes and bodies (``/metrics``, ``/timeseries``'s index,
a family query and a bad window, ``/requests``, ``/profile`` idle and running, an
unknown path); a streamed ``pw.run(with_http_server=True)`` ends with the same commit
and entry counts and the same per-operator insertions in both packages; ``AUTO``
without a terminal starts no monitor. The port's endpoint keeps a route's exception
and raises it when the server stops."""

from __future__ import annotations

import io
import json
import socket
import threading
import time
import types
import urllib.error
import urllib.request

import pytest
from rich.console import Console

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import metrics as jm
from pathway_tpu.internals import monitoring as jmon
from pathway_tpu.internals import profiling as jprof
from pathway_tpu.internals import timeseries as jts
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch.internals import metrics as tm
from pathway_tpu_torch.internals import monitoring as tmon
from pathway_tpu_torch.internals import profiling as tprof
from pathway_tpu_torch.internals import timeseries as tts
from pathway_tpu_torch.internals.parse_graph import G as TG

PACKAGES = {"jax": (jpw, jmon, jm, jts, jprof), "torch": (tpw, tmon, tm, tts, tprof)}


@pytest.fixture(autouse=True)
def _clear():
    yield
    TG.clear()
    JG.clear()


@pytest.fixture
def pinned(monkeypatch):
    """Each package's monitor clock pinned, and fresh registries, request logs, history
    stores and sentinels, so two monitors fed the same state render the same bytes."""
    clock = types.SimpleNamespace(monotonic=lambda: 500.0)
    for _pw, mon, m, ts, _prof in PACKAGES.values():
        monkeypatch.setattr(mon, "_time", clock)
        monkeypatch.setattr(m, "REGISTRY", m.Registry())
        monkeypatch.setattr(m, "REQUESTS", m.RequestLog())
        monkeypatch.setattr(ts, "STORE", ts.TimeSeriesStore())
        monkeypatch.setattr(ts, "SENTINEL", ts.SloSentinel())
    monkeypatch.delenv("PATHWAY_PROCESS_ID", raising=False)


def test_monitoring_levels_agree():
    assert [(x.name, x.value) for x in jmon.MonitoringLevel] == [
        (x.name, x.value) for x in tmon.MonitoringLevel]
    assert jpw.MonitoringLevel.__members__.keys() == tpw.MonitoringLevel.__members__.keys()


def _stats(insertions, deletions, batches, time_spent):
    return types.SimpleNamespace(insertions=insertions, deletions=deletions, batches=batches,
                                 time_spent=time_spent)


def _monitor(mon, m, level_name: str = "ALL"):
    """A monitor in one package with two connectors (one done), three commits, a
    scheduler with three operators' probe stats, the registry holding a counter and a
    histogram, and one mesh peer."""
    monitor = mon.StatsMonitor(mon.MonitoringLevel[level_name])
    a = monitor.connector("docs")
    a.entries, a.batches, a.last_entry_at = 1200, 5, 499.25
    b = monitor.connector('q"ueries')
    b.entries, b.batches, b.finished = 64, 64, True
    for t in range(3):
        monitor.on_commit(t, 499.5)
    nodes = [types.SimpleNamespace(index=i, name=n)
             for i, n in enumerate(["input<docs>", "udf<embed>", "subscribe"])]
    monitor.scheduler = types.SimpleNamespace(
        stats={0: _stats(1200, 0, 5, 0.001), 1: _stats(1200, 200, 5, 1.75),
               2: _stats(7, 1, 3, 0.0)},
        scope=types.SimpleNamespace(nodes=nodes), n_processes=2)
    m.REGISTRY.counter("pathway_connector_entries_total", "entries", connector="docs").inc(1200)
    m.REGISTRY.histogram("pathway_ingest_to_sink_latency_seconds", "latency",
                         buckets=(0.01, 0.1)).observe_n(0.05, 12)
    peer = m.Registry()
    peer.counter("pathway_operator_batches_total", "b", index="0").inc(4)
    peer.gauge("pathway_operator_rows", "r", index="0").set(9)
    monitor.mesh_snapshots = {1: peer.snapshot(), 3: peer.snapshot()}  # 3: past the width
    return monitor


@pytest.mark.parametrize("level", ["ALL", "IN_OUT"])
def test_prometheus_text_is_byte_equal(pinned, level):
    texts = {name: _monitor(mon, m, level).prometheus_text()
             for name, (_pw, mon, m, _ts, _prof) in PACKAGES.items()}
    assert texts["jax"] == texts["torch"]
    fams = tm.validate_exposition(texts["torch"])
    assert fams["pathway_commits_total"]["samples"][0][2] == 3
    assert {la.get("worker") for _n, la, _v in fams["pathway_operator_batches_total"]["samples"]} == {
        None, "0", "1"}


@pytest.mark.parametrize("level", ["ALL", "IN_OUT"])
def test_dashboard_table_renders_the_same_text(pinned, level):
    def render(mon, m):
        console = Console(file=io.StringIO(), width=120, color_system=None)
        console.print(_monitor(mon, m, level)._table())
        return console.file.getvalue()

    texts = {name: render(mon, m) for name, (_pw, mon, m, _ts, _prof) in PACKAGES.items()}
    assert texts["jax"] == texts["torch"]
    # rich reads "[commits]" and "[worker 1]" as markup, in both packages alike
    assert "done" in texts["torch"] and "1.75" not in texts["torch"]
    assert ("op:udf<embed>#1" in texts["torch"]) == (level == "ALL")
    # the table lists every mesh peer (the exposition filters by the scheduler's width)
    assert texts["torch"].count("│       9 │       4 │") == 2


def _get(port: int, path: str) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _routes(mon, m, ts, prof) -> dict:
    monitor = _monitor(mon, m)
    ts.STORE.ingest_snapshot(m.REGISTRY.snapshot(), "0", t=time.time() - 1)
    ts.STORE.ingest_snapshot(m.REGISTRY.snapshot(), "0")
    ts.SENTINEL.configure([ts.SloSpec("floor", "throughput", "pathway_connector_entries_total", 1.0)])
    m.REQUESTS.record(endpoint="/serving/query", status=200, wall=1.5)
    server = mon.MonitoringHttpServer(monitor, port=0)
    try:
        out = {}
        for path in ("/", "/metrics", "/timeseries", "/requests", "/profile", "/nope",
                     "/timeseries?family=pathway_connector_entries_total&window=30&worker=0",
                     "/timeseries?family=pathway_connector_entries_total&window=soon"):
            code, body = _get(server.port, path)
            if path.startswith("/timeseries?") and code == 200:
                body = json.loads(body)
                body.pop("now")  # the wall clock of the read
                for series in body["series"]:  # the values, not the wall clock's stamps
                    series["points"] = [v for _t, v in series["points"]]
            out[path] = (code, body)
        prof.PROFILER.configure(enabled=True, hz=200.0, clear=True)
        assert prof.PROFILER.maybe_start()
        time.sleep(0.1)
        code, body = _get(server.port, "/profile")
        doc = json.loads(body)
        prof.validate_profile(doc)
        out["/profile running"] = (code, sorted(doc), sorted(doc["workers"]))
        return out
    finally:
        prof.PROFILER.stop()
        prof.PROFILER.configure(enabled=False, clear=True)
        server.stop()


def test_routes_give_the_same_codes_and_bodies(pinned):
    got = {name: _routes(mon, m, ts, prof) for name, (_pw, mon, m, ts, prof) in PACKAGES.items()}
    assert got["jax"] == got["torch"]
    codes = {path: code for path, (code, *_rest) in got["torch"].items()}
    assert codes == {"/": 200, "/metrics": 200, "/timeseries": 200, "/requests": 200,
                     "/profile": 404, "/nope": 404, "/profile running": 200,
                     "/timeseries?family=pathway_connector_entries_total&window=30&worker=0": 200,
                     "/timeseries?family=pathway_connector_entries_total&window=soon": 400}
    series = got["torch"]["/timeseries?family=pathway_connector_entries_total&window=30&worker=0"][1]
    assert [len(s["points"]) for s in series["series"]] == [2]


def test_a_raising_route_raises_when_the_port_server_stops(pinned):
    """The JAX package's handler thread prints the error and closes the connection;
    the port's does the same and keeps the error, which ``stop`` raises."""
    monitor = tmon.StatsMonitor()

    def card_error():
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monitor.prometheus_text = card_error
    server = tmon.MonitoringHttpServer(monitor, port=0)
    with pytest.raises((urllib.error.URLError, ConnectionError)):
        _get(server.port, "/metrics")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        server.stop()
    server.stop()  # the error is raised once


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _watched_run(pw, mon, monkeypatch) -> dict:
    """A streamed pw.run (3 commits of 40 rows through a select and a filter) with the
    HTTP endpoint on a free port; the monitor's exposition and probe stats read when the
    run stops it."""
    seen: dict = {}
    stop = mon.StatsMonitor.stop

    def reading_stop(self):
        seen["text"] = self.prometheus_text()
        seen["insertions"] = sorted(st.insertions for st in self.scheduler.stats.values())
        stop(self)

    monkeypatch.setattr(mon.StatsMonitor, "stop", reading_stop)

    landed = threading.Semaphore(0)
    rows: list = []

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for c in range(3):  # each batch a commit of its own, its rows at the sink first
                for i in range(40):
                    self.next(k=i % 5, v=c * 100 + i)
                self.commit()
                assert landed.acquire(timeout=60)

    def on_change(key, row, time, is_addition):
        rows.append(row["w"])
        if len(rows) % 32 == 0:  # the filter keeps 32 of a batch's 40 rows
            landed.release()

    t = pw.io.python.read(Feed(), schema=pw.schema_from_types(k=int, v=int),
                          autocommit_duration_ms=None)
    out = t.select(k=pw.this.k, w=pw.this.v * 2).filter(pw.this.k > 0)
    pw.io.subscribe(out, on_change=on_change)
    port = _free_port()
    pw.run(monitoring_level=pw.MonitoringLevel.NONE, with_http_server=True,
           monitoring_server_port=port)
    fams = tm.validate_exposition(seen["text"])
    unlabelled = {name: [(la, v) for _n, la, v in fams[name]["samples"] if "worker" not in la]
                  for name in ("pathway_commits_total", "pathway_input_entries_total")}
    with socket.socket() as s:
        # the run released its port: a server binds it again (with SO_REUSEADDR, as
        # http.server does: closed connections linger in TIME_WAIT)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
        s.listen()
    return {"families": unlabelled, "insertions": seen["insertions"]}


def test_a_watched_streamed_run_agrees(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")  # no card here: the host kernels
    monkeypatch.setenv("PATHWAY_TPU_TS_INTERVAL", "0.05")
    got = {name: _watched_run(pw, mon, monkeypatch) for name, (pw, mon, *_r) in PACKAGES.items()}
    assert got["jax"] == got["torch"]
    # each commit message counts as an entry, in both packages; the end of the feed
    # is a commit of its own
    assert got["torch"]["families"] == {
        "pathway_commits_total": [({}, 4.0)],
        "pathway_input_entries_total": [({"connector": "python-connector"}, 123.0)]}
    alive = [t.name for t in threading.enumerate()
             if t.name == "pathway-timeseries" or "serve_forever" in t.name]
    assert not alive and tts._LOOP is None and jts._LOOP is None


def test_auto_without_a_terminal_starts_no_monitor(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")
    made = []
    for name, (pw, mon, *_r) in PACKAGES.items():
        init = mon.StatsMonitor.__init__

        def counting(self, *a, _init=init, _name=name, **kw):
            made.append(_name)
            _init(self, *a, **kw)

        monkeypatch.setattr(mon.StatsMonitor, "__init__", counting)
        monkeypatch.setattr("sys.stderr.isatty", lambda: False)
        rows = []
        pw.io.subscribe(pw.debug.table_from_markdown("v\n1\n2"),
                        on_change=lambda key, row, time, is_addition, _r=rows: _r.append(row["v"]))
        pw.run(monitoring_level=pw.MonitoringLevel.AUTO)
        assert sorted(rows) == [1, 2]
    assert made == []
