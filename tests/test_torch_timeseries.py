"""The port's metrics history ring and SLO sentinel against the JAX package's
(``internals/timeseries.py``): the same appends, observations and snapshots give the
same points, windowed queries, family index and bound stats (the series cap and the
tier down-sampling included); the read-tier derivation and the worker pruning agree;
``SloSpec`` validates and round-trips alike; the sentinel gives the same reports for
each of its four kinds, with one edge-triggered ``slo_burn`` flight event, and loads
``PATHWAY_TPU_SLO`` inline, from a file or not at all alike; the recorder loop leaves a
final tick and ``start_loop`` is idempotent. A loop whose tick raises makes
``stop_loop()`` raise in the port; the JAX package swallows the error. Every test uses
fresh stores and sentinels; the flight recorders and registries are process-global,
so the tests that read them swap in fresh ones."""

from __future__ import annotations

import json
import threading
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from pathway_tpu.internals import metrics as jm
from pathway_tpu.internals import timeseries as jts
from pathway_tpu_torch.internals import metrics as tm
from pathway_tpu_torch.internals import timeseries as tts

PACKAGES = {"jax": (jts, jm), "torch": (tts, tm)}
NOW = 1_000_000.0


@pytest.fixture
def fresh(monkeypatch):
    """A fresh registry and flight recorder in each package's metrics module."""
    for _ts, m in PACKAGES.values():
        monkeypatch.setattr(m, "REGISTRY", m.Registry())
        monkeypatch.setattr(m, "FLIGHT", m.FlightRecorder())
    monkeypatch.delenv("PATHWAY_TPU_SLO", raising=False)
    monkeypatch.delenv("PATHWAY_TPU_TIMESERIES", raising=False)


def _both(fn):
    out = {name: fn(ts, m) for name, (ts, m) in PACKAGES.items()}
    assert out["jax"] == out["torch"]
    return out["torch"]


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.floats(0.0, 4.0), st.floats(-1e6, 1e6, allow_nan=False)),
                min_size=0, max_size=60),
       st.floats(0.0, 120.0))
def test_series_ring_points_agree(steps, since_back):
    """Rising timestamps (steps of 0-4 s) through small tiers: the tiers' contents,
    the merged window read and the last point agree."""

    def run(ts, _m):
        ring = ts.SeriesRing(raw_points=5, mid_points=4, coarse_points=3)
        t = 0.0
        for dt, v in steps:
            t += dt
            ring.append(t, v)
        return (list(ring.raw), list(ring.mid), list(ring.coarse), ring.points(t - since_back),
                ring.n_points(), ring.last())

    _both(run)


def test_store_observe_query_families_and_stats_agree():
    """A store capped at 4 series: observations past the cap are dropped and counted;
    queries filter on labels and the window; the index and the stats agree."""

    def run(ts, _m):
        store = ts.TimeSeriesStore(max_series=4)
        for i in range(30):
            t = NOW - 100 + 3.5 * i
            store.observe("depth", {"worker": "0", "node": "a"}, i, t)
            store.observe("depth", {"worker": "1", "node": "a"}, -i, t)
            store.observe("rate", {"worker": "0"}, 0.5 * i, t)
            store.observe("late", {"worker": "0"}, i, t)
            store.observe("dropped", {"worker": "0"}, i, t)  # the fifth series
        return (
            store.query("depth", 60.0, now=NOW),
            store.query("depth", 30.0, {"worker": 1}, now=NOW),
            store.query("rate", 1e9, now=NOW),
            store.query("missing", 60.0, now=NOW),
            store.query("depth", -5.0, now=NOW),
            store.families(),
            store.stats(),
        )

    got = _both(run)
    assert got[-1]["series"] == 4 and got[-1]["dropped_series"] == 30


def _snapshot(m) -> dict:
    r = m.Registry()
    r.counter("pathway_connector_entries_total", "entries", connector="docs").inc(1200)
    r.counter("pathway_connector_entries_total", "entries", connector="queries").inc(3)
    r.gauge("pathway_queue_depth", "depth", node="7").set(4.5)
    h = r.histogram("pathway_ingest_to_sink_latency_seconds", "latency",
                    buckets=(0.001, 0.01, 0.1, 1.0))
    for v in (0.0005, 0.004, 0.004, 0.05, 0.5, 3.0):
        h.observe(v)
    h.observe_n(0.02, 40)
    r.histogram("pathway_empty_seconds", "never observed", buckets=(1.0,))
    snap = r.snapshot()
    snap["__mesh_epoch"] = {"kind": "gauge", "series": [{"labels": {}, "value": 3}]}
    snap["not_a_family"] = 7
    return snap


def test_ingest_snapshot_agrees():
    """A registry snapshot with counters, a gauge, histograms (derived tracks) and
    reserved keys, ingested twice under two workers."""

    def run(ts, m):
        store = ts.TimeSeriesStore()
        snap = _snapshot(m)
        store.ingest_snapshot(snap, "0", t=NOW - 5)
        store.ingest_snapshot(snap, "0", t=NOW)
        store.ingest_snapshot(snap, "3", t=NOW)
        fams = [f["family"] for f in store.families()]
        return store.families(), store.stats(), [store.query(f, 60.0, now=NOW) for f in fams]

    got = _both(run)
    assert "__mesh_epoch" not in {f["family"] for f in got[0]}


def test_ingest_read_tier_agrees():
    def run(ts, m):
        r = m.Registry()
        r.counter("pathway_serving_cache_events_total", "c", kind="hit").inc(3)
        r.counter("pathway_serving_cache_events_total", "c", kind="miss").inc(1)
        r.histogram("pathway_serving_federation_fanout", "f", buckets=(1, 2, 4),
                    route="/q").observe_n(2, 5)
        r.gauge("pathway_serving_replica_lag_seconds", "l", replica="1").set(0.25)
        store = ts.TimeSeriesStore()
        store.ingest_read_tier(r.snapshot(), "r1", t=NOW)
        store.ingest_read_tier({}, "r2", t=NOW)  # nothing to derive
        fams = [f["family"] for f in store.families()]
        return store.families(), [store.query(f, 10.0, now=NOW) for f in fams]

    got = _both(run)
    assert [f["family"] for f in got[0]] == [
        "pathway_read_cache_hit_rate", "pathway_read_federation_fanout_mean",
        "pathway_read_replica_lag_seconds"]


@pytest.mark.parametrize("dead,width", [((), None), (("1",), None), ((), 2), (("r1", 0), 1)])
def test_prune_workers_agrees(dead, width):
    def run(ts, _m):
        store = ts.TimeSeriesStore()
        for w in ("0", "1", "2", "r1"):
            store.observe("depth", {"worker": w}, 1.0, NOW)
        store.prune_workers(dead, width=width)
        return store.query("depth", 10.0, now=NOW), store.stats()

    _both(run)


SPECS = [
    dict(name="p95", kind="latency", family="lat", bound=0.1, quantile="p95", budget=0.5),
    dict(name="q", kind="queue_depth", family="depth", bound=10.0, labels={"node": "a"},
         window_s=30.0),
    dict(name="stale", kind="staleness", family="age", bound=2.0),
    dict(name="floor", kind="throughput", family="rows", bound=5.0, budget=0.0),
]
BAD_SPECS = [
    dict(name="x", kind="nope", family="f", bound=1.0),
    dict(name="x", kind="latency", family="f", bound=0.0),
    dict(name="x", kind="latency", family="f", bound=1.0, quantile="p90"),
]


@pytest.mark.parametrize("spec", SPECS + BAD_SPECS, ids=lambda d: f"{d['kind']}-{d['bound']}")
def test_slo_spec_validation_and_round_trip_agree(spec):
    def run(ts, _m):
        try:
            s = ts.SloSpec.from_dict(spec)
        except ValueError as e:
            return ("raise", str(e))
        back = ts.SloSpec.from_dict(s.to_dict())
        return s.to_dict(), back.to_dict()

    _both(run)


def _fill_for(ts, store, kind: str, scale: float) -> None:
    for i in range(10):
        t = NOW - 9 + i
        if kind == "latency":
            store.observe("lat", {"worker": "0", "stat": "p95"}, scale * 0.02 * i, t)
            store.observe("lat", {"worker": "0", "stat": "p50"}, 9.0, t)
        elif kind == "queue_depth":
            store.observe("depth", {"worker": "0", "node": "a"}, scale * i, t)
            store.observe("depth", {"worker": "0", "node": "b"}, 99.0, t)
        elif kind == "staleness":
            store.observe("age", {"worker": "0"}, scale * 0.3 * i, t)
        else:
            store.observe("rows", {"worker": "0"}, 10.0 * i / scale, t)


@pytest.mark.parametrize("spec", SPECS, ids=lambda d: d["kind"])
def test_sentinel_reports_and_one_burn_event_agree(spec, fresh):
    """Below the bound, then past it twice (one ``slo_burn`` event, one breach), then
    below again (re-armed) and past it once more (a second event)."""

    def run(ts, m):
        sentinel = ts.SloSentinel([ts.SloSpec.from_dict(spec)])
        reports = [sentinel.evaluate(ts.TimeSeriesStore(), now=NOW)]  # no data: no burn
        for scale in (0.1, 10.0, 10.0, 0.1, 10.0):
            store = ts.TimeSeriesStore()
            _fill_for(ts, store, spec["kind"], scale)
            reports.append(sentinel.evaluate(store, now=NOW))
        burns = [{k: v for k, v in e.items() if k not in ("wall", "seq", "mono")}
                 for e in m.FLIGHT.snapshot() if e["kind"] == "slo_burn"]
        snap = m.REGISTRY.snapshot()
        return (reports, burns, snap["pathway_slo_breaches_total"]["series"],
                snap["pathway_slo_burn_ratio"]["series"])

    reports, burns, breaches, _ratio = _both(run)
    assert len(burns) == 2 and breaches[0]["value"] == 2
    assert [r[0]["burn"] is not None and r[0]["burn"] > 1.0 for r in reports[1:]] == [
        False, True, True, False, True]


@pytest.mark.parametrize("how", ["inline", "one", "file", "bad_json", "bad_spec", "missing_file"])
def test_sentinel_configure_from_the_environment_agrees(how, tmp_path, monkeypatch, fresh):
    path = tmp_path / "slo.json"
    path.write_text(json.dumps(SPECS))
    raw = {"inline": json.dumps(SPECS), "one": json.dumps(SPECS[0]), "file": str(path),
           "bad_json": "[{", "bad_spec": json.dumps([BAD_SPECS[0]]),
           "missing_file": str(tmp_path / "none.json")}[how]
    monkeypatch.setenv("PATHWAY_TPU_SLO", raw)

    def run(ts, m):
        sentinel = ts.SloSentinel()
        n = sentinel.configure()
        errors = [e["kind"] for e in m.FLIGHT.snapshot()]
        return n, [s.to_dict() for s in sentinel.specs()], errors, ts.loop_enabled()

    n, _specs, errors, enabled = _both(run)
    assert enabled
    assert (n == 0) == (errors == ["slo_config_error"])


@pytest.mark.parametrize("env", [{}, {"PATHWAY_TPU_TIMESERIES": "1"}, {"PATHWAY_TPU_TIMESERIES": "yes"},
                                 {"PATHWAY_TPU_TIMESERIES": "0"}, {"PATHWAY_TPU_SLO": "  "},
                                 {"PATHWAY_TPU_SLO": "[]"}])
def test_loop_enabled_agrees(env, monkeypatch, fresh):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _both(lambda ts, _m: ts.loop_enabled())


class _Monitor:
    """What the loop reads of a monitor: a scheduler with probe stats and the mesh
    snapshots (one live peer, one past the scheduler's width)."""

    def __init__(self, m):
        st = type("S", (), {"insertions": 5, "deletions": 1, "batches": 2, "time_spent": 0.5})
        node = type("N", (), {"index": 0, "name": "op"})
        self.scheduler = type("Sched", (), {"stats": {0: st}, "scope": type("Sc", (), {"nodes": [node]}),
                                            "n_processes": 2})
        peer = m.Registry()
        peer.counter("pathway_commits_seen", "c").inc(4)
        self.mesh_snapshots = {1: peer.snapshot(), 5: peer.snapshot()}


def test_loop_ticks_and_leaves_a_final_tick(fresh):
    """A loop with a long period records nothing until ``stop``, whose final tick lands
    the registry, the scheduler's operator series and the live peer's snapshot."""

    def run(ts, m):
        m.REGISTRY.counter("pathway_connector_entries_total", "e", connector="c").inc(7)
        store = ts.TimeSeriesStore()
        loop = ts.TelemetryLoop(store, ts.SloSentinel(), monitor=_Monitor(m), period_s=60.0)
        loop.start()
        running = loop.running
        before = store.stats()["series"]
        loop.stop()
        fams = {f["family"]: f["series"] for f in store.families()}
        workers = sorted({s["labels"]["worker"] for f in fams for s in store.query(f, 60)["series"]})
        return running, before, loop.running, fams, workers

    running, before, after, fams, workers = _both(run)
    assert running and before == 0 and not after and workers == ["0", "1"]
    assert fams["pathway_operator_rows"] == 1


def test_start_loop_is_idempotent(monkeypatch, fresh):
    monkeypatch.setenv("PATHWAY_TPU_SLO", json.dumps(SPECS[:1]))
    monkeypatch.setenv("PATHWAY_TPU_TS_INTERVAL", "0.05")

    def run(ts, m):
        monkeypatch.setattr(ts, "STORE", ts.TimeSeriesStore())
        monkeypatch.setattr(ts, "SENTINEL", ts.SloSentinel())
        mon = _Monitor(m)
        a = ts.start_loop(mon)
        b = ts.start_loop()
        same, rebound, period = a is b, b.monitor is mon, a.period_s
        names = [t.name for t in threading.enumerate()].count("pathway-timeseries")
        ts.stop_loop()
        ts.stop_loop()  # a second stop finds no loop
        left = [t.name for t in threading.enumerate()].count("pathway-timeseries")
        return same, rebound, period, names, left, len(ts.SENTINEL.specs()), ts._LOOP is None

    assert _both(run) == (True, True, 0.05, 1, 0, 1, True)


def test_a_raising_tick_raises_at_stop_in_the_port_only(monkeypatch, fresh):
    """A tick that raises (a card error read by a pull collector) stops the port's
    loop, and ``stop_loop()`` raises it; the JAX package's loop swallows it, ticks on,
    and its ``stop_loop()`` returns."""
    monkeypatch.setenv("PATHWAY_TPU_TS_INTERVAL", "0.05")
    calls = {"jax": 0, "torch": 0}

    def raiser(name):
        def full_snapshot(scheduler=None):
            calls[name] += 1
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return full_snapshot

    for name, (ts, m) in PACKAGES.items():
        monkeypatch.setattr(ts, "STORE", ts.TimeSeriesStore())
        monkeypatch.setattr(ts, "SENTINEL", ts.SloSentinel())
        monkeypatch.setattr(m, "full_snapshot", raiser(name))
        ts.start_loop(object())
    deadline = time.monotonic() + 10.0
    while (calls["jax"] < 3 or calls["torch"] < 1) and time.monotonic() < deadline:
        time.sleep(0.02)
    jts.stop_loop()
    assert calls["jax"] >= 3  # it ticked on past the error
    assert calls["torch"] == 1  # the first error stopped the port's loop
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tts.stop_loop()
    assert tts._LOOP is None and not any(t.name == "pathway-timeseries" and t.is_alive()
                                         for t in threading.enumerate())
