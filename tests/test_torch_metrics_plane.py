"""The port's metrics plane against the JAX package's (``internals/metrics.py``): the
same registry operations give the same snapshots and byte-equal Prometheus text; the
parser and the validator agree on the same texts and raise the same exception type on
malformed ones; the flight recorder's and the request log's rings agree. Then the
engine's call sites: the connectors' counters and ``OSError`` retries, the
ingest-to-sink latency (its count equals the sinks' rows) and the flight dump of a
raising ``pw.run``, in both packages."""

from __future__ import annotations

import json
import os
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import connectors as jconn
from pathway_tpu.engine import graph as jgraph
from pathway_tpu.internals import metrics as jm
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch.engine import connectors as tconn
from pathway_tpu_torch.engine import graph as tgraph
from pathway_tpu_torch.internals import metrics as tm
from pathway_tpu_torch.internals.parse_graph import G as TG

PACKAGES = {"jax": (jpw, jm, jconn, jgraph), "torch": (tpw, tm, tconn, tgraph)}


@pytest.fixture(autouse=True)
def _clear():
    yield
    TG.clear()
    JG.clear()


def _fill(m, label: str) -> dict:
    """One registry, the same operations in either package -> its snapshot."""
    r = m.Registry()
    r.counter("reqs_total", "requests served", route="/a", who=label).inc(3)
    r.counter("reqs_total", "requests served", route="/b").inc(0.5)
    r.gauge("depth", "queue depth").set(-2.25)
    r.gauge("big", "a big value").set(3.0e17)
    h = r.histogram("lat_seconds", "latency\nwith a newline", buckets=(0.001, 0.1, 1.0, 2.5),
                    worker_of=label)
    for v in (0.0005, 0.05, 0.05, 0.7, 3.0):
        h.observe(v)
    h.observe_n(0.2, 7)
    h.observe_n(0.2, 0)
    h.exemplar(0.05, "t00-abc-000001")
    h.exemplar(9.0, f'id "{label}"')
    r.histogram("empty_seconds", "never observed", buckets=(1.0,))
    return r.snapshot()


LABELS = ["plain", 'we"ird\\name\nwith newline', "", "a,b=c}{", "üñí"]


@pytest.mark.parametrize("label", LABELS)
def test_snapshots_and_exposition_are_byte_equal(label):
    snaps = {name: _fill(m, label) for name, (_pw, m, _c, _g) in PACKAGES.items()}
    assert snaps["jax"] == snaps["torch"]
    by_worker = {"": snaps["jax"], "0": snaps["jax"], "3": {"depth": snaps["jax"]["depth"]}}
    texts = {name: m.render_snapshots(by_worker) for name, (_pw, m, _c, _g) in PACKAGES.items()}
    assert texts["jax"] == texts["torch"]
    assert texts["torch"].count("# TYPE reqs_total counter") == 1
    parsed = {name: _outcome(m.validate_exposition, texts[name])
              for name, (_pw, m, _c, _g) in PACKAGES.items()}
    assert parsed["jax"] == parsed["torch"]
    # each package's text through the other's parser
    assert _outcome(jm.parse_prometheus_text, texts["torch"]) == _outcome(
        tm.parse_prometheus_text, texts["jax"])
    if "}" in label:
        # both parsers end an exemplar's labels at its first "}", so a trace id
        # holding one does not parse back, in either package
        assert parsed["torch"] == ("raise", ValueError)
    else:
        assert parsed["torch"][1]["reqs_total"]["samples"][0][1]["who"] == label


def _outcome(fn, text):
    try:
        return ("ok", fn(text))
    except Exception as e:  # the type is what is compared
        return ("raise", type(e))


@settings(max_examples=60, deadline=None)
@given(st.text(max_size=12), st.text(alphabet='\\"\n{},= ab', max_size=12))
def test_label_escaping_round_trips_alike(text, hostile):
    assert tm.escape_label_value(text) == jm.escape_label_value(text)
    snap = {"x_total": {"kind": "counter", "help": "h", "buckets": None,
                        "series": [{"labels": {"k": text, "j": hostile}, "value": 1.0}]}}
    out_t, out_j = tm.render_snapshots({"w": snap}), jm.render_snapshots({"w": snap})
    assert out_t == out_j
    got = _outcome(tm.validate_exposition, out_t)
    assert got == _outcome(jm.validate_exposition, out_j)
    # both parsers split the text with str.splitlines, which also breaks at the
    # separators that escaping leaves alone (\r, \x1c-\x1e, \x85, ...)
    if not any(len(f"a{c}b".splitlines()) > 1 for c in text + hostile if c != "\n"):
        assert got[1]["x_total"]["samples"][0][1] == {"k": text, "j": hostile, "worker": "w"}


MALFORMED = [
    "orphan_metric 1\n",
    '# HELP h x\n# TYPE h histogram\nh_bucket{le="1"} 1\nh_sum 1\n',
    "# COMMENT nope\n",
    "# TYPE x frobnicator\n",
    "# HELP x y\n# TYPE x counter\nx{a=\"1\" 2\n",
    "# HELP x y\n# TYPE x counter\nx notanumber\n",
    "# HELP x y\n# TYPE x counter\nx{a=1} 2\n",
    "# HELP x y\n# TYPE x counter\nx{a=\"\\\n",
    "# HELP x y\n# TYPE x counter\nx 1 # trace_id 2\n",
    "# HELP x y\n# TYPE x counter\nx 1 # {trace_id=\"a\"}\n",
    "# HELP x y\n# TYPE x counter\nx_other 1\n",
    "# HELP h x\n# TYPE h histogram\nh_bucket{le=\"1\"} 2\nh_bucket{le=\"+Inf\"} 1\nh_sum 1\nh_count 1\n",
    "# HELP h x\n# TYPE h histogram\nh_bucket{le=\"+Inf\"} 3\nh_sum 1\nh_count 1\n",
    "# HELP x y\n# TYPE x gauge\n",
    "# TYPE x gauge\nx 1\n",
    "x\n",
]


@pytest.mark.parametrize("text", MALFORMED)
def test_malformed_texts_raise_alike(text):
    outcomes = [_outcome(fn, text) for m in (jm, tm)
                for fn in (m.parse_prometheus_text, m.validate_exposition)]
    assert outcomes[:2] == outcomes[2:]
    assert outcomes[1][0] == "raise"


def test_merge_and_operator_samples_agree():
    class Stats:
        def __init__(self, ins, dels, t, b):
            self.insertions, self.deletions, self.time_spent, self.batches = ins, dels, t, b

    class N:
        def __init__(self, index, name):
            self.index, self.name = index, name

    stats = {3: Stats(10, 4, 0.5, 2), 1: Stats(0, 0, 0.0, 0), 7: Stats(5, 9, 1.25, 3)}
    nodes = [N(1, "input"), N(3, 'groupby<"g">'), object()]
    got = {}
    for name, (_pw, m, _c, _g) in PACKAGES.items():
        samples = m.operator_samples(stats, nodes)
        snap = m.merge_samples({}, samples)
        m.merge_samples(snap, [("x_total", "counter", "", {"a": "b"}, 2)])
        got[name] = (samples, snap, m.render_snapshots({"": snap}))
    assert got["jax"] == got["torch"]


def test_histogram_quantiles_and_exemplars_agree():
    hists = {name: m.Histogram((0.5, 1.0, 4.0)) for name, (_pw, m, _c, _g) in PACKAGES.items()}
    for h in hists.values():
        for v, n in ((0.1, 3), (0.7, 5), (2.0, 1), (9.0, 2), (0.7, -1)):
            h.observe_n(v, n)
        h.observe(4.0)
        h.exemplar(2.0, "t-1")
        h.exemplar(9.0, 12)
    jh, th = hists["jax"], hists["torch"]
    assert (th.counts, th.sum, th.count, th.exemplars) == (jh.counts, jh.sum, jh.count, jh.exemplars)
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert th.quantile(q) == jh.quantile(q)
    for m in (jm, tm):
        with pytest.raises(ValueError):
            m.Histogram((2.0, 1.0))


def test_registry_kinds_reset_and_collectors():
    for m in (jm, tm):
        r = m.Registry()
        r.counter("x_total")
        with pytest.raises(ValueError):
            r.gauge("x_total")
        r.register_collector(lambda: [("pulled", "gauge", "from a collector", {"k": "v"}, 4)])
        snap = r.snapshot()
        assert snap["pulled"]["series"] == [{"labels": {"k": "v"}, "value": 4.0}]
        r.reset()
        assert list(r.snapshot()) == ["pulled"]
    # the port's snapshot raises with a raising collector (the JAX package skips it)
    r = tm.Registry()
    r.register_collector(lambda: (_ for _ in ()).throw(RuntimeError("card error")))
    with pytest.raises(RuntimeError, match="card error"):
        r.snapshot()


def test_full_snapshot_carries_the_operator_series():
    outs = {}
    for name, (_pw, m, _c, g) in PACKAGES.items():
        scope = g.Scope()
        sess = scope.input_session(1)
        g.SubscribeNode(scope, sess)
        sched = g.Scheduler(scope, probe=True)
        for i in range(5):
            sess.insert(i, (i,))
        sched.commit()
        snap = m.full_snapshot(sched)
        rows = snap["pathway_operator_rows"]["series"]
        outs[name] = sorted((s["labels"]["operator"], s["labels"]["index"], s["value"]) for s in rows)
        m.validate_exposition(m.render_snapshots({"0": snap}))
    assert outs["jax"] == outs["torch"]


@pytest.mark.parametrize("ring", ["flight", "requests"])
def test_rings_bound_evict_and_dump_alike(ring, tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_FLIGHT_DIR", str(tmp_path))
    got = {}
    for name, (_pw, m, _c, _g) in PACKAGES.items():
        m.set_trace_id_provider(None)
        if ring == "flight":
            monkeypatch.setenv("PATHWAY_TPU_FLIGHT_EVENTS", "5")
            rec = m.FlightRecorder()
            for i in range(8):
                rec.record("commit", time=i)
        else:
            monkeypatch.setenv("PATHWAY_TPU_REQUEST_TRACE_RING", "5")
            rec = m.RequestLog()
            for i in range(8):
                rec.record(endpoint="/q", status=200, i=i)
        events = [{k: v for k, v in e.items() if k != "wall"} for e in rec.snapshot()]
        dump = None
        if ring == "flight":
            path = rec.dump("boom")
            with open(path) as fh:
                payload = json.load(fh)
            dump = (sorted(payload), payload["reason"], len(payload["events"]),
                    os.path.basename(path).split("_pid")[0])
        rec.clear()
        got[name] = (events, dump, rec.snapshot())
    # the tracer's provider, registered again for the rest of the suite
    from pathway_tpu.internals import tracing as jtr
    from pathway_tpu_torch.internals import tracing as ttr

    jm.set_trace_id_provider(jtr._active_trace_id)
    tm.set_trace_id_provider(ttr._active_trace_id)
    assert got["jax"] == got["torch"]
    assert [e["seq"] for e in got["torch"][0]] == [4, 5, 6, 7, 8]


def test_mirrored_counter_dict_agrees():
    vals = {}
    for name, (_pw, m, _c, _g) in PACKAGES.items():
        d = m.MirroredCounterDict("pathway_test_mirror_total", "kind", {"a": 0},
                                  extra_labels={"a": {"path": "p"}})
        d["a"] += 3
        d["b"] = 2
        vals[name] = (dict(d), m.REGISTRY.counter("pathway_test_mirror_total", kind="a", path="p").value,
                      m.REGISTRY.counter("pathway_test_mirror_total", kind="b").value)
    assert vals["jax"] == vals["torch"] == ({"a": 3, "b": 2}, 3.0, 2.0)


# -- the connectors ---------------------------------------------------------------------


class _Flaky:
    """A reader whose first ``fails`` polls raise ``exc``, then one batch, then done."""

    replaces_sources = False

    def __init__(self, fails: int, exc: type = OSError) -> None:
        self.fails, self.exc, self.calls = fails, exc, 0

    def poll(self):
        self.calls += 1
        if self.calls <= self.fails:
            raise self.exc("transient")
        if self.calls == self.fails + 1:
            return [(b"a\nb\nc", "src", {}), (b"d", "src", {})], False
        return [], True


def _driver(pkg: str, reader, name: str):
    _pw, _m, conn, g = PACKAGES[pkg]
    scope = g.Scope()
    sess = scope.input_session(1)
    return conn.InputDriver(sess, reader, conn.IdentityParser(split_lines=True), source_name=name)


@pytest.mark.parametrize("case", ["flaky", "not_oserror", "spent", "disabled"])
def test_connector_counters_and_retries_agree(case, monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)
    monkeypatch.setenv("PATHWAY_TPU_CONNECTOR_RETRIES", "0" if case == "disabled" else "3")
    fails, exc = {"flaky": (2, OSError), "not_oserror": (1, ValueError), "spent": (4, OSError),
                  "disabled": (1, OSError)}[case]
    got = {}
    for pkg in PACKAGES:
        m = PACKAGES[pkg][1]
        name = f"flaky-{case}-{pkg}"
        retries = m.REGISTRY.counter("pathway_connector_retries_total")
        r0 = retries.value
        reader = _Flaky(fails, exc)
        drv = _driver(pkg, reader, name)
        try:
            first = drv.poll()
            stamped = drv.first_pending_wall is not None
            second = drv.poll()
            outcome = (first, second, stamped)
        except Exception as e:  # the type is what is compared
            outcome = ("raise", type(e))
        got[pkg] = (
            outcome,
            reader.calls,
            retries.value - r0,
            drv.entries_total,
            drv.batches_total,
            m.REGISTRY.counter("pathway_connector_entries_total", connector=name).value,
            m.REGISTRY.counter("pathway_connector_batches_total", connector=name).value,
        )
    assert got["jax"] == got["torch"]
    want = {"flaky": (("data", "done", True), 4, 2.0, 2, 1, 2.0, 1.0),
            "not_oserror": (("raise", ValueError), 1, 0.0, 0, 0, 0.0, 0.0),
            "spent": (("raise", OSError), 4, 3.0, 0, 0, 0.0, 0.0),
            "disabled": (("raise", OSError), 1, 0.0, 0, 0, 0.0, 0.0)}[case]
    assert got["torch"] == want


# -- pw.run: the ingest-to-sink latency and the flight dump ----------------------------


def _streamed(pw, n_commits: int = 3, raise_at: int | None = None):
    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for c in range(n_commits):
                for i in range(40):
                    self.next(k=i % 5, v=c * 100 + i)
                self.commit()
                time.sleep(0.05)  # one commit each

    t = pw.io.python.read(Feed(), schema=pw.schema_from_types(k=int, v=int),
                          autocommit_duration_ms=None)
    g = t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v))
    seen = []

    def on_change(key, row, time, is_addition):
        if raise_at is not None and row["s"] >= raise_at:
            raise RuntimeError("sink exploded")
        seen.append((row["k"], row["s"], is_addition))

    pw.io.subscribe(t, on_change=lambda **kw: None)
    pw.io.subscribe(g, on_change=on_change)
    return seen


def test_ingest_latency_count_equals_the_sinks_rows(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")  # no card here: the host kernels
    got = {}
    for pkg, (pw, m, _c, _g) in PACKAGES.items():
        hist = m.REGISTRY.histogram("pathway_ingest_to_sink_latency_seconds",
                                    "end-to-end ingest->sink latency stamped per delta batch")
        rows = m.REGISTRY.counter("pathway_output_rows_total")
        c0, r0 = hist.count, rows.value
        seen = _streamed(pw)
        pw.run()
        final = {}
        for k, total, is_addition in seen:
            if is_addition:
                final[k] = total
        # the commits' split may differ by the connector thread's pace, the rows' sum
        # may not
        got[pkg] = (hist.count - c0 == rows.value - r0 > 120, final)
    assert got["jax"] == got["torch"]
    assert got["torch"][0]


def test_raising_run_dumps_the_same_event_kinds(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")
    kinds = {}
    for pkg, (pw, m, _c, _g) in PACKAGES.items():
        out = tmp_path / pkg
        monkeypatch.setenv("PATHWAY_TPU_FLIGHT_DIR", str(out))
        m.FLIGHT.clear()
        _streamed(pw, n_commits=3, raise_at=2000)
        with pytest.raises(RuntimeError, match="sink exploded"):
            pw.run()
        (dump,) = [f for f in os.listdir(out) if f.startswith("pathway_flight_p")]
        with open(out / dump) as fh:
            payload = json.load(fh)
        assert "sink exploded" in payload["reason"]
        kinds[pkg] = [e["kind"] for e in payload["events"]]
    # the number of commits may differ by the connector thread's pace
    assert set(kinds["jax"]) == set(kinds["torch"]) == {"run_start", "commit", "retractions",
                                                         "run_error"}
    for got in kinds.values():
        assert got[0] == "run_start" and got[-1] == "run_error"
