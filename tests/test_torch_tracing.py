"""The port's tracer against the JAX package's (``internals/tracing.py``): sampling
sequences, the adaptive interval's trajectory, span overflow and the epoch fence agree
for the same inputs; ``critical_path``, ``chrome_trace`` and ``summary`` are equal on
the same trace dicts, each package's Chrome trace passes the other's validator, and the
header helpers are equal. Then the engine: a streamed ``pw.run`` with every commit
sampled gives the same commit times and, per trace, the same multiset of ``(name,
cat)`` spans (``fused-sweep:*`` among them) in both packages, its buckets summing to
the commit's wall; the device pipeline's controller reads the tracer only when it is
on; the flight recorder's events carry the trace in flight."""

from __future__ import annotations

import collections
import json
import os
import re
import threading
import time

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import metrics as jm
from pathway_tpu.internals import tracing as jtr
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch.engine import device_ops as tdops
from pathway_tpu_torch.engine import device_pipeline as tdp
from pathway_tpu_torch.internals import metrics as tm
from pathway_tpu_torch.internals import tracing as ttr
from pathway_tpu_torch.internals.parse_graph import G as TG

BOTH = {"jax": jtr, "torch": ttr}
BUCKETS = ("host_compute_s", "exchange_s", "queue_wait_s", "device_s")


@pytest.fixture(autouse=True)
def _reset():
    yield
    for tr in BOTH.values():
        tr.TRACER.drop()
        tr.TRACER.configure(enabled=False, clear=True)
        tr.TRACER.epoch = 0
    TG.clear()
    JG.clear()


def _recorder(tr, sample: int = 1):
    r = tr.TraceRecorder()
    r.configure(enabled=True, sample=sample, clear=True)
    return r


@pytest.mark.parametrize("sample", [1, 3, 16])
def test_sampling_sequences_agree(sample):
    got = {}
    for name, tr in BOTH.items():
        r = _recorder(tr, sample)
        r._adapt = lambda *a: None  # pin the interval: this is not what is measured
        sampled, ids = [], []
        for t in range(1, 40):
            ctx = r.begin(t)
            if ctx is not None:
                sampled.append(t)
                ids.append(ctx.trace_id.split("-")[-1])
                r.end(t)
        got[name] = (sampled, ids, len(r.traces()))
    assert got["jax"] == got["torch"]
    disabled = ttr.TraceRecorder()
    disabled.configure(enabled=False, sample=1)
    assert disabled.begin(1) is None and disabled.traces() == []


def test_adaptive_interval_trajectory_agrees():
    steps = [(1.0, 0.001)] * 4 + [(0.0, 1.0)] * 6 + [(0.002, 0.01), (5.0, 0.001)] * 3
    steps += [(10.0, 0.0001)] * 20
    got = {}
    for name, tr in BOTH.items():
        r = _recorder(tr, 2)
        traj = []
        for overhead, wall in steps:
            r._adapt(overhead, wall)
            traj.append((r.interval, r._overhead_ema))
        got[name] = traj
    assert got["jax"] == got["torch"]
    assert got["torch"][-1][0] == 4096


def test_span_overflow_and_epoch_fence_agree():
    got = {}
    for name, tr in BOTH.items():
        r = _recorder(tr)
        ctx = r.begin(1)
        t0 = time.perf_counter()
        for _ in range(tr.MAX_SPANS + 10):
            ctx.span("s", "op", t0, t0, k=1)
        overflow = (len(ctx.spans), ctx.dropped, r.take_spans() == ctx.spans)
        r.drop()
        fence = []
        r.epoch = 2
        fence.append(r.adopt(("ctx", "tzz-1", 5, 123.0, 1)) is None)
        ctx = r.adopt(("ctx", "tzz-2", 5, 123.0, 3))
        fence += [ctx.remote, r.epoch, r.ctx_frame(), r.adopt(("ctx", "tzz-2", 5, 123.0, 3)) is ctx,
                  r.end(5), r.traces()]
        got[name] = (overflow, fence)
    assert got["jax"] == got["torch"]
    assert got["torch"][0][:2] == (ttr.MAX_SPANS, 10)


def _traces() -> list[dict]:
    """Trace dicts as ``TraceRecorder.end`` assembles them: two workers, a clamped
    commit, a serving and a request trace."""
    origin = 1_700_000_000.0

    def us(t):
        return int(t * 1e6)

    commit = {
        "trace_id": "t00-1-000001", "commit_time": 3, "epoch": 0, "worker": 0,
        "origin_wall": origin, "begin_wall": origin + 0.010, "end_wall": origin + 0.100,
        "spans": [
            {"name": "ingest-wait", "cat": "queue", "ts": us(origin), "dur": 10_000, "pid": 0,
             "args": {"sources": ["docs"]}},
            {"name": "device-backpressure", "cat": "wait", "ts": us(origin + 0.02), "dur": 20_000,
             "pid": 0},
            {"name": "fused-sweep:select", "cat": "op", "ts": us(origin + 0.045), "dur": 400,
             "pid": 0, "args": {"mode": "columnar", "rows": 512, "stages": 3}},
            {"name": "pwcf-encode", "cat": "exchange", "ts": us(origin + 0.05), "dur": 30_000,
             "pid": 0},
            {"name": "SubscribeNode", "cat": "sink", "ts": us(origin + 0.09), "dur": 5, "pid": 0},
        ],
        "workers": {1: [{"name": "apply:p0", "cat": "exchange", "ts": us(origin + 0.06),
                         "dur": 1000, "pid": 1}]},
        "sink_rows": 4, "dropped_spans": 0,
        "device_kernel_ns": {"device_ops.segment_reduce": 5_000_000}, "device_s": 0.005,
    }
    clamped = dict(commit, trace_id="t00-1-000002", commit_time=4, workers={},
                   begin_wall=origin + 0.2, end_wall=origin + 0.21, origin_wall=origin + 0.2,
                   spans=[{"name": "knn-update", "cat": "pipeline", "ts": us(origin + 0.2),
                           "dur": 4000, "pid": 0}],
                   device_kernel_ns={"segment": 1}, device_s=0.02)
    serving = {
        "kind": "serving", "trace_id": "q00-1-000001", "commit_time": 3, "epoch": 0,
        "worker": 0, "origin_wall": origin + 0.3, "begin_wall": origin + 0.3,
        "end_wall": origin + 0.31,
        "spans": [{"name": "query", "cat": "serving", "ts": us(origin + 0.3), "dur": 10_000,
                   "pid": 0}],
        "workers": {}, "sink_rows": 0, "dropped_spans": 0, "device_kernel_ns": {},
        "device_s": 0.0,
    }
    request = dict(serving, kind="request", trace_id="r00-1-000001", endpoint="/v1/retrieve",
                   status=200, request={"k": 3}, origin_wall=origin + 0.4,
                   begin_wall=origin + 0.4, end_wall=origin + 0.45,
                   spans=[{"name": "handle", "cat": "serving", "ts": us(origin + 0.4),
                           "dur": 50_000, "pid": 77}])
    return [commit, clamped, serving, request]


def test_critical_path_chrome_trace_and_summary_are_equal():
    got = {}
    for name, tr in BOTH.items():
        traces = _traces()
        for t in traces:
            t["critical_path"] = tr.critical_path(t)
        r = _recorder(tr)
        r._traces.extend(traces)
        got[name] = (traces, tr.chrome_trace(traces), r.summary())
    assert got["jax"] == got["torch"]
    traces, chrome, summary = got["torch"]
    assert traces[1]["critical_path"]["clamped"] and not traces[0]["critical_path"]["clamped"]
    for t in traces[:1]:
        cp = t["critical_path"]
        assert sum(cp[b] for b in BUCKETS) == pytest.approx(cp["wall_s"], abs=4e-6)
    # each package's Chrome trace passes the other's validator
    assert jtr.validate_chrome_trace(chrome) == ttr.validate_chrome_trace(got["jax"][1])
    assert summary["traces"] == 2 and summary["query_traces"] == 1


BAD_TRACES = [
    [{"ph": "X", "name": "a", "ts": 1, "pid": 0, "tid": 0}],
    [{"ph": "X", "name": "a", "ts": 10, "dur": 1, "pid": 0, "tid": 0},
     {"ph": "X", "name": "b", "ts": 5, "dur": 1, "pid": 0, "tid": 0}],
    [{"ph": "B", "name": "a", "ts": 1, "pid": 0, "tid": 0}],
    [{"ph": "E", "name": "a", "ts": 1, "pid": 0, "tid": 0}],
    [{"ph": "Q", "name": "a", "ts": 1, "pid": 0, "tid": 0}],
    [{"ph": "X", "name": "a", "ts": "1", "dur": 1, "pid": 0, "tid": 0}],
    [{"ph": "X", "name": "a", "ts": 1, "dur": -1, "pid": 0, "tid": 0}],
    [7],
    {"events": []},
    "trace",
    [{"ph": "B", "name": "a", "ts": 1, "pid": 0, "tid": 0},
     {"ph": "E", "name": "a", "ts": 2, "pid": 0, "tid": 0},
     {"ph": "M", "name": "m", "pid": 0, "tid": 0}],
]


@pytest.mark.parametrize("obj", BAD_TRACES)
def test_validators_agree_on_bad_and_edge_traces(obj):
    outs = []
    for tr in BOTH.values():
        try:
            outs.append(("ok", tr.validate_chrome_trace(obj)))
        except Exception as e:  # the type is what is compared
            outs.append(("raise", type(e)))
    assert outs[0] == outs[1]


HEADERS = [None, "", "a;b;1", "a;b;0", "a;;1", ";b;1", "a;b", "a;b;1;x", "t00-1;7f.3;1"]
SPAN_LISTS = [[], [{"name": "x", "ts": 1}], [{"name": "x" * 20_000, "ts": 1}],
              [{"name": "x", "ts": 1, "args": {"o": object()}}]]
SPAN_TEXTS = [None, "", "not json", "{}", '[1, {"name": 2, "ts": 1}, {"name": "ok", "ts": 2.5}]',
              '[{"name": "a"}]']


def test_header_helpers_are_equal():
    for tr_name in ("TRACE_HEADER", "SPANS_HEADER", "MAX_SPANS_HEADER_BYTES", "MAX_SPANS",
                    "OVERHEAD_TARGET"):
        assert getattr(ttr, tr_name) == getattr(jtr, tr_name)
    for h in HEADERS:
        assert ttr.parse_trace_header(h) == jtr.parse_trace_header(h)
    for spans in SPAN_LISTS:
        got_t, got_j = ttr.encode_spans(spans), jtr.encode_spans(spans)
        if spans and "args" in spans[0]:  # repr of an object differs by address
            assert (got_t is None) == (got_j is None)
        else:
            assert got_t == got_j
    for text in SPAN_TEXTS:
        assert ttr.decode_spans(text) == jtr.decode_spans(text)


def test_request_traces_agree():
    got = {}
    for name, tr in BOTH.items():
        r = tr.TraceRecorder()
        r.configure(enabled=True, sample=1, clear=True, request_enabled=True, request_sample=2)
        sampled = []
        for i in range(5):
            ctx = r.begin_request("/v1/retrieve")
            sampled.append(ctx is not None)
            if ctx is not None:
                sid = ctx.alloc_sid()
                header = ctx.header(sid)
                t0 = time.perf_counter()
                ctx.span("leg", "serving", t0, t0, sid=sid)
                ctx.add_remote_spans([{"name": "remote", "ts": 1, "pid": 9}], sid)
                assert r.current_request() is ctx
                trace = r.end_request(ctx, status=200, commit_time=4, k=3)
                sampled.append((header.split(";")[1:], trace["status"], trace["commit_time"],
                                trace["request"], [s["name"] for s in trace["spans"]],
                                [s.get("args") for s in trace["spans"]][1:]))
        remote = r.adopt_request("t1;p1;1", "/x")
        sampled.append((remote.remote, remote.parent_span, r.adopt_request("t1;p1;0") is None))
        r.drop_request()
        q = r.record_query("query", 1.0, 1.5, commit_time=2, rows=3)
        sampled.append((q["kind"], q["spans"][0]["dur"], q["spans"][0]["args"]))
        got[name] = sampled
    assert got["jax"] == got["torch"]


def test_flight_events_carry_the_trace_in_flight(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_FLIGHT_DIR", str(tmp_path))
    got = {}
    for name, (tr, m) in {"jax": (jtr, jm), "torch": (ttr, tm)}.items():
        tr.TRACER.configure(enabled=True, sample=1, clear=True)
        rec = m.FlightRecorder(maxlen=4)
        rec.record("before")
        ctx = tr.TRACER.begin(1)
        rec.record("during")
        with open(rec.dump("boom")) as fh:
            dumped = json.load(fh)["trace_id"]
        tr.TRACER.end(1)
        rec.record("after")
        events = rec.snapshot()
        got[name] = ([("trace_id" in e) for e in events], dumped == ctx.trace_id,
                     events[1].get("trace_id") == ctx.trace_id)
        tr.TRACER.configure(enabled=False, clear=True)
    assert got["jax"] == got["torch"] == ([False, True, False], True, True)


def test_export_writes_a_valid_chrome_file(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_TRACE_DIR", str(tmp_path))
    r = _recorder(ttr)
    assert r.export() is None
    ctx = r.begin(3, origin_mono=time.monotonic() - 0.01)
    t0 = time.perf_counter()
    ctx.span("filter<t>", "op", t0, time.perf_counter())
    r.end(3)
    path = r.export()
    assert os.path.basename(path).startswith("pathway_trace_p") and path.endswith("_001.json")
    with open(path) as fh:
        obj = json.load(fh)
    jtr.validate_chrome_trace(obj)
    assert obj["otherData"]["traces"][0]["critical_path"]["wall_s"] > 0


def test_kernel_ns_snapshot_merges_the_device_operators():
    tdops.reset_counters()
    try:
        with tdops._LOCK:
            tdops._NS["segment_reduce"] = 7
        snap = ttr._kernel_ns_snapshot()
        assert snap["device_ops.segment_reduce"] == 7
        r = _recorder(ttr)
        r.begin(1)
        with tdops._LOCK:
            tdops._NS["segment_reduce"] = 2_000_007
        trace = r.end(1)
        assert trace["device_kernel_ns"] == {"device_ops.segment_reduce": 2_000_000}
        assert trace["device_s"] == pytest.approx(0.002)
    finally:
        tdops.reset_counters()


def test_the_controller_reads_the_tracer_only_when_it_is_on():
    tdp.PIPELINE.configure()
    ctl = tdp.PIPELINE.controller
    ttr.TRACER.configure(enabled=False, clear=True)
    assert ctl._last_critical_path() is None
    ttr.TRACER.configure(enabled=True, sample=1, clear=True)
    assert ctl._last_critical_path() is None  # nothing traced yet
    ttr.TRACER.begin(1)
    trace = ttr.TRACER.end(1)
    assert ctl._last_critical_path() == trace["critical_path"]
    # a device-bound verdict keeps the batch; a host-bound one shrinks it
    ttr.TRACER._traces[-1]["critical_path"] = dict(trace["critical_path"], host_compute_s=0.0,
                                                   device_s=1.0)
    ctl.batch_size = 4 * ctl.min_batch
    ctl.observe(staged_depth=0, blocked=False, occupancy=0.0)
    assert ctl.batch_size == 4 * ctl.min_batch
    ttr.TRACER.configure(enabled=False, clear=True)
    ctl.observe(staged_depth=0, blocked=False, occupancy=0.0)
    assert ctl.batch_size == 2 * ctl.min_batch
    tdp.PIPELINE.configure()


# -- a streamed pw.run, traced in both packages ----------------------------------------


def _program(pw, join: bool):
    """Four batches of 300 rows, each one commit: a batch lands within the 200 ms
    autocommit window, and the next waits until the raw sink has seen it."""
    seen, landed = [0], threading.Event()

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for c in range(4):
                landed.clear()
                for i in range(300):
                    self.next(k=i % 7, v=c * 1000 + i)
                assert landed.wait(timeout=30)

    def on_raw(key, row, time, is_addition):
        seen[0] += 1
        if seen[0] % 300 == 0:
            landed.set()

    t = pw.io.python.read(Feed(), schema=pw.schema_from_types(k=int, v=int),
                          autocommit_duration_ms=200)
    pw.io.subscribe(t, on_change=on_raw)
    t = t.select(k=pw.this.k, v=pw.this.v * 2).filter(pw.this.v > 10)
    t = t.select(k=pw.this.k, w=pw.this.v + 1)
    if join:
        names = pw.debug.table_from_rows(pw.schema_from_types(k=int, name=str),
                                         [(i, f"n{i}") for i in range(7)])
        t = t.join(names, t.k == names.k).select(k=t.k, w=t.w, name=names.name)
    g = t.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.w))
    pw.io.subscribe(g, on_change=lambda **kw: None)


def _traced_run(pkg: str, join: bool) -> list[dict]:
    """The program under ``pw.run`` with every commit traced (on the host kernels:
    ``PATHWAY_TPU_DEVICE_OPS=0``, set by the callers) -> the traces."""
    pw, tr = {"jax": (jpw, jtr), "torch": (tpw, ttr)}[pkg]
    tr.TRACER.configure(enabled=True, sample=1, clear=True)
    tr.TRACER._adapt = lambda *a: None  # every commit sampled
    try:
        _program(pw, join)
        pw.run()
        return tr.TRACER.traces()
    finally:
        del tr.TRACER._adapt
        tr.TRACER.configure(enabled=False, clear=True)


def _spans(trace: dict) -> collections.Counter:
    """The trace's ``(name, cat)`` multiset; a lowered table's name carries the
    process-wide table counter (``groupby_reduce<table_12>``), which the other tests
    of the process advance differently in the two packages, so it is left out."""
    return collections.Counter((re.sub(r"<table_\d+>", "<table>", s["name"]), s["cat"])
                               for s in trace["spans"])


def _by_commit(traces: list[dict]) -> dict:
    return {t["commit_time"]: t for t in traces}


def test_streamed_run_records_the_same_spans_per_commit(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")
    runs = {pkg: _by_commit(_traced_run(pkg, join=False)) for pkg in ("jax", "torch")}
    assert list(runs["jax"]) == list(runs["torch"])
    common = [t for t in runs["torch"] if runs["torch"][t]["spans"]]
    assert len(common) == 4
    for t in common:
        assert _spans(runs["jax"][t]) == _spans(runs["torch"][t]), t
        cp = runs["torch"][t]["critical_path"]
        assert sum(cp[b] for b in BUCKETS) == pytest.approx(cp["wall_s"], abs=4e-6)
    names = {name for t in common for name, _cat in _spans(runs["torch"][t])}
    assert any(n.startswith("fused-sweep:") for n in names)
    assert {"ingest-wait", "SubscribeNode"} <= names
    assert all(runs["torch"][t]["sink_rows"] > 0 for t in common)


def test_streamed_join_run_records_the_same_categories(monkeypatch):
    """The port lowers a join's key projections on their own (a deliberate difference),
    which fuses one more chain: a join program's traces are compared by the kinds of
    span and the counts of the categories other than ``op``."""
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")
    runs = {pkg: _by_commit(_traced_run(pkg, join=True)) for pkg in ("jax", "torch")}
    assert list(runs["jax"]) == list(runs["torch"])
    common = [t for t in runs["torch"] if runs["torch"][t]["spans"]]
    assert len(common) == 4
    for t in common:
        kinds = [set(_spans(runs[p][t])) for p in runs]
        assert kinds[0] == kinds[1], t
        cats = [collections.Counter(s["cat"] for s in runs[p][t]["spans"] if s["cat"] != "op")
                for p in runs]
        assert cats[0] == cats[1], t
        for p in runs:
            ttr.validate_chrome_trace(ttr.chrome_trace([runs[p][t]]))
