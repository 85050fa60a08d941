"""The port's telemetry against the JAX package's (``internals/telemetry.py``):
``set_monitoring_config`` and ``telemetry_enabled`` under each env var; the process
sample's keys (psutil, and ``resource`` without it) and operator counters; a sampler
that leaves a final sample and no thread behind; and, through a fake ``opentelemetry``
module tree, the same ``pathway.run`` and ``operator.<idx>:<name>`` spans with the
same attributes. A sample that raises makes the port's sampler raise at ``stop`` (and
``run_span`` raise after a run that ended, or record a ``background_error`` flight
event beside a run's own exception); the JAX package swallows it."""

from __future__ import annotations

import contextlib
import re
import sys
import threading
import time
import types

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import metrics as jm
from pathway_tpu.internals import telemetry as jtel
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch.internals import metrics as tm
from pathway_tpu_torch.internals import telemetry as ttel
from pathway_tpu_torch.internals.parse_graph import G as TG

PACKAGES = {"jax": (jpw, jtel, jm), "torch": (tpw, ttel, tm)}
ENV = ("PATHWAY_TELEMETRY_SERVER", "PATHWAY_PROCESS_METRICS", "PATHWAY_TELEMETRY_INTERVAL_S")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    for _pw, tel, _m in PACKAGES.values():
        monkeypatch.setattr(tel, "_config", {"endpoint": None, "license_key": None})
        monkeypatch.setattr(tel, "_provider_cache", {})
    yield
    TG.clear()
    JG.clear()


def _both(fn):
    out = {name: fn(pw, tel, m) for name, (pw, tel, m) in PACKAGES.items()}
    assert out["jax"] == out["torch"]
    return out["torch"]


@pytest.mark.parametrize("how", ["none", "config", "server_env", "metrics_env", "empty_env"])
def test_set_monitoring_config_and_telemetry_enabled_agree(how, monkeypatch):
    if how == "server_env":
        monkeypatch.setenv("PATHWAY_TELEMETRY_SERVER", "http://127.0.0.1:4317")
    elif how == "metrics_env":
        monkeypatch.setenv("PATHWAY_PROCESS_METRICS", "1")
    elif how == "empty_env":
        monkeypatch.setenv("PATHWAY_PROCESS_METRICS", "")

    def run(pw, tel, _m):
        before = tel.telemetry_enabled()
        if how == "config":
            pw.set_monitoring_config(server_endpoint="http://127.0.0.1:4317", license_key="k")
        config = dict(tel._config)
        enabled = tel.telemetry_enabled()
        pw.set_monitoring_config()
        return before, config, enabled, tel.telemetry_enabled()

    assert _both(run)[2] == (how in ("config", "server_env", "metrics_env"))


def _scheduler():
    st = [types.SimpleNamespace(insertions=i * 10, deletions=i, batches=i + 1, time_spent=0.25 * i)
          for i in range(3)]
    nodes = [types.SimpleNamespace(index=i, name=n) for i, n in enumerate(["input", "select", "sink"])]
    return types.SimpleNamespace(stats=dict(enumerate(st)), scope=types.SimpleNamespace(nodes=nodes))


@pytest.mark.parametrize("psutil", [True, False])
def test_process_samples_have_the_same_keys(psutil, monkeypatch):
    if not psutil:
        monkeypatch.setitem(sys.modules, "psutil", None)  # the import raises ImportError

    def run(_pw, tel, _m):
        sample = tel._sample_process(_scheduler())
        return sorted(sample), sample["operators"], sorted(tel._sample_process(None))

    keys, ops, bare = _both(run)
    assert ("cpu_percent" in keys) == psutil and ("cpu_seconds" in keys) != psutil
    assert "operators" not in bare and ops["1:select"] == dict(
        insertions=10, deletions=1, batches=2, time_spent=0.25)


def test_sampler_leaves_a_final_sample_and_no_thread():
    def run(_pw, tel, _m):
        tel._latest_metrics = {}
        sampler = tel._MetricsSampler(_scheduler, 60.0)  # no periodic sample before stop
        sampler.start()
        sampler.stop()
        sample = tel.latest_process_metrics()
        alive = [t for t in threading.enumerate() if t.name == "pw-telemetry"]
        return sorted(sample), sample["memory_rss_bytes"] > 0, alive

    _keys, rss, alive = _both(run)
    assert rss and alive == []


def _raising_sample(tel, monkeypatch) -> list:
    calls = []

    def sample(scheduler):
        calls.append(scheduler)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(tel, "_sample_process", sample)
    return calls


def test_a_raising_sample_raises_at_stop_in_the_port_only(monkeypatch):
    """The JAX package's sampler swallows every sample's error and samples on; the
    port's keeps the first, stops sampling and raises it at ``stop``."""
    got = {}
    for name, (_pw, tel, _m) in PACKAGES.items():
        calls = _raising_sample(tel, monkeypatch)
        sampler = tel._MetricsSampler(lambda: None, 0.01)
        sampler.start()
        deadline = time.monotonic() + 10.0
        while len(calls) < 3 and time.monotonic() < deadline and sampler.is_alive():
            time.sleep(0.01)
        if name == "jax":
            sampler.stop()
        else:
            with pytest.raises(RuntimeError, match="illegal memory access"):
                sampler.stop()
        got[name] = len(calls)
        assert not any(t.name == "pw-telemetry" and t.is_alive() for t in threading.enumerate())
    assert got["jax"] >= 3 and got["torch"] == 1


@pytest.mark.parametrize("run_raises", [False, True])
def test_run_span_raises_or_records_the_sampler_error(run_raises, monkeypatch):
    monkeypatch.setenv("PATHWAY_PROCESS_METRICS", "1")
    monkeypatch.setenv("PATHWAY_TELEMETRY_INTERVAL_S", "60")
    monkeypatch.setattr(tm, "FLIGHT", tm.FlightRecorder())
    _raising_sample(ttel, monkeypatch)
    with pytest.raises(RuntimeError, match="the run's own" if run_raises else "illegal memory"):
        with ttel.run_span():
            if run_raises:
                raise RuntimeError("the run's own error")
    events = [e for e in tm.FLIGHT.snapshot() if e["kind"] == "background_error"]
    assert [(e["thread"], "illegal memory" in e["error"]) for e in events] == (
        [("pw-telemetry", True)] if run_raises else [])


class _Span:
    def __init__(self, name: str, log: list) -> None:
        self.name, self.attributes = name, {}
        log.append(self)

    def set_attribute(self, key, value) -> None:
        self.attributes[key] = value


def _fake_opentelemetry(monkeypatch) -> list:
    """``opentelemetry``'s trace SDK and OTLP exporter as plain modules: the tracer
    logs every span it starts. The metrics exporter is missing (its import raises), so
    the sampler samples without exporting, as in both packages."""
    log: list = []

    class Tracer:
        @contextlib.contextmanager
        def start_as_current_span(self, name):
            yield _Span(name, log)

    class TracerProvider:
        def __init__(self, resource=None):
            self.resource = resource

        def add_span_processor(self, processor):
            pass

        def get_tracer(self, name):
            return Tracer()

    names = {
        "opentelemetry": {},
        "opentelemetry.exporter": {},
        "opentelemetry.exporter.otlp": {},
        "opentelemetry.exporter.otlp.proto": {},
        "opentelemetry.exporter.otlp.proto.grpc": {},
        "opentelemetry.exporter.otlp.proto.grpc.trace_exporter": {
            "OTLPSpanExporter": lambda endpoint=None: ("exporter", endpoint)},
        "opentelemetry.sdk": {},
        "opentelemetry.sdk.resources": {
            "Resource": types.SimpleNamespace(create=lambda attrs: dict(attrs))},
        "opentelemetry.sdk.trace": {"TracerProvider": TracerProvider},
        "opentelemetry.sdk.trace.export": {"BatchSpanProcessor": lambda exporter: exporter},
    }
    for name, attrs in names.items():
        mod = types.ModuleType(name)
        mod.__dict__.update(attrs)
        monkeypatch.setitem(sys.modules, name, mod)
    return log


def test_run_span_emits_the_same_spans(monkeypatch):
    log = _fake_opentelemetry(monkeypatch)
    monkeypatch.setenv("PATHWAY_TELEMETRY_INTERVAL_S", "60")

    def run(pw, tel, _m):
        log.clear()
        pw.set_monitoring_config(server_endpoint="http://127.0.0.1:4317")
        with tel.run_span(_scheduler):
            pass
        return [(s.name, s.attributes) for s in log], sorted(tel.latest_process_metrics())

    spans, _sample = _both(run)
    assert [n for n, _a in spans] == ["pathway.run", "operator.0:input", "operator.1:select",
                                      "operator.2:sink"]
    assert spans[2][1] == {"operator.insertions": 10, "operator.deletions": 1,
                           "operator.batches": 2, "operator.time_spent_s": 0.25}


def test_a_static_run_emits_run_and_operator_spans_in_both_packages(monkeypatch):
    """A ``pw.run`` with an endpoint: the run span and one span per operator, with the
    same names and row counters in both packages, the sampler gone after the run."""
    log = _fake_opentelemetry(monkeypatch)
    monkeypatch.setenv("PATHWAY_TELEMETRY_INTERVAL_S", "60")
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")

    def run(pw, _tel, _m):
        log.clear()
        pw.set_monitoring_config(server_endpoint="http://127.0.0.1:4317")
        t = pw.debug.table_from_markdown("k | v\n1 | 10\n2 | 20\n1 | 30")
        pw.io.subscribe(t.select(w=pw.this.v + 1), on_change=lambda **kw: None)
        pw.run()
        # a lowered table's name carries the process's table counter: normalised
        return [(re.sub(r"<table_\d+>", "<table_N>", s.name),
                 {k: v for k, v in s.attributes.items() if k != "operator.time_spent_s"})
                for s in log]

    spans = _both(run)
    assert spans[0] == ("pathway.run", {}) and len(spans) > 2
    assert not any(t.name == "pw-telemetry" and t.is_alive() for t in threading.enumerate())
