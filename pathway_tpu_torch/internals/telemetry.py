"""OpenTelemetry integration and periodic process metrics.

Counterpart of ``pathway_tpu/internals/telemetry.py`` (reference:
src/engine/telemetry.rs:195-407, graph_runner/telemetry.py), with the same names and env
vars. Off by default: ``pw.set_monitoring_config(server_endpoint=...)`` (or
``PATHWAY_TELEMETRY_SERVER``) turns it on, and every ``pw.run`` emits

- a root ``pathway.run`` span with run metadata,
- one child span per operator at run end carrying that operator's
  insertions/deletions/batches and time inside ``process()``,
- periodic process metrics — RSS, CPU utilization, thread count — plus per-operator
  row counters, sampled by a background thread (``pw-telemetry``) every
  ``PATHWAY_TELEMETRY_INTERVAL_S`` seconds (default 5).

``PATHWAY_PROCESS_METRICS`` turns the sampler on without an endpoint. Metric samples
are always collected into an in-process snapshot (:func:`latest_process_metrics`)
while a run is live; the OTLP export is the only part gated on the endpoint and on the
optional ``opentelemetry`` packages. Without ``psutil`` a sample reads ``resource``.

The sampler keeps the first exception a sample raises, stops sampling, and
``_MetricsSampler.stop`` raises it on the caller's thread; :func:`run_span` lets it
raise when the run ended, and records it as a ``background_error`` flight event beside
the run's own exception when the run raised (:func:`stop_beside_run`). The JAX package
swallows both (ROADMAP: deliberate differences).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time as _time
import uuid
from typing import Any, Iterator

_config: dict[str, Any] = {"endpoint": None, "license_key": None}
_RUN_ID = str(uuid.uuid4())
_provider_cache: dict[str, Any] = {}  # endpoint -> tracer (OTEL's global
# provider is first-write-wins, so build ours once per endpoint)
_latest_metrics: dict[str, Any] = {}


def set_monitoring_config(
    *, server_endpoint: str | None = None, license_key: str | None = None
) -> None:
    """Reference internals/config.py:144 set_monitoring_config: the OTLP endpoint
    (and license key) every later ``pw.run`` exports to."""
    _config["endpoint"] = server_endpoint
    _config["license_key"] = license_key


def _tracer() -> Any:
    endpoint = _config["endpoint"] or os.environ.get(
        "PATHWAY_TELEMETRY_SERVER"
    )
    if not endpoint:
        return None
    if endpoint in _provider_cache:
        return _provider_cache[endpoint]
    try:
        from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import (
            OTLPSpanExporter,
        )
        from opentelemetry.sdk.resources import Resource
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.export import BatchSpanProcessor
    except ImportError:
        return None
    provider = TracerProvider(
        resource=Resource.create(
            {
                "service.name": "pathway-tpu",
                "run.id": _RUN_ID,
            }
        )
    )
    provider.add_span_processor(
        BatchSpanProcessor(OTLPSpanExporter(endpoint=endpoint))
    )
    # use the provider directly — the OTEL global setter is
    # first-write-wins and would leak one provider per run
    tracer = provider.get_tracer("pathway_tpu")
    _provider_cache[endpoint] = tracer
    return tracer


def _operator_stats(scheduler: Any) -> dict[str, dict[str, Any]]:
    """idx-labelled per-operator counters, snapshotting the stats dict
    (the run thread inserts entries lazily mid-run)."""
    ops: dict[str, dict[str, Any]] = {}
    if scheduler is None:
        return ops
    for idx, st in list(getattr(scheduler, "stats", {}).items()):
        try:
            node = scheduler.scope.nodes[idx]
            name = f"{idx}:{getattr(node, 'name', type(node).__name__)}"
        except Exception:  # noqa: BLE001
            name = str(idx)
        ops[name] = dict(
            insertions=getattr(st, "insertions", 0),
            deletions=getattr(st, "deletions", 0),
            batches=getattr(st, "batches", 0),
            time_spent=getattr(st, "time_spent", 0.0),
        )
    return ops


def _sample_process(scheduler: Any) -> dict[str, Any]:
    """One metrics sample: process gauges + per-operator counters."""
    sample: dict[str, Any] = {"ts": _time.time()}
    try:
        import psutil
    except ImportError:  # psutil is optional
        psutil = None
    if psutil is not None:
        proc = psutil.Process()
        sample["memory_rss_bytes"] = proc.memory_info().rss
        sample["cpu_percent"] = proc.cpu_percent(interval=None)
        sample["num_threads"] = proc.num_threads()
    else:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        sample["memory_rss_bytes"] = ru.ru_maxrss * 1024
        sample["cpu_seconds"] = ru.ru_utime + ru.ru_stime
    if scheduler is not None:
        sample["operators"] = _operator_stats(scheduler)
    return sample


def latest_process_metrics() -> dict[str, Any]:
    """Most recent sample of the live (or last) run (published
    atomically by the sampler; a final sample lands at run end)."""
    return dict(_latest_metrics)


def telemetry_enabled() -> bool:
    return bool(
        _config["endpoint"]
        or os.environ.get("PATHWAY_TELEMETRY_SERVER")
        or os.environ.get("PATHWAY_PROCESS_METRICS")
    )


class _MetricsSampler(threading.Thread):
    """Periodic process-metrics pump (reference telemetry.rs:195-407).

    Samples regardless of OTLP; exports each sample as gauge values when
    an endpoint + the OTEL metrics packages are available."""

    def __init__(self, scheduler_ref: Any, interval_s: float) -> None:
        super().__init__(name="pw-telemetry", daemon=True)
        self._scheduler_ref = scheduler_ref
        self._interval = interval_s
        #: named apart from ``Thread._stop``, which ``join`` calls on Python 3.12 (the
        #: JAX package's ``_stop`` event shadows it, so its ``join`` raises a
        #: ``TypeError`` that its ``suppress`` hides)
        self._halt = threading.Event()
        #: the first exception a sample of the thread raised; ``stop`` raises it
        self.error: BaseException | None = None
        self._exporter = self._make_exporter()

    def _make_exporter(self) -> Any:
        endpoint = _config["endpoint"] or os.environ.get(
            "PATHWAY_TELEMETRY_SERVER"
        )
        if not endpoint:
            return None
        try:
            from opentelemetry.exporter.otlp.proto.grpc.metric_exporter import (
                OTLPMetricExporter,
            )
            from opentelemetry.sdk.metrics import MeterProvider
            from opentelemetry.sdk.metrics.export import (
                PeriodicExportingMetricReader,
            )
            from opentelemetry.sdk.resources import Resource
        except ImportError:
            return None
        reader = PeriodicExportingMetricReader(
            OTLPMetricExporter(endpoint=endpoint),
            export_interval_millis=int(self._interval * 1000),
        )
        provider = MeterProvider(
            metric_readers=[reader],
            resource=Resource.create(
                {"service.name": "pathway-tpu", "run.id": _RUN_ID}
            ),
        )
        meter = provider.get_meter("pathway_tpu")
        gauges = {
            "memory_rss_bytes": meter.create_gauge("process.memory.rss"),
            "cpu_percent": meter.create_gauge("process.cpu.percent"),
            "num_threads": meter.create_gauge("process.threads"),
        }
        return {"provider": provider, "gauges": gauges}

    def _sample_once(self) -> None:
        global _latest_metrics
        sample = _sample_process(self._scheduler_ref())
        _latest_metrics = sample  # atomic publish by rebinding
        if self._exporter is not None:
            for key, gauge in self._exporter["gauges"].items():
                if key in sample:
                    gauge.set(sample[key])

    def run(self) -> None:
        while not self._halt.wait(self._interval):
            try:
                self._sample_once()
            except Exception as exc:  # noqa: BLE001 — kept, raised by stop()
                self.error = exc
                return

    def stop(self) -> None:
        """Join the thread, take a final sample (runs shorter than one interval still
        publish their end-of-run process + operator counters) and shut the exporter
        down; then raise the first exception a sample of the thread met, else the
        final sample's."""
        self._halt.set()
        # join before the final sample: a raising run must not leave the sampler
        # thread alive mid-_sample_once
        if self.is_alive():
            self.join(timeout=5.0)
        try:
            if self.error is None:
                self._sample_once()
        finally:
            if self._exporter is not None:
                self._exporter["provider"].shutdown()
        error, self.error = self.error, None
        if error is not None:
            raise error


def _emit_operator_spans(tracer: Any, scheduler: Any) -> None:
    """One span per operator with its run-total counters — the
    per-operator trace surface (reference telemetry.rs spans)."""
    if tracer is None or scheduler is None:
        return
    for name, st in _operator_stats(scheduler).items():
        with tracer.start_as_current_span(f"operator.{name}") as span:
            span.set_attribute("operator.insertions", st["insertions"])
            span.set_attribute("operator.deletions", st["deletions"])
            span.set_attribute("operator.batches", st["batches"])
            span.set_attribute("operator.time_spent_s", st["time_spent"])


@contextlib.contextmanager
def run_span(scheduler_getter: Any = None) -> Iterator[None]:
    """Root run span + periodic metrics sampler around ``pw.run``.

    ``scheduler_getter`` returns the live scheduler (or None before the
    run starts) so the sampler and operator spans can read its stats."""
    tracer = _tracer()
    getter = scheduler_getter or (lambda: None)
    # sampling follows the telemetry switch, not tracer availability — an
    # endpoint without the OTEL trace packages still collects samples
    enabled = telemetry_enabled()
    sampler: _MetricsSampler | None = None
    if enabled:
        interval = float(
            os.environ.get("PATHWAY_TELEMETRY_INTERVAL_S", "5")
        )
        sampler = _MetricsSampler(getter, interval)
        sampler.start()
    run_error: BaseException | None = None
    try:
        if tracer is None:
            yield
        else:
            with tracer.start_as_current_span("pathway.run"):
                yield
                _emit_operator_spans(tracer, getter())
    except BaseException as exc:
        run_error = exc
        raise
    finally:
        if sampler is not None:
            stop_beside_run(sampler.stop, "pw-telemetry", run_error)


def stop_beside_run(stop: Any, what: str, run_error: BaseException | None) -> None:
    """Call ``stop`` (a background thread's stop, which raises the first error the
    thread met). When the run ended, its error raises; when the run raised, it is
    recorded as a ``background_error`` flight event instead, and the run's own
    exception stands."""
    if run_error is None:
        stop()
        return
    try:
        stop()
    except Exception as exc:  # noqa: BLE001 — recorded beside the run's own error
        from pathway_tpu_torch.internals.metrics import FLIGHT

        FLIGHT.record("background_error", thread=what, error=repr(exc))
