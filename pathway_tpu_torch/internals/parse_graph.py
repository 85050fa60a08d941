"""The global capture graph ``G`` and ``pw.run``.

Counterpart of ``pathway_tpu/internals/parse_graph.py``: sinks (``pw.io.subscribe``)
register here; ``pw.run`` lowers everything they reach onto one engine scope and runs
the streaming loop until every connector is done, under ``persistence_config`` (or the
one the environment implies, ``PATHWAY_PERSISTENT_STORAGE`` and
``PATHWAY_PERSISTENCE_MODE``) where one is given. ``threads=N`` (or
``PATHWAY_THREADS``) runs N workers in one process through the sharded runner
(``internals/runner.py::ShardedGraphRunner``); ``processes=N`` (or
``PATHWAY_PROCESSES``, with ``PATHWAY_PROCESS_ID`` and ``PATHWAY_FIRST_PORT``, as
``python -m pathway_tpu_torch.cli spawn`` sets them) runs this process as one member of
a mesh of N through the distributed runner (``DistributedGraphRunner``): process 0
coordinates and holds the sinks, and the others force ``MonitoringLevel.NONE`` (each
keeps its own Prometheus endpoint, 20000 + ``PATHWAY_PROCESS_ID`` by default).
``debug`` and ``strict`` (the static analyzer, ROADMAP queue 1 item 8) are not ported
yet, and a configuration that asks for them raises.

A run watches itself as the JAX package's does: ``monitoring_level`` renders the live
dashboard, ``with_http_server`` serves ``/metrics``, ``/timeseries``, ``/requests`` and
``/profile`` on ``monitoring_server_port`` (default 20000 + ``PATHWAY_PROCESS_ID``),
the timeseries loop records the registry's history and evaluates the SLOs whenever the
endpoint runs or ``PATHWAY_TPU_TIMESERIES`` / ``PATHWAY_TPU_SLO`` ask for it, the
telemetry sampler and OpenTelemetry spans run under ``set_monitoring_config`` or
``PATHWAY_PROCESS_METRICS``, and the sampling profiler under ``PATHWAY_TPU_PROFILE=1``
(its document exported at the end). The run records ``run_start``, ``run_end`` or
``run_error`` in the flight recorder, whose ring is dumped to ``PATHWAY_TPU_FLIGHT_DIR``
when the run raises. An error that one of these background threads kept raises when
the run stops it; when the run itself raised, it is recorded beside the run's
exception as a ``background_error`` flight event.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable

from pathway_tpu_torch.engine.graph import Node, Scope

if TYPE_CHECKING:
    from pathway_tpu_torch.internals.table import Table


@dataclass
class SinkSpec:
    table: "Table"
    attach: Callable[[Scope, Node], Any]  # returns an optional driver


class ParseGraph:
    def __init__(self) -> None:
        self.sinks: list[SinkSpec] = []

    def add_sink(self, table: "Table", attach: Callable[[Scope, Node], Any]) -> None:
        self.sinks.append(SinkSpec(table, attach))

    def clear(self) -> None:
        self.sinks = []


G = ParseGraph()


def run(
    *,
    monitoring_level: Any = None,
    with_http_server: bool = False,
    monitoring_server_port: int | None = None,
    persistence_config: Any = None,
    **kwargs: Any,
) -> None:
    """Execute the captured graph: build every sink's table, attach the sinks, and
    pump the connectors through commits until all of them are done. ``persistence_config``
    (``pw.persistence.Config``) journals, snapshots or caches as its mode says; without
    one, the environment's ``replay_config`` applies.

    ``monitoring_level``: ``pw.MonitoringLevel`` (``AUTO``: ``IN_OUT`` on a terminal,
    else ``NONE``); ``IN_OUT`` and ``ALL`` render a live ``rich`` dashboard.
    ``with_http_server`` serves the Prometheus exposition and the history, request and
    profile routes on ``monitoring_server_port`` for the lifetime of the run. With
    telemetry on (``set_monitoring_config``, ``PATHWAY_PROCESS_METRICS``), the
    scheduler keeps per-operator probe stats (``GraphRunner.scheduler.stats``).

    The background threads are stopped, the device pipeline's completion thread is
    reaped and the graph cleared afterwards, whether the run ends or raises."""
    from pathway_tpu_torch.analysis import runtime as _analysis_runtime
    from pathway_tpu_torch.engine import device_pipeline
    from pathway_tpu_torch.internals import profiling as _profiling
    from pathway_tpu_torch.internals import timeseries as _timeseries
    from pathway_tpu_torch.internals.config import get_pathway_config
    from pathway_tpu_torch.internals.metrics import FLIGHT
    from pathway_tpu_torch.internals.monitoring import (
        MonitoringHttpServer,
        MonitoringLevel,
        StatsMonitor,
    )
    from pathway_tpu_torch.internals.runner import (
        DistributedGraphRunner,
        GraphRunner,
        ShardedGraphRunner,
    )
    from pathway_tpu_torch.internals.telemetry import (
        run_span,
        stop_beside_run,
        telemetry_enabled,
    )

    unported = sorted(k for k, v in kwargs.items() if v and k not in ("threads", "processes"))
    if unported:
        raise NotImplementedError(
            f"pw.run options {unported} are not ported yet (the static analyzer behind "
            "debug and strict: ROADMAP queue 1 item 8)"
        )
    config = get_pathway_config()
    threads = kwargs.get("threads") or config.threads
    processes = kwargs.get("processes") or config.processes
    if persistence_config is None:
        persistence_config = config.replay_config
    runner: Any
    if processes > 1:
        # the same program in every process, a key-sharded exchange over TCP
        runner = DistributedGraphRunner(
            threads,
            processes,
            int(config.process_id),
            first_port=config.first_port,
            persistence_config=persistence_config,
        )
        if int(config.process_id) != 0:
            # the live dashboard is process 0's; the Prometheus endpoint stays per
            # process
            monitoring_level = MonitoringLevel.NONE
    elif threads > 1:
        # workers in one process: a replica of the graph each, key-sharded exchange
        runner = ShardedGraphRunner(threads, persistence_config=persistence_config)
    else:
        runner = GraphRunner(persistence_config=persistence_config)
    analysis_only = _analysis_runtime.enabled()
    if analysis_only:
        monitoring_level, with_http_server = None, False
    # (what, stop) of each background part this run started, stopped in this order
    stops: list[tuple[str, Callable[[], Any]]] = []
    run_error: BaseException | None = None
    try:
        monitor = None
        if monitoring_level is not None or with_http_server:
            level = monitoring_level
            if level is None or level == MonitoringLevel.AUTO:
                level = MonitoringLevel.IN_OUT if sys.stderr.isatty() else MonitoringLevel.NONE
            if level != MonitoringLevel.NONE or with_http_server:
                monitor = StatsMonitor(
                    level if level != MonitoringLevel.NONE else MonitoringLevel.IN_OUT
                )
                runner.monitor = monitor
                if level != MonitoringLevel.NONE:
                    monitor.start_live()
                stops.append(("dashboard", monitor.stop))
                if with_http_server:
                    http_server = MonitoringHttpServer(monitor, port=monitoring_server_port)
                    stops.append(("http", http_server.stop))
        if not analysis_only:
            # strictly opt-in (PATHWAY_TPU_PROFILE=1): unset, a boolean test, no thread
            if _profiling.PROFILER.maybe_start():
                def stop_profiler() -> None:
                    _profiling.PROFILER.stop()
                    _profiling.PROFILER.export()

                stops.insert(0, ("profiler", stop_profiler))
            # the history ring: fed whenever something can read it (the endpoint's
            # /timeseries) or the user asked for it (PATHWAY_TPU_TIMESERIES=1 / an SLO)
            if with_http_server or _timeseries.loop_enabled():
                if monitor is None:
                    # SLO evaluation without a dashboard: a quiet monitor gives the loop
                    # its scheduler view
                    monitor = StatsMonitor(MonitoringLevel.IN_OUT)
                    runner.monitor = monitor
                _timeseries.start_loop(monitor)
                stops.insert(0, ("pathway-timeseries", _timeseries.stop_loop))
        if telemetry_enabled():
            # per-operator stats feed the metrics sampler and the operator spans
            runner.probe_stats = True
        FLIGHT.record(
            "run_start", threads=threads, processes=processes,
            process_id=int(config.process_id),
        )
        try:
            with run_span(lambda: runner.scheduler):
                runner.attach_sinks()
                runner.run()
            FLIGHT.record("run_end")
        except BaseException as exc:
            # the last commits and errors of the run land on disk before the raise
            FLIGHT.record("run_error", error=repr(exc))
            FLIGHT.dump(f"pw.run raised: {exc!r}")
            raise
    except BaseException as exc:
        run_error = exc
        raise
    finally:
        try:
            # every part is stopped even when one raises; the first error raises after
            first: BaseException | None = None
            for what, stop in stops:
                try:
                    stop_beside_run(stop, what, run_error)
                except Exception as exc:  # noqa: BLE001 — raised once all are stopped
                    first = first or exc
            if first is not None:
                raise first
        finally:
            # a raising run or stop must not leave the completion thread or the sinks
            # behind for the next run
            device_pipeline.stop_worker()
            G.clear()


def run_all(**kwargs: Any) -> None:
    """``run``, by the name of the reference's entry point that runs every sink."""
    run(**kwargs)
