"""The global capture graph ``G`` and ``pw.run``.

Counterpart of ``pathway_tpu/internals/parse_graph.py``: sinks (``pw.io.subscribe``)
register here; ``pw.run`` lowers everything they reach onto one engine scope and runs
the streaming loop until every connector is done, under ``persistence_config`` (or the
one the environment implies, ``PATHWAY_PERSISTENT_STORAGE`` and
``PATHWAY_PERSISTENCE_MODE``) where one is given. One worker in one process: the
sharded and distributed runners (ROADMAP queue 1 item 14) are not ported yet, nor are
monitoring and the HTTP server (item 12), and a configuration that asks for them
raises. A run starts the sampling profiler when ``PATHWAY_TPU_PROFILE=1`` and exports
its document at the end, and records ``run_start``, ``run_end`` or ``run_error`` in the
flight recorder, whose ring is dumped to ``PATHWAY_TPU_FLIGHT_DIR`` when the run raises.
"""

from __future__ import annotations

import os
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


def run(**kwargs: Any) -> None:
    """Execute the captured graph: build every sink's table, attach the sinks, and
    pump the connectors through commits until all of them are done. ``persistence_config``
    (``pw.persistence.Config``) journals, snapshots or caches as its mode says; without
    one, the environment's ``replay_config`` applies. With ``PATHWAY_PROCESS_METRICS``
    set, the scheduler keeps per-operator probe stats (``GraphRunner.scheduler.stats``).
    The device pipeline's completion thread is reaped and the graph cleared afterwards,
    whether the run ends or raises."""
    from pathway_tpu_torch.analysis import runtime as _analysis_runtime
    from pathway_tpu_torch.engine import device_pipeline
    from pathway_tpu_torch.internals import profiling as _profiling
    from pathway_tpu_torch.internals.config import get_pathway_config
    from pathway_tpu_torch.internals.metrics import FLIGHT
    from pathway_tpu_torch.internals.runner import GraphRunner

    unported = sorted(
        k for k, v in kwargs.items()
        if v and k not in ("threads", "processes", "persistence_config")
    )
    if unported:
        raise NotImplementedError(
            f"pw.run options {unported} are not ported yet (monitoring and the HTTP "
            "server: ROADMAP queue 1 item 12; the static analyzer: item 8)"
        )
    config = get_pathway_config()
    threads = kwargs.get("threads") or config.threads
    processes = kwargs.get("processes") or config.processes
    if threads > 1 or processes > 1:
        raise NotImplementedError(
            "more than one worker needs the sharded or distributed runner, which is "
            "not ported yet (ROADMAP queue 1 item 14)"
        )
    persistence_config = kwargs.get("persistence_config")
    if persistence_config is None:
        persistence_config = config.replay_config
    profiler_started = False
    try:
        runner = GraphRunner(persistence_config=persistence_config)
        if os.environ.get("PATHWAY_PROCESS_METRICS"):
            runner.probe_stats = True
        if not _analysis_runtime.enabled():
            # strictly opt-in (PATHWAY_TPU_PROFILE=1): unset, a boolean test, no thread
            profiler_started = _profiling.PROFILER.maybe_start()
        FLIGHT.record(
            "run_start", threads=threads, processes=processes,
            process_id=int(os.environ.get("PATHWAY_PROCESS_ID", "0")),
        )
        try:
            for sink in G.sinks:
                node = runner.build(sink.table)
                driver = sink.attach(runner.scope, node)
                if driver is not None:
                    runner.drivers.append(driver)
            runner.run()
            FLIGHT.record("run_end")
        except BaseException as exc:
            # the last commits and errors of the run land on disk before the raise
            FLIGHT.record("run_error", error=repr(exc))
            FLIGHT.dump(f"pw.run raised: {exc!r}")
            raise
    finally:
        try:
            if profiler_started:
                _profiling.PROFILER.stop()
                _profiling.PROFILER.export()
        finally:
            # a raising run or export must not leave the completion thread or the
            # sinks behind for the next run
            device_pipeline.stop_worker()
            G.clear()


def run_all(**kwargs: Any) -> None:
    """``run``, by the name of the reference's entry point that runs every sink."""
    run(**kwargs)
