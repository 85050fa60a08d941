"""The global capture graph ``G`` and ``pw.run``.

Counterpart of ``pathway_tpu/internals/parse_graph.py``: sinks (``pw.io.subscribe``)
register here; ``pw.run`` lowers everything they reach onto one engine scope and runs
the streaming loop until every connector is done. One worker in one process: the
sharded and distributed runners (ROADMAP queue 1 item 14) and persistence (item 12)
are not ported yet, and a configuration that asks for them raises.
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
    pump the connectors through commits until all of them are done. With
    ``PATHWAY_PROCESS_METRICS`` set, the scheduler keeps per-operator probe stats
    (``GraphRunner.scheduler.stats``). The device pipeline's completion thread is
    reaped and the graph cleared afterwards, whether the run ends or raises."""
    from pathway_tpu_torch.engine import device_pipeline
    from pathway_tpu_torch.internals.config import get_pathway_config
    from pathway_tpu_torch.internals.runner import GraphRunner

    unported = sorted(
        k for k, v in kwargs.items()
        if v and k not in ("threads", "processes", "persistence_config")
    )
    if unported:
        raise NotImplementedError(
            f"pw.run options {unported} are not ported yet (monitoring and tracing: "
            "ROADMAP queue 1 item 12; the static analyzer: item 8)"
        )
    config = get_pathway_config()
    threads = kwargs.get("threads") or config.threads
    processes = kwargs.get("processes") or config.processes
    if threads > 1 or processes > 1:
        raise NotImplementedError(
            "more than one worker needs the sharded or distributed runner, which is "
            "not ported yet (ROADMAP queue 1 item 14)"
        )
    if kwargs.get("persistence_config") is not None or (
        config.persistent_storage or config.replay_storage
    ):
        raise NotImplementedError(
            "persistence is not ported yet (ROADMAP queue 1 item 12)"
        )
    try:
        runner = GraphRunner()
        if os.environ.get("PATHWAY_PROCESS_METRICS"):
            runner.probe_stats = True
        for sink in G.sinks:
            node = runner.build(sink.table)
            driver = sink.attach(runner.scope, node)
            if driver is not None:
                runner.drivers.append(driver)
        runner.run()
    finally:
        # a raising run must not leave the completion thread behind
        device_pipeline.stop_worker()
        G.clear()


def run_all(**kwargs: Any) -> None:
    """``run``, by the name of the reference's entry point that runs every sink."""
    run(**kwargs)
