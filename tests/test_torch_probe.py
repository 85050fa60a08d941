"""The scheduler's probe (``Scheduler(probe=True)``, ``OperatorStats``) and the metric
primitives it reports into, in the port against the JAX package.

The same program (an input session, an expression that divides by zero on some rows,
error removal, a batch UDF making lazy device rows, a restrict and two subscribe sinks)
runs over the same seeded commits in both packages; per node, matched in node order,
``insertions``, ``deletions``, ``batches`` and ``last_time`` must be equal (exact
counts), and every node that ran has ``time_spent > 0``.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import pathway_tpu_torch as tpw
from pathway_tpu_torch.engine import device as tdev
from pathway_tpu_torch.engine import device_pipeline as dp
from pathway_tpu_torch.engine import expression as tex
from pathway_tpu_torch.engine.graph import OperatorStats, Scheduler, Scope
from pathway_tpu_torch.engine.value import ref_scalar
from pathway_tpu_torch.internals import metrics as tmetrics
from pathway_tpu_torch.internals.runner import GraphRunner


@pytest.fixture(autouse=True)
def _fresh_pipeline():
    tdev._LIVE_HANDLES.clear()
    dp.PIPELINE.configure()
    yield
    tdev._LIVE_HANDLES.clear()
    dp.PIPELINE.configure()
    dp.PIPELINE.stop_worker()


def _commits(seed: int) -> list[list[tuple]]:
    """Seeded commits of ("+" or "-", key, (x, y)) events: inserts, zero divisors, a
    retraction with its replacement, and an empty commit."""
    rng = np.random.default_rng(seed)
    live: dict[int, tuple] = {}
    commits = []
    next_key = 0
    for c in range(5):
        events = []
        if c == 3:
            commits.append(events)
            continue
        for _ in range(int(rng.integers(5, 40))):
            row = (next_key, float(rng.integers(0, 4)))  # y == 0 divides by zero
            events.append(("+", next_key, row))
            live[next_key] = row
            next_key += 1
        for key in rng.choice(sorted(live), size=min(4, len(live)), replace=False):
            key = int(key)
            old = live.pop(key)
            events.append(("-", key, old))
            if rng.random() < 0.5:
                new = (key, old[1] + 1.0)
                events.append(("+", key, new))
                live[key] = new
        commits.append(events)
    return commits


def _probed_run(engine, scheduler_of, lazy_rows, to_batch, commits):
    """The program through one package's engine -> (node type names, per-node stats
    snapshots by node position, the scheduler)."""
    ex = engine.expression
    sc = engine.graph.Scope()
    sess = sc.input_session(2)
    e1 = sc.expression_table(
        sess, [ex.ColumnRef(0), ex.Binary("/", ex.Const(12.0), ex.ColumnRef(1))]
    )
    clean = sc.remove_errors_from_table(e1)

    def rows_fn(rows):
        mat = np.asarray([[float(a), float(b) * 2.0] for a, b in rows], np.float32)
        return [(True, c) for c in lazy_rows(to_batch(mat), len(rows))]

    ba = sc.batch_apply_table(clean, rows_fn, [0, 1])
    restricted = sc.restrict_table(e1, ba)
    sink_rows: list = []
    sc.subscribe_table(ba, on_change=lambda k, row, t, d: sink_rows.append(d))
    sc.subscribe_table(restricted, on_change=lambda k, row, t, d: sink_rows.append(d))
    sched = scheduler_of(sc)
    for events in commits:
        for kind, key, row in events:
            if kind == "+":
                sess.insert(engine.value.ref_scalar(key), row)
            else:
                sess.remove(engine.value.ref_scalar(key), row)
        sched.commit()
    sched.finish()
    assert sink_rows
    names = [type(n).__name__ for n in sc.nodes]
    by_pos = {
        pos: sched.stats[n.index].snapshot()
        for pos, n in enumerate(sc.nodes)
        if n.index in sched.stats
    }
    return names, by_pos, sched


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_counts_match_jax(seed):
    import jax.numpy as jnp

    import pathway_tpu.engine as jengine
    import pathway_tpu.engine.expression  # noqa: F401
    import pathway_tpu.engine.graph  # noqa: F401
    import pathway_tpu.engine.value  # noqa: F401
    import pathway_tpu_torch.engine as tengine
    import pathway_tpu_torch.engine.expression  # noqa: F401
    import pathway_tpu_torch.engine.value  # noqa: F401
    from pathway_tpu.engine import device as jdev
    from pathway_tpu.engine import device_pipeline as jdp
    from pathway_tpu.engine.graph import Scheduler as JScheduler

    commits = _commits(seed)
    jdp.PIPELINE.configure()
    try:
        jnames, theirs, _ = _probed_run(
            jengine, lambda sc: JScheduler(sc, probe=True, optimize=False),
            jdev.lazy_rows, jnp.asarray, commits,
        )
    finally:
        jdp.PIPELINE.configure()
        jdp.PIPELINE.stop_worker()
    names, ours, sched = _probed_run(
        tengine, lambda sc: Scheduler(sc, probe=True), tdev.lazy_rows,
        torch.from_numpy, commits,
    )
    assert len(names) == len(jnames)
    assert sorted(ours) == sorted(theirs)  # the same nodes ran
    for pos, st in ours.items():
        their = theirs[pos]
        assert {k: st[k] for k in ("insertions", "deletions", "batches", "last_time")} == {
            k: their[k] for k in ("insertions", "deletions", "batches", "last_time")
        }, (pos, names[pos], jnames[pos])
        assert st["time_spent"] > 0.0
    total = {k: sum(st[k] for st in ours.values()) for k in ("insertions", "deletions")}
    assert total["insertions"] > 0 and total["deletions"] > 0


def test_probe_off_collects_nothing():
    sc = Scope()
    sess = sc.input_session(1)
    sc.expression_table(sess, [tex.ColumnRef(0)])
    sched = Scheduler(sc)
    sess.insert(ref_scalar(1), (1,))
    sched.commit()
    assert sched.stats == {} and not sched.probe


def test_probe_sets_the_queue_depth_gauge():
    gauge = tmetrics.REGISTRY.gauge("pathway_queue_depth")
    sc = Scope()
    sess = sc.input_session(1)
    e = sc.expression_table(sess, [tex.ColumnRef(0)])
    depths = []
    sc.subscribe_table(e, on_change=lambda *a: depths.append(gauge.value))
    sched = Scheduler(sc, probe=True)
    sess.insert(ref_scalar(1), (1,))
    sched.commit()
    assert depths == [1.0]  # only the sink had a pending batch on its sweep
    assert gauge.value == 0.0  # the last sweep found nothing pending
    st = sched.stats[e.index]
    assert isinstance(st, OperatorStats)
    assert (st.insertions, st.deletions, st.batches, st.last_time) == (1, 0, 1, 0)


@pytest.mark.parametrize("metrics_env", [None, "1"])
def test_pw_run_probes_when_process_metrics_are_asked_for(monkeypatch, metrics_env):
    """``pw.run`` turns the probe on under ``PATHWAY_PROCESS_METRICS``, as the JAX
    ``run`` does, and the runner keeps its scheduler."""
    if metrics_env is None:
        monkeypatch.delenv("PATHWAY_PROCESS_METRICS", raising=False)
    else:
        monkeypatch.setenv("PATHWAY_PROCESS_METRICS", metrics_env)
    runners = []
    run = GraphRunner.run

    def keep(self):
        runners.append(self)
        return run(self)

    monkeypatch.setattr(GraphRunner, "run", keep)

    class Feed(tpw.io.python.ConnectorSubject):
        def run(self) -> None:
            for i in range(6):
                self.next(x=i)

    t = tpw.io.python.read(Feed(), schema=tpw.schema_from_types(x=int))
    seen = []
    tpw.io.subscribe(t.select(y=tpw.this.x * 2), on_change=lambda **kw: seen.append(kw))
    tpw.run()
    assert len(seen) == 6
    (runner,) = runners
    assert runner.scheduler is not None and runner.scheduler.probe == bool(metrics_env)
    if metrics_env:
        assert sum(st.insertions for st in runner.scheduler.stats.values()) >= 6 * 2
    else:
        assert runner.scheduler.stats == {}
    assert [t for t in threading.enumerate() if t.name == "pw-device-pipeline"] == []


# -- the metric primitives against the JAX package's ----------------------------------


def test_histogram_quantiles_match_jax():
    from pathway_tpu.internals import metrics as jmetrics

    rng = np.random.default_rng(3)
    values = rng.exponential(0.01, size=500)
    ours = tmetrics.Histogram(dp.DISPATCH_BUCKETS)
    theirs = jmetrics.Histogram(dp.DISPATCH_BUCKETS)
    assert ours.quantile(0.5) == theirs.quantile(0.5) == 0.0
    for v in values:
        ours.observe(float(v))
        theirs.observe(float(v))
        assert ours.counts == theirs.counts
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile(q) == theirs.quantile(q)
    assert (ours.count, ours.sum) == (theirs.count, theirs.sum)


def test_registry_caches_handles_and_checks_kinds():
    reg = tmetrics.Registry()
    c = reg.counter("x_total")
    assert reg.counter("x_total") is c and reg.counter("x_total", shard="1") is not c
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    g = reg.gauge("depth")
    g.set(4.0)
    assert reg.gauge("depth").value == 4.0
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x_total")
    with pytest.raises(ValueError, match="strictly increasing"):
        tmetrics.Histogram([1.0, 1.0])
