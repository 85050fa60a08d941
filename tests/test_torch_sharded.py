"""Workers in one process: the port's ``pw.run(threads=N)`` path (``engine/sharded.py``,
``ShardedGraphRunner``, the input mirrors, per-worker operator snapshots) against its
own one-worker run and the JAX package's ``ShardedGraphRunner``.

Every scenario of ``tests/test_sharded_parametrized.py`` (less ``sql_group_having``: no
``pw.sql`` in the port yet, ROADMAP queue 1 item 8) runs at 2 and 4 workers: the port's
captured state must equal its ``threads=1`` state and the reference's sharded state,
keys and values bit for bit. The cases of ``tests/test_sharded.py`` follow (less the
async transformer, item 8, and the row transformer of the parametrized file, whose
``RecomputeNode`` is not ported), then the operator snapshots of
``tests/test_operator_snapshots.py``'s sharded cases. Every sharded run of the port here
goes under ``PATHWAY_TPU_VERIFY_ELISION=1`` (each elided delivery is routed again and
must stay on its worker) and checks the exchange's invariant
``elided + host_deliveries + collective_deliveries == repartitions``, with no collective
delivery (the device plane comes with item 14's slice c).
"""

from __future__ import annotations

import contextlib
import importlib
import json
import struct

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu.internals.runner import ShardedGraphRunner as JShardedGraphRunner
from pathway_tpu_torch.engine import device_ops
from pathway_tpu_torch.engine.routing import EXCHANGE_STATS
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.internals.runner import GraphRunner, ShardedGraphRunner

SEED = 0
WORDS = ["apple", "banana", "apple", "cherry", "banana", "apple", "date"]
FINAL_COUNTS = {"apple": 3, "banana": 2, "cherry": 1, "date": 1}


@pytest.fixture(autouse=True)
def _cpu_and_verified(monkeypatch):
    """The port's device operators on CPU tensors (auto mode keeps the host kernels
    there), the JAX package's off, every elided delivery routed again, and both
    packages' UDF cache roots as they were (a persistent run routes them under its
    store)."""
    from pathway_tpu.internals.udfs import caches as jcaches
    from pathway_tpu_torch.internals.udfs import caches as tcaches

    roots = (jcaches._udf_cache_root, tcaches._udf_cache_root)
    monkeypatch.delenv("PATHWAY_TPU_DEVICE_OPS", raising=False)
    monkeypatch.setenv("PATHWAY_TPU_VERIFY_ELISION", "1")
    device_ops.configure(device="cpu")
    TG.clear()
    JG.clear()
    yield
    device_ops.configure()
    TG.clear()
    JG.clear()
    jcaches.set_udf_cache_root(roots[0])
    tcaches.set_udf_cache_root(roots[1])


class _Exchange:
    """The exchange counters' movement over a block, checked on exit."""

    def __enter__(self):
        self.before = dict(EXCHANGE_STATS)
        return self

    def __exit__(self, *exc):
        if exc[0] is not None:
            return
        d = {k: EXCHANGE_STATS[k] - self.before[k] for k in EXCHANGE_STATS}
        self.delta = d
        assert d["elided"] + d["host_deliveries"] + d["collective_deliveries"] == d["repartitions"]
        assert d["collective_deliveries"] == 0
        assert d["repartitions"] > 0


def _norm(v):
    """A comparable form of a value of either package: Pointers by their ints, floats
    by their bits, containers element by element."""
    name = type(v).__name__
    if name == "Pointer":
        return ("ptr", int(v))
    if isinstance(v, float):
        return ("f", struct.pack("<d", v))
    if isinstance(v, (tuple, list)):
        return tuple(_norm(x) for x in v)
    if name == "Json":
        return ("json", repr(v))
    if isinstance(v, np.ndarray):
        return ("nd", v.dtype.str, v.tobytes())
    return v


def _state(captured: dict) -> list:
    return sorted(((int(k), _norm(r)) for k, r in captured.items()), key=repr)


def _mod(pw, name: str):
    """Module ``name`` of either package."""
    return importlib.import_module(f"{pw.__name__}.{name}")


def _capture(runner, build):
    (state,) = runner.capture(build())
    return _state(state)


# -- the scenarios of the parametrized file, in either package --------------------------


def people(pw):
    return pw.debug.table_from_rows(
        pw.schema_from_types(name=str, age=int, city=str),
        [
            ("alice", 30, "paris"),
            ("bob", 25, "london"),
            ("carol", 35, "paris"),
            ("dave", 20, "london"),
            ("erin", 28, "berlin"),
            ("frank", 40, "paris"),
        ],
    )


def purchases(pw):
    return pw.debug.table_from_rows(
        pw.schema_from_types(who=str, amount=int),
        [("alice", 10), ("bob", 20), ("alice", 30), ("carol", 5), ("erin", 1), ("zed", 99)],
    )


def _collatz(pw, t):
    return pw.iterate(
        lambda tt: dict(
            tt=tt.select(
                n=pw.if_else(
                    pw.this.n == 1,
                    pw.this.n,
                    pw.if_else(pw.this.n % 2 == 0, pw.this.n // 2, 3 * pw.this.n + 1),
                ),
                steps=pw.if_else(pw.this.n == 1, pw.this.steps, pw.this.steps + 1),
            )
        ),
        tt=t.select(n=pw.this.age, steps=0),
    ).tt


SCENARIOS = {
    "select_arith": lambda pw: people(pw).select(name=pw.this.name, next_age=pw.this.age + 1),
    "filter": lambda pw: people(pw).filter(pw.this.age >= 28),
    "groupby_count_sum": lambda pw: (
        lambda t: t.groupby(t.city).reduce(
            city=t.city, n=pw.reducers.count(), total=pw.reducers.sum(t.age)
        )
    )(people(pw)),
    "groupby_min_max_avg": lambda pw: (
        lambda t: t.groupby(t.city).reduce(
            city=t.city,
            youngest=pw.reducers.min(t.age),
            oldest=pw.reducers.max(t.age),
            avg=pw.reducers.avg(t.age),
        )
    )(people(pw)),
    "groupby_tuples": lambda pw: (
        lambda t: t.groupby(t.city).reduce(city=t.city, names=pw.reducers.sorted_tuple(t.name))
    )(people(pw)),
    "inner_join": lambda pw: (
        lambda p, b: p.join(b, p.name == b.who).select(name=p.name, city=p.city, amount=b.amount)
    )(people(pw), purchases(pw)),
    "left_join": lambda pw: (
        lambda p, b: p.join(b, p.name == b.who, how="left").select(name=p.name, amount=b.amount)
    )(people(pw), purchases(pw)),
    "outer_join": lambda pw: (
        lambda p, b: p.join(b, p.name == b.who, how="outer").select(
            name=p.name, who=b.who, amount=b.amount
        )
    )(people(pw), purchases(pw)),
    "join_then_groupby": lambda pw: (
        lambda p, b: (
            lambda j: j.groupby(j.city).reduce(city=j.city, spent=pw.reducers.sum(j.amount))
        )(p.join(b, p.name == b.who).select(city=p.city, amount=b.amount))
    )(people(pw), purchases(pw)),
    "concat": lambda pw: people(pw).select(name=pw.this.name).concat_reindex(
        purchases(pw).select(name=pw.this.who)
    ),
    "distinct_via_groupby": lambda pw: (lambda t: t.groupby(t.city).reduce(city=t.city))(
        people(pw)
    ),
    "flatten": lambda pw: (
        lambda t: (lambda w: w.flatten(w.parts))(
            t.select(parts=pw.apply(lambda n: tuple(n), t.name))
        )
    )(people(pw)),
    "update_cells": lambda pw: (
        lambda t: t.update_cells(t.filter(t.age > 30).select(age=pw.this.age + 100))
    )(people(pw)),
    "deduplicate": lambda pw: (
        lambda t: t.deduplicate(value=t.age, instance=t.city, acceptor=lambda new, old: new > old)
    )(people(pw)),
    "sort_prev_next": lambda pw: (lambda t: t.sort(key=t.age, instance=t.city))(people(pw)),
    "wordcount_chain": lambda pw: (
        lambda t: (
            lambda counts: counts.filter(counts.n >= 2).select(city=counts.city, n2=counts.n * 10)
        )(t.groupby(t.city).reduce(city=t.city, n=pw.reducers.count()))
    )(people(pw)),
    "windowby_tumbling": lambda pw: (
        lambda t: t.windowby(t.age, window=pw.temporal.tumbling(duration=10)).reduce(
            start=pw.this["_pw_window_start"], n=pw.reducers.count()
        )
    )(people(pw)),
    "windowby_session_instance": lambda pw: (
        lambda t: t.windowby(
            t.age, window=pw.temporal.session(max_gap=6), instance=t.city
        ).reduce(city=pw.this["_pw_instance"], n=pw.reducers.count())
    )(people(pw)),
    "interval_join": lambda pw: (
        lambda p, b: p.interval_join(b, p.age, b.amount, pw.temporal.interval(-5, 5)).select(
            name=pw.left.name, amount=pw.right.amount
        )
    )(people(pw), purchases(pw)),
    "asof_join": lambda pw: (
        lambda p, b: p.asof_join(b, p.age, b.amount, direction="backward").select(
            name=pw.left.name, amount=pw.right.amount
        )
    )(people(pw), purchases(pw)),
    "window_join": lambda pw: (
        lambda p, b: p.window_join(b, p.age, b.amount, pw.temporal.tumbling(duration=15)).select(
            name=pw.left.name, amount=pw.right.amount
        )
    )(people(pw), purchases(pw)),
    "intersect_difference": lambda pw: (
        lambda a, b: a.intersect(b).concat_reindex(a.difference(b))
    )(
        people(pw).with_id_from(pw.this.name),
        purchases(pw).with_id_from(pw.this.who),
    ),
    "ix_lookup": lambda pw: (
        lambda p, b: b.select(who=b.who, city=p.ix(p.pointer_from(b.who), optional=True).city)
    )(people(pw).with_id_from(pw.this.name), purchases(pw)),
    "iterate_collatz_steps": lambda pw: _collatz(pw, people(pw)),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("n_workers", [2, 4])
def test_sharded_matches_one_worker_and_the_reference(scenario, n_workers):
    build = SCENARIOS[scenario]
    one = _capture(GraphRunner(), lambda: build(tpw))
    with _Exchange():
        sharded = _capture(ShardedGraphRunner(n_workers), lambda: build(tpw))
    ref = _capture(JShardedGraphRunner(n_workers), lambda: build(jpw))
    assert sharded == one, scenario
    assert sharded == ref, scenario


def _gradual(pw, n_rows: int, triplet: tuple):
    t = pw.debug.table_from_rows(pw.schema_from_types(name=str), [(f"r{i}",) for i in range(n_rows)])
    thr = pw.debug.table_from_rows(pw.schema_from_types(lo=float, v=float, hi=float), [triplet])
    return t._gradual_broadcast(thr, thr.lo, thr.v, thr.hi)


def test_gradual_broadcast_under_sharding():
    one = _capture(GraphRunner(), lambda: _gradual(tpw, 30, (0.0, 0.5, 1.0)))
    with _Exchange():
        sharded = _capture(ShardedGraphRunner(4), lambda: _gradual(tpw, 30, (0.0, 0.5, 1.0)))
    ref = _capture(JShardedGraphRunner(4), lambda: _gradual(jpw, 30, (0.0, 0.5, 1.0)))
    assert sharded == one == ref
    assert all(r[-1] is not None for _k, r in sharded)


def _threshold_move(pw, runner):
    """A threshold triplet moved up in a later commit, pushed into worker 0's threshold
    node: the rows that cross re-emit, wherever their shards live."""
    out = _gradual(pw, 20, (0.0, 0.1, 1.0))
    reps = runner.build(out)
    sched = runner._make_scheduler()
    sched.commit()
    low = sum(1 for r in sched.merged_state(reps[0].index).values() if r[-1] == 1.0)
    batch_mod = _mod(pw, "engine.batch")
    value_mod = _mod(pw, "engine.value")
    thr_idx = reps[0].inputs[1].index
    runner.workers[0].scope.nodes[thr_idx].push(
        0, batch_mod.DeltaBatch([(value_mod.ref_scalar("t2"), (0.0, 0.9, 1.0), 1)])
    )
    sched.propagate(sched.time)
    merged = sched.merged_state(reps[0].index)
    return low, _state(merged)


def test_gradual_broadcast_threshold_moves_after_rows_sharded():
    with _Exchange():
        low, got = _threshold_move(tpw, ShardedGraphRunner(4))
    jlow, want = _threshold_move(jpw, JShardedGraphRunner(4))
    assert (low, got) == (jlow, want)
    assert len(got) == 20  # no row lost on the re-emit
    assert sum(1 for _k, r in got if r[-1] == ("f", struct.pack("<d", 1.0))) > low


# -- the cases of tests/test_sharded.py -------------------------------------------------


def wordcount(pw, words=WORDS):
    t = pw.debug.table_from_rows(pw.schema_from_types(word=str), [(w,) for w in words])
    return t.groupby(t.word).reduce(word=t.word, cnt=pw.reducers.count())


def test_wordcount_4_workers_matches_1():
    one = _capture(GraphRunner(), lambda: wordcount(tpw))
    with _Exchange():
        sharded = _capture(ShardedGraphRunner(4), lambda: wordcount(tpw))
    assert sharded == one == _capture(JShardedGraphRunner(4), lambda: wordcount(jpw))
    assert {r[0]: r[1] for _k, r in sharded} == FINAL_COUNTS


def test_state_is_actually_partitioned():
    """32 distinct words over 4 workers: each group lives on exactly one worker, the
    reference's, and more than one worker holds groups."""
    words = [f"w{i % 32}" for i in range(128)]
    per_pkg = []
    for pw, cls in ((tpw, ShardedGraphRunner), (jpw, JShardedGraphRunner)):
        runner = cls(4)
        reps = runner.build(wordcount(pw, words))
        if pw is tpw:
            with _Exchange():
                runner.run()
        else:
            runner.run()
        per_pkg.append([sorted(int(k) for k in r.current) for r in reps])
    ours, theirs = per_pkg
    assert ours == theirs
    assert sum(map(len, ours)) == 32 and max(map(len, ours)) < 32


def test_join_exchanges_both_sides():
    def build(pw):
        a = pw.debug.table_from_rows(
            pw.schema_from_types(k=str, v=int), [("x", 1), ("y", 2), ("z", 3)]
        )
        b = pw.debug.table_from_rows(pw.schema_from_types(k=str, w=str), [("x", "ex"), ("z", "zed")])
        return a.join(b, a.k == b.k).select(k=a.k, v=a.v, w=b.w)

    one = _capture(GraphRunner(), lambda: build(tpw))
    with _Exchange():
        sharded = _capture(ShardedGraphRunner(3), lambda: build(tpw))
    assert sharded == one == _capture(JShardedGraphRunner(3), lambda: build(jpw))
    assert len(sharded) == 2


def test_filter_select_chain():
    def build(pw):
        t = pw.debug.table_from_rows(pw.schema_from_types(n=int), [(i,) for i in range(20)])
        return t.filter(t.n % 2 == 0).select(sq=t.n * t.n)

    one = _capture(GraphRunner(), lambda: build(tpw))
    with _Exchange():
        sharded = _capture(ShardedGraphRunner(4), lambda: build(tpw))
    assert sharded == one == _capture(JShardedGraphRunner(4), lambda: build(jpw))


def test_ix_routes_lookups_to_the_owner():
    def build(pw):
        src = pw.debug.table_from_rows(pw.schema_from_types(name=str), [("alice",), ("bob",)])
        keys = src.select(ptr=src.id)
        return keys.ix(keys.ptr)

    one = _capture(GraphRunner(), lambda: build(tpw))
    with _Exchange():
        sharded = _capture(ShardedGraphRunner(4), lambda: build(tpw))
    assert sharded == one == _capture(JShardedGraphRunner(4), lambda: build(jpw))


def test_worker_scope_divergence_detected():
    from pathway_tpu_torch.engine.graph import Scope
    from pathway_tpu_torch.engine.sharded import ShardedScheduler

    s0, s1 = Scope(), Scope()
    s0.input_session(1)
    s1.static_table([], 1)
    with pytest.raises(ValueError, match="diverged"):
        ShardedScheduler([s0, s1])
    # worker 0 may carry extra trailing nodes (its sinks): no divergence
    s2, s3 = Scope(), Scope()
    s2.input_session(1)
    s2.input_session(1)
    s3.input_session(1)
    ShardedScheduler([s2, s3], optimize=False)


def _jsonl(tmp_path, name="in.jsonl"):
    src = tmp_path / name
    src.write_text("\n".join(json.dumps({"word": w}) for w in WORDS))
    return src


def test_connector_reads_on_worker_0_and_reshards(tmp_path):
    src = _jsonl(tmp_path)

    def build(pw):
        class S(pw.Schema):
            word: str

        t = pw.io.jsonlines.read(src, schema=S, mode="static")
        return t.groupby(t.word).reduce(word=t.word, cnt=pw.reducers.count())

    runner = ShardedGraphRunner(4)
    with _Exchange():
        sharded = _capture(runner, lambda: build(tpw))
    assert len(runner.workers[0].drivers) == 1
    assert all(not w.drivers for w in runner.workers[1:])
    assert {r[0]: r[1] for _k, r in sharded} == FINAL_COUNTS
    assert sharded == _capture(GraphRunner(), lambda: build(tpw))
    assert sharded == _capture(JShardedGraphRunner(4), lambda: build(jpw))


def _rows(path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


@pytest.mark.parametrize("threads", [1, 4])
def test_pw_run_threads_with_two_sinks(tmp_path, threads):
    """``pw.run(threads=N)``: a jsonlines source read on worker 0, two sinks on distinct
    tables attached on worker 0, the same rows as one worker writes."""
    src = _jsonl(tmp_path)
    o1, o2 = tmp_path / "o1.jsonl", tmp_path / "o2.jsonl"

    class S(tpw.Schema):
        word: str

    t = tpw.io.jsonlines.read(src, schema=S, mode="static")
    counts = t.groupby(t.word).reduce(word=t.word, cnt=tpw.reducers.count())
    lengths = t.select(word=t.word, n=tpw.apply(len, t.word))
    tpw.io.jsonlines.write(counts, o1)
    tpw.io.jsonlines.write(lengths, o2)
    with _Exchange() if threads > 1 else contextlib.nullcontext():
        tpw.run(threads=threads)
    assert {r["word"]: r["cnt"] for r in _rows(o1) if r["diff"] > 0} == FINAL_COUNTS
    assert sorted((r["word"], r["n"]) for r in _rows(o2)) == sorted((w, len(w)) for w in WORDS)


def test_pathway_threads_variable_runs_the_sharded_runner(tmp_path, monkeypatch):
    """``PATHWAY_THREADS`` picks the sharded runner as ``threads=`` does; processes above
    1 pick the distributed runner, with the threads and the process id of the
    environment (its run spied on: no peer is listening)."""
    from pathway_tpu_torch.internals import runner as trunner

    made = []
    init = trunner.ShardedGraphRunner.__init__

    def spy(self, n, **kw):
        made.append(n)
        init(self, n, **kw)

    monkeypatch.setattr(trunner.ShardedGraphRunner, "__init__", spy)
    monkeypatch.setenv("PATHWAY_THREADS", "2")
    out = {}
    t = wordcount(tpw)
    tpw.io.subscribe(t, on_change=lambda key, row, time, is_addition: out.update(
        {row["word"]: row["cnt"]} if is_addition else {}))
    tpw.run()
    assert made == [2] and out == FINAL_COUNTS
    meshes = []
    monkeypatch.setattr(trunner.DistributedGraphRunner, "run", lambda self: meshes.append(
        (self.threads, self.processes, self.process_id, len(self.workers))))
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "1")
    tpw.run(processes=2)
    assert meshes == [(2, 2, 1, 2)]


def test_operator_persistence_accepted_multiworker():
    from pathway_tpu_torch.persistence import Backend, Config, PersistenceMode

    cfg = Config(Backend.mock(), persistence_mode=PersistenceMode.OPERATOR_PERSISTING)
    runner = ShardedGraphRunner(2, persistence_config=cfg)
    assert runner.workers[0]._operator_snapshot_manager() is not None


def _upsert(pw, runner, second: bool):
    """An upsert stream into a global sum; with ``second`` the key ``a`` is replaced in
    a later commit, after its first row reached another worker."""
    storage = _mod(pw, "engine.storage")
    tp = storage.InMemoryTransport()
    tp.produce(json.dumps({"k": "a", "v": 1}))
    tp.produce(json.dumps({"k": "b", "v": 10}))

    class S(pw.Schema):
        k: str = pw.column_definition(primary_key=True)
        v: int

    t = pw.io.kafka.read(None, "topic", format="json", schema=S, transport=tp)
    reps = runner.build(t.groupby().reduce(total=pw.reducers.sum(t.v)))
    sched = runner._make_scheduler()
    for d in runner.workers[0].drivers:
        d.poll()
    sched.commit()
    if second:
        tp.produce(json.dumps({"k": "a", "v": 100}))
    tp.close()
    for d in runner.workers[0].drivers:
        d.poll()
    sched.commit()
    return sorted(sched.merged_state(reps[0].index).values())


def test_upsert_stream_retractions():
    """An upsert's replacement retracts the old row even when its shard downstream
    lives on another worker."""
    with _Exchange():
        got = _upsert(tpw, ShardedGraphRunner(4), True)
    assert got == [(110,)]  # not 111: the old row was retracted
    assert got == _upsert(jpw, JShardedGraphRunner(4), True)


# -- the columnar and object-column pipelines -------------------------------------------


def _group_scopes(pw, n: int, arity: int, by_cols: list):
    graph, reducers = _mod(pw, "engine.graph"), _mod(pw, "engine.reducers")
    scopes, gbs = [], []
    for _ in range(n):
        scope = graph.Scope()
        sess = scope.input_session(arity)
        gb = scope.group_by_table(
            sess, by_cols=by_cols,
            reducers=[(reducers.make_reducer(reducers.ReducerKind.COUNT), [])],
        )
        scopes.append(scope)
        gbs.append(gb)
    return scopes, gbs


def _columnar(pw, cols, keys, ptr):
    batch = _mod(pw, "engine.batch")
    payload = batch.Columns(len(keys), cols, kobjs=[ptr(int(k)) for k in keys])
    return batch.DeltaBatch.from_columns(payload, consolidated=True, insert_only=True)


def _scheduler_shards(pw, n, arity, by_cols, cols, keys, consumer="groupby"):
    sharded = _mod(pw, "engine.sharded")
    graph = _mod(pw, "engine.graph")
    value = _mod(pw, "engine.value")
    scopes, gbs = _group_scopes(pw, n, arity, by_cols)
    sched = sharded.ShardedScheduler(scopes)
    batch = _columnar(pw, cols, keys, value.Pointer)
    node = scopes[0].nodes[gbs[0].index]
    if consumer == "filter":
        node = graph.FilterNode(scopes[0], scopes[0].nodes[gbs[0].inputs[0].index], 0)
    shards = sched._columnar_shards(node, 0, batch)
    assert shards is not None
    return shards.tolist()


def test_vectorized_shards_match_row_partitioners():
    from pathway_tpu_torch.engine.routing import _shard_of
    from pathway_tpu_torch.engine.value import ref_scalar

    n = 4
    keys = [ref_scalar(("k", i)) for i in range(500)]
    for vals in (np.arange(500, dtype=np.int64) % 17,
                 np.asarray([f"s{i % 13}" for i in range(500)])):
        cols = [vals, np.arange(500, dtype=np.int64)]
        got = _scheduler_shards(tpw, n, 2, [0], cols, keys)
        assert got == _scheduler_shards(jpw, n, 2, [0], cols, keys)
        assert got == [_shard_of((v,), n) for v in vals.tolist()]
        by_key = _scheduler_shards(tpw, n, 2, [0], cols, keys, consumer="filter")
        assert by_key == [_shard_of(k, n) for k in keys]


def test_multicolumn_shards_match_row_partitioners():
    from pathway_tpu_torch.engine.routing import _shard_of
    from pathway_tpu_torch.engine.value import ref_scalar

    n = 4
    keys = [ref_scalar(("mk", i)) for i in range(600)]
    c0 = np.arange(600, dtype=np.int64) % 11
    c1 = np.asarray([f"t{i % 7}" for i in range(600)])
    c2 = np.arange(600, dtype=np.float64)
    got = _scheduler_shards(tpw, n, 3, [0, 1], [c0, c1, c2], keys)
    assert got == _scheduler_shards(jpw, n, 3, [0, 1], [c0, c1, c2], keys)
    assert got == [_shard_of((int(a), str(b)), n) for a, b in zip(c0.tolist(), c1.tolist())]
    c0f = c0.astype(np.float64)
    c0f[3] = float("nan")  # stays vectorized: bit-pattern classes
    got = _scheduler_shards(tpw, n, 3, [0, 1], [c0f, c1, c2], keys)
    assert got == _scheduler_shards(jpw, n, 3, [0, 1], [c0f, c1, c2], keys)
    assert got == [_shard_of((float(a), str(b)), n) for a, b in zip(c0f.tolist(), c1.tolist())]


def _spy_columnar(monkeypatch, multi_only: bool = False) -> list:
    from pathway_tpu_torch.engine import sharded

    calls = []
    orig = sharded.ShardedScheduler._columnar_shards

    def spy(self, consumer, port, out):
        got = orig(self, consumer, port, out)
        rule = sharded.partition_rule(consumer, port)
        if not multi_only or (rule[0] == "cols" and len(rule[1]) > 1):
            calls.append(got is not None)
        return got

    monkeypatch.setattr(sharded.ShardedScheduler, "_columnar_shards", spy)
    return calls


@pytest.mark.parametrize("device_ops_mode", ["0", "1"])
def test_sharded_columnar_pipeline_matches_single(monkeypatch, device_ops_mode):
    """select -> filter -> groupby over 4 workers, the columnar exchange engaged; with
    ``PATHWAY_TPU_DEVICE_OPS=1`` every worker's groupby takes the device route (on CPU
    tensors here)."""
    def build(pw):
        t = pw.debug.table_from_rows(
            pw.schema_from_types(k=int, v=int), [(i % 23, i) for i in range(4000)]
        )
        big = t.filter(pw.this.v >= 100)
        return big.groupby(big.k).reduce(k=big.k, s=pw.reducers.sum(big.v))

    ref = _capture(JShardedGraphRunner(4), lambda: build(jpw))
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", device_ops_mode)
    one = _capture(GraphRunner(), lambda: build(tpw))
    calls = _spy_columnar(monkeypatch)
    runner = ShardedGraphRunner(4)
    with _Exchange():
        sharded = _capture(runner, lambda: build(tpw))
    assert sharded == one == ref
    assert any(calls), "the columnar exchange never engaged"
    if device_ops_mode == "1":
        from pathway_tpu_torch.engine.graph import GroupbyNode

        routes = [n.routes for w in runner.workers for n in w.scope.nodes
                  if isinstance(n, GroupbyNode)]
        assert len(routes) == 4 and all(r["device"] >= 1 and r["rows"] == 0 for r in routes)


def test_sharded_multikey_join_groupby_matches_single(monkeypatch):
    def build(pw):
        facts = pw.debug.table_from_rows(
            pw.schema_from_types(a=int, b=str, v=int),
            [(i % 13, f"g{i % 5}", i) for i in range(3000)],
        )
        dims = pw.debug.table_from_rows(
            pw.schema_from_types(a=int, b=str, w=int),
            [(i % 13, f"g{i % 5}", 100 * i) for i in range(65)],
        )
        j = facts.join(dims, facts.a == dims.a, facts.b == dims.b).select(
            facts.a, facts.b, s=facts.v + dims.w
        )
        return j.groupby(j.a, j.b).reduce(j.a, j.b, total=pw.reducers.sum(j.s), n=pw.reducers.count())

    one = _capture(GraphRunner(), lambda: build(tpw))
    calls = _spy_columnar(monkeypatch, multi_only=True)
    with _Exchange():
        sharded = _capture(ShardedGraphRunner(4), lambda: build(tpw))
    assert sharded == one == _capture(JShardedGraphRunner(4), lambda: build(jpw))
    assert calls and all(calls), "the multi-column exchange fell back to the row path"


def test_object_column_routes_match_row_partitioners():
    from pathway_tpu_torch.engine.routing import _shard_of
    from pathway_tpu_torch.engine.value import ref_scalar

    n = 4
    values = [1, 1.0, True, "one", None, (1, 2), [3, 4], 2.5] * 40
    keys = [ref_scalar(("ok", i)) for i in range(len(values))]
    col = np.empty(len(values), object)
    col[:] = values
    cols = [col, np.arange(len(values), dtype=np.int64)]
    got = _scheduler_shards(tpw, n, 2, [0], cols, keys)
    assert got == _scheduler_shards(jpw, n, 2, [0], cols, keys)
    assert got == [_shard_of((v,), n) for v in values]
    assert got[0] == got[1]  # 1 and 1.0: one digest


def test_sharded_object_groupby_matches_single():
    from typing import Any

    rows = [(v, i) for i, v in enumerate([1, 1.0, True, "one", None, 2.5, "one", 1] * 50)]

    def build(pw):
        t = pw.debug.table_from_rows(pw.schema_from_types(g=Any, v=int), rows)
        return t.groupby(t.g).reduce(g=t.g, n=pw.reducers.count(), s=pw.reducers.sum(t.v))

    one = _capture(GraphRunner(), lambda: build(tpw))
    with _Exchange():
        sharded = _capture(ShardedGraphRunner(4), lambda: build(tpw))
    assert sharded == one == _capture(JShardedGraphRunner(4), lambda: build(jpw))


def _after_reindex(pw, which: str, n_workers: int) -> list:
    """Two sessions re-keyed by a pointer column straight into a zip or an update
    merge, at ``n_workers`` (0: the one-worker Scheduler): -> the merged state. The
    re-key moves each row to another worker between the producer and the consumer."""
    graph, value = _mod(pw, "engine.graph"), _mod(pw, "engine.value")
    sharded = _mod(pw, "engine.sharded")
    rng = np.random.default_rng(SEED + 3)
    ids = rng.permutation(60)
    scopes, sessions, outs = [], [], []
    for _w in range(max(1, n_workers)):
        sc = graph.Scope()
        s1, s2 = sc.input_session(2), sc.input_session(2)
        r1, r2 = graph.ReindexNode(sc, s1, 0), graph.ReindexNode(sc, s2, 0)
        if which == "zip":
            out = graph.ZipNode(sc, [r1, r2])
        elif which == "update_rows":
            out = graph.UpdateRowsNode(sc, r1, r2)
        else:
            out = graph.UpdateCellsNode(sc, r1, r2, [-1, 1])
        scopes.append(sc)
        sessions.append((s1, s2))
        outs.append(out)
    if n_workers:
        sched = sharded.ShardedScheduler(scopes, optimize=False)
    else:
        sched = graph.Scheduler(scopes[0], optimize=False)
    s1, s2 = sessions[0]
    for commit in range(2):
        for i in range(30 * commit, 30 * commit + 30):
            new = value.ref_scalar("row", int(ids[i]))
            s1.insert(value.ref_scalar("a", i), (new, i))
            if i % 2 == commit:
                s2.insert(value.ref_scalar("b", i), (new, 1000 + i))
        sched.commit()
    merged = {}
    for out in outs:
        merged.update(out.current)
    return _state(merged)


@pytest.mark.parametrize("which", ["zip", "update_rows", "update_cells"])
def test_input_mirrors_after_a_reindex(which):
    """The operators that peek at their inputs' state read their own mirrors under
    sharding: fed straight from a re-key, they give the one-worker answer and the
    reference's."""
    one = _after_reindex(tpw, which, 0)
    with _Exchange():
        sharded = _after_reindex(tpw, which, 3)
    assert sharded == one == _after_reindex(jpw, which, 3)
    assert len(one) == (30 if which == "zip" else 60)


# -- operator snapshots of several workers ------------------------------------------------


def _write_words(data, name, words):
    (data / name).write_text("\n".join(words) + "\n")


def _wordcount_run(pw, data, store, out, threads: int) -> list[dict]:
    """The persistence tutorial's word count under operator persistence at ``threads``
    workers: -> the rows its jsonlines sink wrote."""
    pers = _mod(pw, "persistence")
    words = pw.io.plaintext.read(str(data), mode="static", persistent_id="w")
    counts = words.groupby(words.data).reduce(word=words.data, cnt=pw.reducers.count())
    pw.io.jsonlines.write(counts, str(out))
    pw.run(threads=threads, persistence_config=pers.Config(
        pers.Backend.filesystem(str(store)),
        persistence_mode=pers.PersistenceMode.OPERATOR_PERSISTING,
    ))
    return _rows(out)


def test_sharded_resume_emits_only_the_delta(tmp_path):
    """Three workers snapshot their replicas; the resume restores them and emits only
    the groups the new file touched, as the reference's does."""
    finals = {}
    for name, pw in (("torch", tpw), ("jax", jpw)):
        data = tmp_path / name / "data"
        data.mkdir(parents=True)
        _write_words(data, "a.txt", ["apple", "banana", "apple", "durian", "elder"])
        store = tmp_path / name / "store"
        rows = _wordcount_run(pw, data, store, tmp_path / name / "out1.jsonl", 3)
        assert {r["word"]: r["cnt"] for r in rows if r["diff"] > 0} == {
            "apple": 2, "banana": 1, "durian": 1, "elder": 1,
        }
        _write_words(data, "b.txt", ["banana", "cherry"])
        with _Exchange() if pw is tpw else contextlib.nullcontext():
            rows = _wordcount_run(pw, data, store, tmp_path / name / "out2.jsonl", 3)
        finals[name] = sorted((r["word"], r["cnt"], r["diff"]) for r in rows)
        assert {r["word"]: r["cnt"] for r in rows if r["diff"] > 0} == {"banana": 2, "cherry": 1}
        assert all(r["word"] not in ("apple", "durian", "elder") for r in rows)
    assert finals["torch"] == finals["jax"]


def _sum_scopes(pw, n_workers: int):
    graph, reducers = _mod(pw, "engine.graph"), _mod(pw, "engine.reducers")
    scopes, sessions, aggs = [], [], []
    for _w in range(n_workers):
        sc = graph.Scope()
        sess = sc.input_session(2)
        agg = sc.group_by_table(
            sess, by_cols=[0],
            reducers=[(reducers.make_reducer(reducers.ReducerKind.SUM), [1])],
        )
        scopes.append(sc)
        sessions.append(sess)
        aggs.append(agg)
    return scopes, sessions, aggs


def _reshard_run(pw, root, n_old: int, n_new: int) -> tuple[list, dict]:
    """A SUM groupby snapshotted at ``n_old`` workers, restored at ``n_new`` and fed
    one more row: -> (each new replica's state, the merged answer)."""
    value, sharded = _mod(pw, "engine.value"), _mod(pw, "engine.sharded")
    persistence = _mod(pw, "engine.persistence")
    mgr = persistence.OperatorSnapshotManager(persistence.FileBackend(str(root)))
    rng = np.random.default_rng(SEED + 10 * n_old + n_new)
    groups = rng.integers(0, 8, 40).tolist()
    vals = (rng.integers(-400, 400, 40) * 0.25).tolist()
    scopes, sessions, _aggs = _sum_scopes(pw, n_old)
    sched = sharded.ShardedScheduler(scopes)
    for i, (g, v) in enumerate(zip(groups, vals)):
        sessions[0].insert(value.ref_scalar(i), (g, v))
    sched.commit()
    mgr.snapshot(scopes, [], sched.time)
    scopes2, sessions2, aggs2 = _sum_scopes(pw, n_new)
    assert mgr.restore(scopes2, []) is not None
    sched2 = sharded.ShardedScheduler(scopes2)
    sched2.time = 99
    sessions2[0].insert(value.ref_scalar(1000), (3, 1000.0))
    sched2.commit()
    merged = {}
    for agg in aggs2:
        merged.update(agg.current)
    want: dict = {}
    for g, v in zip(groups, vals):
        want[g] = want.get(g, 0.0) + v
    want[3] = want.get(3, 0.0) + 1000.0
    got = {row[0]: row[1] for row in merged.values()}
    assert got == want
    return [_state(agg.current) for agg in aggs2], got


@pytest.mark.parametrize("counts", [(2, 3), (3, 1), (1, 2)])
def test_worker_count_change_reshards_the_groupby(tmp_path, counts):
    """A snapshot written at one worker count restores at another: every new replica's
    groupby state equals the reference's re-sharded replica, and the answer after one
    more row is NumPy's."""
    n_old, n_new = counts
    before = dict(EXCHANGE_STATS)
    ours = _reshard_run(tpw, tmp_path / "torch", n_old, n_new)
    theirs = _reshard_run(jpw, tmp_path / "jax", n_old, n_new)
    assert ours[0] == theirs[0]
    assert ours[1] == theirs[1]
    d = {k: EXCHANGE_STATS[k] - before[k] for k in EXCHANGE_STATS}
    assert d["elided"] + d["host_deliveries"] + d["collective_deliveries"] == d["repartitions"]
    assert d["collective_deliveries"] == 0
    if n_new > 1:
        assert sum(1 for replica in ours[0] if replica) > 1  # the groups spread again


def _iterate_body(states: list) -> dict:
    """A fixed point over both whole inputs: each left row, its right partner's value
    added where there is one, and the left side's size."""
    left, right = states
    return {
        k: (row[1] + (right[k][1] if k in right else 0), len(left)) for k, row in left.items()
    }


def _peeking_scope(which: str):
    """Two sessions re-keyed by a pointer column into an operator that reads its inputs'
    state: -> (scope, sessions, that operator)."""
    from pathway_tpu_torch.engine import graph
    from pathway_tpu_torch.engine.iterate import IterateNode

    sc = graph.Scope()
    s1, s2 = sc.input_session(2), sc.input_session(2)
    r1, r2 = sc.reindex_table(s1, 0), sc.reindex_table(s2, 0)
    if which == "zip":
        out = sc.zip_tables([r1, r2])
    elif which == "update_cells":
        out = sc.update_cells_table(r1, r2, [-1, 1])
    elif which == "restrict":
        out = sc.restrict_table(r1, r2)
    else:
        out = IterateNode(sc, [r1, r2], 2, _iterate_body)
    return sc, (s1, s2), out


def _peeking_commits(sessions, commit: int) -> None:
    """Commit 0 fills both sides in part; commit 1 removes old left rows and gives the
    right side partners for old left rows, so its answer needs the state before it."""
    from pathway_tpu_torch.engine.value import ref_scalar

    s1, s2 = sessions
    ids = np.random.default_rng(SEED + 21).permutation(80)
    new = [ref_scalar("row", int(i)) for i in ids]
    if commit == 0:
        for i in range(40):
            s1.insert(ref_scalar("a", i), (new[i], i))
            if i % 3 == 0:
                s2.insert(ref_scalar("b", i), (new[i], 1000 + i))
    else:
        for i in range(0, 40, 5):
            s1.remove(ref_scalar("a", i), (new[i], i))
        for i in range(40, 60):
            s1.insert(ref_scalar("a", i), (new[i], i))
        for i in range(40):
            if i % 3 == 1:
                s2.insert(ref_scalar("b", i), (new[i], 2000 + i))


def _peeking_scheduler(scopes: list):
    from pathway_tpu_torch.engine import graph, sharded

    if len(scopes) == 1:
        return graph.Scheduler(scopes[0], optimize=False)
    return sharded.ShardedScheduler(scopes, optimize=False)


@pytest.mark.parametrize("counts", [(1, 2), (1, 3), (2, 1), (3, 2)])
@pytest.mark.parametrize("which", ["zip", "update_cells", "restrict", "iterate"])
def test_snapshot_resumes_at_another_worker_count_with_its_inputs_state(tmp_path, which, counts):
    """Operators that read their inputs' state resume at another worker count with it: a
    snapshot of one worker keeps no input mirrors, so they are rebuilt from the inputs'
    state (the iterate's input states too), and the next commit gives the uninterrupted
    one-worker run's answer."""
    from pathway_tpu_torch.engine import persistence

    n_old, n_new = counts
    sc, sessions, out = _peeking_scope(which)
    sched = _peeking_scheduler([sc])
    for commit in range(2):
        _peeking_commits(sessions, commit)
        sched.commit()
    want = _state(out.current)

    built = [_peeking_scope(which) for _ in range(n_old)]
    sched = _peeking_scheduler([b[0] for b in built])
    _peeking_commits(built[0][1], 0)
    sched.commit()
    mgr = persistence.OperatorSnapshotManager(persistence.FileBackend(str(tmp_path)))
    mgr.snapshot([b[0] for b in built], [], sched.time)
    built = [_peeking_scope(which) for _ in range(n_new)]
    assert mgr.restore([b[0] for b in built], []) == sched.time
    resumed = _peeking_scheduler([b[0] for b in built])
    resumed.time = sched.time
    with _Exchange() if n_new > 1 else contextlib.nullcontext():
        _peeking_commits(built[0][1], 1)
        resumed.commit()
    merged: dict = {}
    for _sc, _sessions, node in built:
        merged.update(node.current)
    assert _state(merged) == want
    assert len(want) > 20


def test_reshard_refuses_unknown_extra_state(tmp_path):
    """A sort's members have routing the re-shard cannot rebuild: a change of worker
    count is refused in both packages, and the same count restores."""
    for pw in (tpw, jpw):
        graph, value = _mod(pw, "engine.graph"), _mod(pw, "engine.value")
        sharded, persistence = _mod(pw, "engine.sharded"), _mod(pw, "engine.persistence")
        mgr = persistence.OperatorSnapshotManager(
            persistence.FileBackend(str(tmp_path / pw.__name__))
        )

        def build():
            sc = graph.Scope()
            sess = sc.input_session(2)
            sc.sort_table(sess, key_col=0, instance_col=None)
            return sc, sess

        built = [build(), build()]
        built[0][1].insert(value.ref_scalar(1), (1, 1.0))
        sched = sharded.ShardedScheduler([b[0] for b in built])
        sched.commit()
        mgr.snapshot([b[0] for b in built], [], 1)
        with pytest.raises(ValueError, match="re-shard|original worker"):
            mgr.restore([build()[0], build()[0], build()[0]], [])
        assert mgr.restore([build()[0], build()[0]], []) == 1


def _rag(pw, factory_cls):
    """Queries answered as of now by a KNN index over seeded vectors: the docs come in
    the first commit, the queries stream in after. The index is pinned to worker 0 and
    its replies restrict the query table, whose rows live on every worker."""
    rng = np.random.default_rng(SEED + 11)
    vecs = rng.standard_normal((64, 8)).astype(np.float32)
    docs = pw.debug.table_from_rows(
        pw.schema_from_types(doc_id=int, emb=np.ndarray),
        [(i, vecs[i]) for i in range(64)],
    )

    class Queries(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for q in range(16):
                self.next(qid=q, qemb=vecs[q * 7 % 64] + 0.01)

    queries = pw.io.python.read(Queries(), schema=pw.schema_from_types(qid=int, qemb=np.ndarray))
    index = _mod(pw, "stdlib.indexing").DataIndex(docs, factory_cls(dimensions=8, capacity=64),
                                                  docs.emb)
    res = index.query_as_of_now(queries, queries.qemb, number_of_matches=3)
    return res.select(qid=res.qid, hits=res["_pw_index_reply_ids"])


def test_restrict_by_a_table_pinned_to_worker_0():
    """``DataIndex.query_as_of_now`` restricts the queries by the index's replies, which
    live on worker 0: every query is answered at 2 workers as at 1, with its own doc
    first (the JAX package's key filter reads the replicas' state and answers only the
    queries worker 0 holds; the port's reads its own mirrors)."""
    from pathway_tpu_torch.stdlib.indexing import HostKnnFactory

    one = _capture(GraphRunner(), lambda: _rag(tpw, HostKnnFactory))
    with _Exchange():
        sharded = _capture(ShardedGraphRunner(2), lambda: _rag(tpw, HostKnnFactory))
    assert sharded == one and len(one) == 16
    docs = {int(k): r[0] for k, r in _capture(GraphRunner(), lambda: _docs_of(tpw))}
    assert all(docs[hits[0][1]] == qid * 7 % 64 for _k, (qid, hits) in one)


def test_the_index_is_built_on_worker_0_only(tmp_path):
    """The index operator is pinned to worker 0, so a sharded run builds its index
    there only: a replica's would hold memory no row reaches. Its operator snapshot
    keeps that one index, and a resume at another worker count answers from it: the
    query stream, read again, gets the first run's answers a second time."""
    from pathway_tpu_torch.engine.external_index import ExternalIndexNode
    from pathway_tpu_torch.persistence import Backend, Config, PersistenceMode
    from pathway_tpu_torch.stdlib.indexing import HostKnnFactory

    built = []

    class Counting(HostKnnFactory):
        def build(self):
            built.append(super().build())
            return built[-1]

    one = _capture(GraphRunner(), lambda: _rag(tpw, HostKnnFactory))
    cfg = Config(Backend.filesystem(str(tmp_path)),
                 persistence_mode=PersistenceMode.OPERATOR_PERSISTING)
    answers = sorted(r for _k, r in one)
    for leg, n_workers in enumerate((3, 2)):
        built.clear()
        runner = ShardedGraphRunner(n_workers, persistence_config=cfg)
        got = _capture(runner, lambda: _rag(tpw, Counting))
        assert sorted(r for _k, r in got) == sorted(answers * (leg + 1))
        nodes = [n for w in runner.workers for n in w.scope.nodes
                 if isinstance(n, ExternalIndexNode)]
        assert len(built) == 1 and [n.ext_index for n in nodes] == [built[0]] + [None] * (
            n_workers - 1
        )
        assert len(built[0].key_to_slot) == 64
        assert bool(runner.snapshot_manager.restore_bytes) == (leg == 1)


def _docs_of(pw):
    rng = np.random.default_rng(SEED + 11)
    vecs = rng.standard_normal((64, 8)).astype(np.float32)
    return pw.debug.table_from_rows(
        pw.schema_from_types(doc_id=int, emb=np.ndarray), [(i, vecs[i]) for i in range(64)]
    ).select(doc_id=pw.this.doc_id)
