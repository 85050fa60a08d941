"""The port's graph optimizer (``pathway_tpu_torch/optimize``) against the JAX package's.

The programs are the JAX package's own optimizer test programs
(``tests/test_optimize.py``): the engine-level chain ``source -> expr -> filter -> expr
-> expr`` (``_chain_scope``), the wide static source and expression producers of the
pushdown tests, the groupby consumer that blocks narrowing, the elision graph
(``_sharded_scopes``, one scope), the filter with error values, the non-vectorizable UDF
chain, and the Table-API corpus (``_corpus``: groupby, join, temporal, iterate). Each
is built in both packages and optimized by each package's ``optimize_scopes``: the
chains (index lists), the fingerprint strings, ``optimizer_stats()`` and the narrowed
arities must be equal. Outputs (values, diffs, error logs) with the optimizer on must
equal the outputs with it off, and equal the JAX package's, exactly (floats through
their int64 views).

The JAX package's device operators stay off here (its forced mode reaches
``jax.experimental.enable_x64``, which this jax lacks); the port's run on the CPU.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu import optimize as jopt
from pathway_tpu.analysis import shards as jshards
from pathway_tpu.engine import expression as jex
from pathway_tpu.engine import graph as jgraph
from pathway_tpu.engine import reducers as jred
from pathway_tpu.engine.value import ref_scalar as jref
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch import optimize as topt
from pathway_tpu_torch.analysis import shards as tshards
from pathway_tpu_torch.engine import device_ops
from pathway_tpu_torch.engine import expression as tex
from pathway_tpu_torch.engine import graph as tgraph
from pathway_tpu_torch.engine import reducers as tred
from pathway_tpu_torch.engine.value import ref_scalar as tref
from pathway_tpu_torch.internals.parse_graph import G as TG


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_OPTIMIZE", "1")
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")
    monkeypatch.delenv("PATHWAY_TPU_ANALYZE", raising=False)
    device_ops.configure(device="cpu")
    yield
    device_ops.configure()
    TG.clear()
    JG.clear()


class _Engine:
    def __init__(self, graph, ex, red, ref, opt, shards) -> None:
        self.g, self.ex, self.red, self.ref, self.opt, self.shards = (
            graph, ex, red, ref, opt, shards
        )

    def pointer(self, i):
        return type(self.ref(0))(i)


JAX = _Engine(jgraph, jex, jred, jref, jopt, jshards)
PORT = _Engine(tgraph, tex, tred, tref, topt, tshards)
ENGINES = [JAX, PORT]


def _canon(v):
    if isinstance(v, float):
        return ("f", np.float64(v).view(np.int64).item())
    if isinstance(v, (tuple, list)):
        return tuple(_canon(x) for x in v)
    if v is not None and type(v).__name__ == "Pointer":
        return ("ptr", int(v))
    if type(v).__name__ == "Error":  # each package's ERROR singleton
        return "ERROR"
    return v


# -- the JAX package's engine-level programs, in either engine --------------------------


def _chain_scope(e: _Engine, events=None):
    """source -> expr -> filter -> expr -> expr (+ subscribe)."""
    ex = e.ex
    sc = e.g.Scope()
    sess = sc.input_session(2)
    e1 = sc.expression_table(
        sess,
        [ex.ColumnRef(0), ex.ColumnRef(1), ex.Binary(">", ex.ColumnRef(0), ex.Const(10))],
    )
    f1 = sc.filter_table(e1, 2)
    e2 = sc.expression_table(
        f1, [ex.ColumnRef(0), ex.Binary("*", ex.ColumnRef(1), ex.Const(3.0))]
    )
    e3 = sc.expression_table(
        e2, [ex.ColumnRef(0), ex.Binary("+", ex.ColumnRef(1), ex.Const(1.0))]
    )
    if events is not None:
        sc.subscribe_table(e3, on_change=lambda k, row, t, d: events.append((k, row, t, d)))
    return sc, sess, e3


def _rows(e: _Engine, n, start=0):
    return [(e.ref(i), (i, float(i) * 0.5)) for i in range(start, start + n)]


def _run_chain(e: _Engine, optimize, n=600, updates=True):
    events: list = []
    sc, sess, tail = _chain_scope(e, events)
    sched = e.g.Scheduler(sc, optimize=optimize)
    for k, r in _rows(e, n):
        sess.insert(k, r)
    sched.commit()
    if updates:
        # a second commit with retractions and small batches (the row path)
        for k, r in _rows(e, 50, start=100):
            sess.remove(k, r)
            sess.insert(k, (r[0], r[1] + 9.0))
        sched.commit()
    canon = sorted(_canon((k, row, t, d)) for k, row, t, d in events)
    return sc, tail, canon


def _wide_static(e: _Engine, events, n_wide=8):
    ex = e.ex
    sc = e.g.Scope()
    rows = [(e.ref(i), tuple(float(i + c) for c in range(n_wide))) for i in range(50)]
    src = sc.static_table(rows, n_wide)
    e1 = sc.expression_table(src, [ex.Binary("+", ex.ColumnRef(1), ex.ColumnRef(5))])
    sc.subscribe_table(e1, on_change=lambda k, row, t, d: events.append((k, row, d)))
    return sc, [src]


def _wide_expression(e: _Engine, events):
    ex = e.ex
    sc = e.g.Scope()
    sess = sc.input_session(2)
    wide = sc.expression_table(
        sess, [ex.Binary("*", ex.ColumnRef(1), ex.Const(float(c + 1))) for c in range(6)]
    )
    n1 = sc.expression_table(wide, [ex.Binary("+", ex.ColumnRef(0), ex.ColumnRef(4))])
    n2 = sc.expression_table(wide, [ex.Binary("*", ex.ColumnRef(2), ex.ColumnRef(4))])
    sc.subscribe_table(n1, on_change=lambda k, row, t, d: events.append((k, row, d)))
    sc.subscribe_table(n2, on_change=lambda k, row, t, d: events.append((k, row, d)))
    for k, r in _rows(e, 300):
        sess.insert(k, r)
    return sc, [wide]


def _groupby_consumer(e: _Engine, events):
    sc = e.g.Scope()
    rows = [(e.ref(i), (i % 3, float(i), float(i))) for i in range(30)]
    src = sc.static_table(rows, 3)
    gb = sc.group_by_table(
        src, by_cols=[0], reducers=[(e.red.make_reducer(e.red.ReducerKind.SUM), [1])]
    )
    sc.subscribe_table(gb, on_change=lambda k, row, t, d: events.append((k, row, d)))
    return sc, [src]


def _elision(e: _Engine, events):
    """``_sharded_scopes``' graph, one scope: an elidable expr -> concat edge and a
    fusable chain feeding a groupby."""
    ex = e.ex
    sc = e.g.Scope()
    rows = [(e.pointer(i), (i % 7, float(i))) for i in range(400)]
    src = sc.static_table(rows, 2)
    e1 = sc.expression_table(
        src, [ex.ColumnRef(0), ex.Binary("*", ex.ColumnRef(1), ex.Const(2.0))]
    )
    f1 = sc.filter_table(
        sc.expression_table(
            e1,
            [ex.ColumnRef(0), ex.ColumnRef(1), ex.Binary(">", ex.ColumnRef(1), ex.Const(50.0))],
        ),
        2,
    )
    gb = sc.group_by_table(
        f1, by_cols=[0], reducers=[(e.red.make_reducer(e.red.ReducerKind.SUM), [1])]
    )
    e2 = sc.expression_table(
        gb, [ex.ColumnRef(0), ex.Binary("+", ex.ColumnRef(1), ex.Const(1.0))]
    )
    cc = sc.concat_tables([e2, sc.static_table([(e.pointer(10**6), (99, -1.0))], 2)])
    sc.subscribe_table(cc, on_change=lambda k, row, t, d: events.append((k, row, d)))
    return sc, []


def _filter_errors(e: _Engine, events):
    ex = e.ex
    sc = e.g.Scope()
    sess = sc.input_session(2)
    e1 = sc.expression_table(
        sess,
        [
            ex.ColumnRef(0),
            ex.Binary("/", ex.Const(1.0), ex.ColumnRef(1)),  # x == 0 rows become ERROR
            ex.Binary(">", ex.ColumnRef(0), ex.Const(-1)),
        ],
    )
    f1 = sc.filter_table(
        sc.expression_table(
            e1,
            [ex.ColumnRef(0), ex.ColumnRef(1), ex.Binary("<", ex.ColumnRef(1), ex.Const(1e9))],
        ),
        2,
    )
    sc.subscribe_table(f1, on_change=lambda k, row, t, d: events.append((k, row, d)))
    for i in range(40):
        sess.insert(e.ref(i), (i, float(i % 5)))
    return sc, []


def _udf_chain(e: _Engine, events):
    ex = e.ex
    sc = e.g.Scope()
    sess = sc.input_session(2)
    e1 = sc.expression_table(
        sess, [ex.ColumnRef(0), ex.Apply(lambda v: v * 2.0, (ex.ColumnRef(1),))]
    )
    e2 = sc.expression_table(e1, [ex.Binary("+", ex.ColumnRef(0), ex.ColumnRef(1))])
    sc.subscribe_table(e2, on_change=lambda k, row, t, d: events.append((k, row, d)))
    for k, r in _rows(e, 500):
        sess.insert(k, r)
    return sc, []


def _no_sinks(e: _Engine, events):
    sc = e.g.Scope()
    rows = [(e.ref(i), (float(i), float(i), float(i))) for i in range(9)]
    src = sc.static_table(rows, 3)
    sc.expression_table(src, [e.ex.ColumnRef(0)])
    return sc, [src]


def _chain_program(e: _Engine, events):
    sc, sess, _tail = _chain_scope(e, events)
    for k, r in _rows(e, 600):
        sess.insert(k, r)
    return sc, []


PROGRAMS = {
    "chain": _chain_program,
    "wide_static": _wide_static,
    "wide_expression": _wide_expression,
    "groupby_consumer": _groupby_consumer,
    "elision": _elision,
    "filter_errors": _filter_errors,
    "udf_chain": _udf_chain,
    "no_sinks": _no_sinks,
}


def _optimized(e: _Engine, name: str, optimize: bool, monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_OPTIMIZE", "1" if optimize else "0")
    events: list = []
    sc, watched = PROGRAMS[name](e, events)
    sched = e.g.Scheduler(sc)
    sched.commit()
    shape = {
        "fingerprint": list(getattr(sc, "_pw_opt_fingerprint", [])),
        "stats": e.opt.optimizer_stats(),
        "arities": [n.arity for n in watched],
        "fused": sorted(
            (n.index, getattr(n, "_pw_fused_into", None))
            for n in sc.nodes
            if getattr(n, "_pw_fused_into", None) is not None
        ),
        "tails": [n.index for n in sc.nodes if type(n).__name__ == "FusedChainNode"],
        "indices": [n.index for n in sc.nodes],
        "elided": sorted(getattr(sc, "_pw_opt_elided", set())),
    }
    log = sorted(_canon(v) for v in sc.error_log_default.current.values())
    return shape, sorted(_canon(ev) for ev in events), log


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_rewrite_and_outputs_match_the_reference(name, monkeypatch):
    shape_t, ev_on, log_on = _optimized(PORT, name, True, monkeypatch)
    shape_j, ev_j, log_j = _optimized(JAX, name, True, monkeypatch)
    _shape_off, ev_off, log_off = _optimized(PORT, name, False, monkeypatch)
    assert shape_t == shape_j
    assert ev_on == ev_off == ev_j
    assert log_on == log_off == log_j
    assert shape_t["indices"] == list(range(len(shape_t["indices"])))
    if name == "filter_errors":
        assert log_on  # the program exercised the error path
    if name != "no_sinks":
        assert ev_on


@pytest.mark.parametrize(
    "name,arities,stats",
    [
        ("chain", [], dict(chains_fused=1, nodes_fused=4)),
        ("wide_static", [2], dict(columns_dropped=6)),
        ("wide_expression", [3], dict(columns_dropped=3)),
        ("groupby_consumer", [3], dict(columns_dropped=0)),
        ("no_sinks", [3], dict(columns_dropped=0)),
        ("elision", [], dict(chains_fused=1, nodes_fused=3)),
    ],
)
def test_rewrites_happen(name, arities, stats, monkeypatch):
    shape, _ev, _log = _optimized(PORT, name, True, monkeypatch)
    assert shape["arities"] == arities
    for key, value in stats.items():
        assert shape["stats"][key] == value, key
    if name == "elision":
        assert shape["stats"]["exchanges_elided"] > 0 and shape["elided"]


def test_elision_count_is_the_shard_model_s(monkeypatch):
    """The optimizer's elision marks are ``shards.redundant_edges``: the counts agree,
    and equal the JAX package's analyzer count (PWA201)."""
    from pathway_tpu.analysis import analyze_scope

    sc_t, _ = _elision(PORT, [])
    edges = tshards.redundant_edges(sc_t)
    sc_j, _ = _elision(JAX, [])
    pwa201 = [f for f in analyze_scope(sc_j).findings if f.code == "PWA201"]
    assert [e[:3] for e in edges] == [e[:3] for e in jshards.redundant_edges(sc_j)]
    topt.optimize_scopes([sc_t])
    assert topt.optimizer_stats()["exchanges_elided"] == len(edges) == len(pwa201) > 0


@pytest.mark.parametrize("n,updates", [(600, True), (2000, False)], ids=["updates", "bulk"])
def test_chain_event_stream_parity(n, updates):
    _sc, tail_off, ev_off = _run_chain(PORT, False, n=n, updates=updates)
    sc, tail_on, ev_on = _run_chain(PORT, True, n=n, updates=updates)
    _sc, tail_j, ev_j = _run_chain(JAX, True, n=n, updates=updates)
    assert type(tail_on).__name__ == "FusedChainNode"
    assert ev_on == ev_off == ev_j
    assert {int(k): _canon(r) for k, r in tail_on.current.items()} == {
        int(k): _canon(r) for k, r in tail_off.current.items()
    }


def test_interior_nodes_are_inert():
    sc, tail, _ = _run_chain(PORT, True)
    interiors = [n for n in sc.nodes if getattr(n, "_pw_fused_into", None) is not None]
    assert len(interiors) == 3  # e1, f1, e2 fold into the e3 tail
    for node in interiors:
        assert node.consumers == [] and node.inputs == []
        assert not node.current  # never received a batch
        assert sc.nodes[node.index] is node
    assert not hasattr(tail, "_pw_fused_into")


def test_observed_node_is_never_fused():
    out = []
    for e in ENGINES:
        sc, _sess, tail = _chain_scope(e, [])
        mid = sc.nodes[2]  # the chain's head (after the error log and the session)
        mid._pw_observed = True
        e.g.Scheduler(sc, optimize=True)
        assert type(mid).__name__ == "ExpressionNode"
        assert not hasattr(mid, "_pw_fused_into")
        assert type(tail).__name__ == "FusedChainNode"  # the rest still fuses
        out.append((list(sc._pw_opt_fingerprint), e.opt.optimizer_stats()))
    assert out[0] == out[1]


@pytest.mark.parametrize("flag", ["0", "false", "off"])
def test_env_escape_hatch(monkeypatch, flag):
    monkeypatch.setenv("PATHWAY_TPU_OPTIMIZE", flag)
    _sc, tail, _ = _run_chain(PORT, True)
    assert type(tail).__name__ == "ExpressionNode"
    assert not topt.enabled()
    assert topt.optimizer_stats() == {
        "chains_fused": 0,
        "nodes_fused": 0,
        "columns_dropped": 0,
        "exchanges_elided": 0,
    }


def test_analyze_mode_turns_the_rewriter_off(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_ANALYZE", "1")
    _sc, tail, _ = _run_chain(PORT, True)
    assert type(tail).__name__ == "ExpressionNode"
    assert topt.optimizer_stats()["chains_fused"] == 0


def test_optimize_is_idempotent():
    sc, _sess, _tail = _chain_scope(PORT, [])
    first = topt.optimize_scopes([sc])
    second = topt.optimize_scopes([sc])  # cached: no second rewrite
    assert first == second
    assert sum(type(n).__name__ == "FusedChainNode" for n in sc.nodes) == 1
    tgraph.Scheduler(sc)  # the scheduler's own call is the same no-op
    assert sum(type(n).__name__ == "FusedChainNode" for n in sc.nodes) == 1


def test_scheduler_and_run_optimize_by_default():
    sc, _sess, tail = _chain_scope(PORT, [])
    tgraph.Scheduler(sc)
    assert type(tail).__name__ == "FusedChainNode"
    events: list = []
    sc2, [src] = _wide_static(PORT, events)
    sc2.run()
    assert src.arity == 2 and events
    sc3, [src3] = _wide_static(PORT, [])
    sc3.run(optimize=False)
    assert src3.arity == 8


def test_strict_run_names_the_analyzer_s_item():
    sc, _sess, _tail = _chain_scope(PORT, [])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        sc.run(strict=True)


@pytest.mark.parametrize(
    "module,name,item",
    [
        ("pathway_tpu_torch.analysis", "analyze_scope", "8"),
        ("pathway_tpu_torch.analysis", "check_strict", "8"),
        ("pathway_tpu_torch.analysis.runtime", "record_scope", "8"),
        ("pathway_tpu_torch.analysis.runtime", "intercept", "8"),
        ("pathway_tpu_torch.analysis.usage", "run_pass", "8"),
        ("pathway_tpu_torch.analysis.shards", "run_pass", "8"),
        ("pathway_tpu_torch.engine.sharded", "ShardedScheduler", "14"),
        ("pathway_tpu_torch.engine.device_residency", "DeviceResidentColumns", "14"),
        ("pathway_tpu_torch.engine.distributed", "DistributedScheduler", "14"),
        ("pathway_tpu_torch.engine.distributed", "MeshTransport", "14"),
        ("pathway_tpu_torch.engine.supervisor", "MeshSupervisor", "14"),
        ("pathway_tpu_torch.internals.runner", "DistributedGraphRunner", "14"),
        ("pathway_tpu_torch.engine.persistence", "reshard_process_snapshots", "14"),
    ],
)
def test_unported_names_raise_naming_their_item(module, name, item):
    mod = importlib.import_module(module)
    if (module, name) in PORTED_SINCE:
        # ported since: the module defines the name, which raises no more
        assert getattr(mod, name) is vars(mod)[name]
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 item {item}\\b"):
        getattr(mod, name)


#: names of the list above that a later slice ported
PORTED_SINCE = {
    ("pathway_tpu_torch.engine.sharded", "ShardedScheduler"),
    ("pathway_tpu_torch.engine.distributed", "DistributedScheduler"),
    ("pathway_tpu_torch.engine.distributed", "MeshTransport"),
    ("pathway_tpu_torch.engine.supervisor", "MeshSupervisor"),
    ("pathway_tpu_torch.internals.runner", "DistributedGraphRunner"),
    ("pathway_tpu_torch.engine.persistence", "reshard_process_snapshots"),
}


def test_partition_rule_matches_the_reference_on_every_node():
    from pathway_tpu.engine.sharded import partition_rule as jrule
    from pathway_tpu_torch.engine.sharded import partition_rule as trule

    for build in (_elision, _wide_expression, _groupby_consumer):
        sc_t, _ = build(PORT, [])
        sc_j, _ = build(JAX, [])
        for nt, nj in zip(sc_t.nodes, sc_j.nodes):
            for port in range(max(1, len(nt.inputs))):
                assert trule(nt, port) == jrule(nj, port)
            assert tshards.out_specs(nt) == jshards.out_specs(nj)


# -- the Table-API corpus -------------------------------------------------------------


def _corpus(pw, name):
    if name == "groupby":
        t = pw.debug.table_from_rows(
            pw.schema_from_types(k=str, v=int), [(f"k{i % 5}", i) for i in range(60)]
        )
        sel = t.select(k=t.k, v=t.v * 2 + 1)
        flt = sel.filter(sel.v > 7)
        return flt.groupby(flt.k).reduce(
            k=flt.k, total=pw.reducers.sum(flt.v), cnt=pw.reducers.count()
        )
    if name == "join":
        orders = pw.debug.table_from_rows(
            pw.schema_from_types(oid=int, cust=str, amount=float),
            [(i, f"c{i % 4}", float(i) * 1.5) for i in range(40)],
        )
        custs = pw.debug.table_from_rows(
            pw.schema_from_types(name=str, region=str),
            [(f"c{i}", f"r{i % 2}") for i in range(4)],
        )
        j = orders.join(custs, orders.cust == custs.name)
        return j.select(cust=orders.cust, region=custs.region, amount=orders.amount)
    if name == "temporal":
        tmp = importlib.import_module(pw.__name__ + ".stdlib.temporal")
        t = pw.debug.table_from_rows(
            pw.schema_from_types(t=int, k=str, v=int),
            [(i % 23, f"k{i % 3}", i) for i in range(50)],
        )
        win = t.windowby(t.t, window=tmp.tumbling(duration=10), instance=t.k)
        return win.reduce(
            instance=pw.this["_pw_instance"],
            start=pw.this["_pw_window_start"],
            total=pw.reducers.sum(pw.this.v),
        )
    if name == "iterate":
        t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(5,), (16,), (7,), (1,)])

        def body(vals):
            return {
                "vals": vals.select(
                    x=pw.apply(
                        lambda v: v if v == 1 else (v // 2 if v % 2 == 0 else 3 * v + 1),
                        vals.x,
                    )
                )
            }

        return pw.iterate(body, vals=t).vals
    raise AssertionError(name)


CORPUS = ["groupby", "join", "temporal", "iterate"]


def _capture(pw, name, optimize, monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_OPTIMIZE", "1" if optimize else "0")
    runner_mod = importlib.import_module(pw.__name__ + ".internals.runner")
    G = importlib.import_module(pw.__name__ + ".internals.parse_graph").G
    G.clear()
    try:
        runner = runner_mod.GraphRunner()
        (state,) = runner.capture(_corpus(pw, name))
        opt = importlib.import_module(pw.__name__ + ".optimize")
        shape = (list(getattr(runner.scope, "_pw_opt_fingerprint", [])), opt.optimizer_stats())
    finally:
        G.clear()
    return {int(k): _canon(r) for k, r in state.items()}, shape


@pytest.mark.parametrize("name", CORPUS)
def test_corpus_outputs_and_rewrites_match_the_reference(name, monkeypatch):
    on, shape_on = _capture(tpw, name, True, monkeypatch)
    off, _ = _capture(tpw, name, False, monkeypatch)
    want, shape_j = _capture(jpw, name, True, monkeypatch)
    want_off, _ = _capture(jpw, name, False, monkeypatch)
    assert on == off == want == want_off
    assert on
    assert shape_on == shape_j


@pytest.mark.parametrize("name", CORPUS)
def test_corpus_rewrite_matches_the_reference_with_device_ops_forced(name, monkeypatch):
    """Under ``=1`` the placement pass adds its eligible and placed counts to the
    stats; only the rewrite is compared (the JAX package's forced operators cannot run
    here). The port lowers a join's two sides in another order than the JAX package
    (each side's key projection right after its source, and no id column), so node
    positions are compared only through the fingerprint, which names none here."""
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "1")
    out = []
    for pw in (tpw, jpw):
        runner = importlib.import_module(pw.__name__ + ".internals.runner").GraphRunner()
        runner.build(_corpus(pw, name))
        opt = importlib.import_module(pw.__name__ + ".optimize")
        opt.optimize_scopes([runner.scope])
        out.append((list(runner.scope._pw_opt_fingerprint), opt.optimizer_stats()))
        importlib.import_module(pw.__name__ + ".internals.parse_graph").G.clear()
    assert out[0] == out[1]
    if name in ("groupby", "join", "temporal"):
        assert out[0][1]["device_eligible"] > 0
