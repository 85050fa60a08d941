"""The port's relational engine nodes against the JAX package's, on the same seeded
rows: inner, left, right and outer joins (single and multi-column keys, -0.0 and NaN
keys, an empty side), the groupby with every ``ReducerKind`` (retractions that empty
groups included), filter, concat, reindex, flatten, ix and update rows and cells.

Each case builds the same graph in both engines (``pathway_tpu.engine.graph`` under
``JAX_PLATFORMS=cpu`` with its device operators off, ``pathway_tpu_torch.engine.graph``
with its operators on the CPU) and feeds both the same row objects over several
commits: inserts, then retractions and re-inserts. The nodes' output states must be
equal bit for bit (floats through their int64 views), and so must the error logs.
The port runs each case twice: with its device operators (``device`` route: the
ordered segment sum's plain version and the torch matcher on CPU tensors) and with
``PATHWAY_TPU_DEVICE_OPS=0`` (``host`` route)."""

from __future__ import annotations

import math

import numpy as np
import pytest

from pathway_tpu.engine import expression as jex
from pathway_tpu.engine import graph as jgraph
from pathway_tpu.engine import reducers as jred
from pathway_tpu.engine.value import ref_scalar as jref
from pathway_tpu_torch.engine import device_ops as dops
from pathway_tpu_torch.engine import expression as tex
from pathway_tpu_torch.engine import graph as tgraph
from pathway_tpu_torch.engine import reducers as tred
from pathway_tpu_torch.engine.value import ref_scalar as tref

ROUTES = ["device", "host"]
N = 400  # above the engine's VECTOR_THRESHOLD (256): the columnar paths engage


@pytest.fixture(autouse=True)
def _cpu_operators():
    dops.configure(device="cpu")
    yield
    dops.configure()


class _Engine:
    """One engine's modules, under one name, so a case builds the same graph in
    both."""

    def __init__(self, graph, ex, red, ref) -> None:
        self.g, self.ex, self.red, self.ref = graph, ex, red, ref

    def reducer(self, kind: str, **options):
        return self.red.make_reducer(self.red.ReducerKind[kind], **options)


JAX = _Engine(jgraph, jex, jred, jref)
PORT = _Engine(tgraph, tex, tred, tref)


def _canon(v):
    if isinstance(v, float):
        return ("f", np.float64(v).view(np.int64).item())
    if isinstance(v, np.ndarray):
        return ("nd", str(v.dtype), tuple(_canon(x) for x in v.tolist()))
    if isinstance(v, (tuple, list)):
        return tuple(_canon(x) for x in v)
    if isinstance(v, int) and not isinstance(v, bool):
        return int(v)  # Pointer -> int
    return v


def _state(node) -> dict:
    return {int(k): _canon(row) for k, row in node.current.items()}


def _run(engine: _Engine, build, feed, monkeypatch, route: str):
    monkeypatch.setenv(
        "PATHWAY_TPU_DEVICE_OPS", "1" if engine is PORT and route == "device" else "0"
    )
    scope = engine.g.Scope()
    out, sessions = build(engine, scope)
    if engine is JAX:
        sched = engine.g.Scheduler(scope, optimize=False)
    else:
        sched = engine.g.Scheduler(scope)
    for commit in feed:
        for port, op, key, row in commit:
            if op > 0:
                sessions[port].insert(engine.ref(*key), row)
            else:
                sessions[port].remove(engine.ref(*key), row)
        sched.commit()
    errors = sorted(r[0] for r in scope.error_log_default.current.values())
    return _state(out), errors, out


def _compare(build, feed, monkeypatch, route):
    ref_state, ref_errors, _ = _run(JAX, build, feed, monkeypatch, route)
    got_state, got_errors, node = _run(PORT, build, feed, monkeypatch, route)
    assert got_state == ref_state
    assert got_errors == ref_errors
    return node, ref_state


def _churn(rows: dict, rng, port: int = 0, frac: float = 0.25):
    """A commit that retracts a quarter of ``rows`` and inserts changed rows for
    half of those (same keys): -1/+1 diffs."""
    keys = sorted(rows)
    pick = [keys[i] for i in rng.choice(len(keys), int(len(keys) * frac), replace=False)]
    commit = []
    for i, key in enumerate(sorted(pick)):
        commit.append((port, -1, key, rows[key]))
        if i % 2 == 0:
            old = rows[key]
            rows[key] = (old[0], *old[1:-1], old[-1] + 1 if isinstance(old[-1], int) else old[-1])
            commit.append((port, +1, key, rows[key]))
        else:
            del rows[key]
    return commit


# -- joins ---------------------------------------------------------------------------


def _join_key_values(case: str, rng, n: int, side: str):
    if case in ("single", "empty_side"):
        return [(int(x),) for x in rng.integers(0, 50, n)]
    if case == "multi":
        return [(int(a), int(b)) for a, b in zip(rng.integers(0, 7, n), rng.integers(0, 5, n))]
    if case == "negzero":
        vals = rng.integers(-3, 4, n).astype(float)
        return [(-0.0 if side == "r" and x == 0 else float(x),) for x in vals]
    if case == "nan":
        vals = rng.integers(0, 6, n).astype(float)
        return [((math.nan if x == 5 else float(x)),) for x in vals]
    raise KeyError(case)


JOIN_KEYS = ["single", "multi", "negzero", "nan", "empty_side"]
JOIN_KINDS = ["inner", "left", "right", "outer"]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("keys", JOIN_KEYS)
@pytest.mark.parametrize("kind", JOIN_KINDS)
def test_join_matches_the_reference(kind, keys, route, monkeypatch):
    rng = np.random.default_rng(JOIN_KINDS.index(kind) * 10 + JOIN_KEYS.index(keys))
    nk = 2 if keys == "multi" else 1
    n_left, n_right = N, 0 if keys == "empty_side" else 60
    left = {
        ("l", i): (*jk, float(rng.standard_normal()), f"l{i}", i)
        for i, jk in enumerate(_join_key_values(keys, rng, n_left, "l"))
    }
    right = {
        ("r", i): (*jk, f"r{i}", i)
        for i, jk in enumerate(_join_key_values(keys, rng, n_right, "r"))
    }
    feed = [[(0, 1, k, r) for k, r in left.items()] + [(1, 1, k, r) for k, r in right.items()]]
    feed.append(_churn(left, rng, 0) + (_churn(right, rng, 1) if right else []))
    more = {("l2", i): (*jk, 0.5, "x", i) for i, jk in enumerate(_join_key_values(keys, rng, 40, "l"))}
    feed.append([(0, 1, k, r) for k, r in more.items()])

    def build(e, scope):
        ls = scope.input_session(nk + 3)
        rs = scope.input_session(nk + 2)
        out = scope.join_tables(ls, rs, list(range(nk)), list(range(nk)), kind=kind)
        return out, [ls, rs]

    node, state = _compare(build, feed, monkeypatch, route)
    assert state or keys == "empty_side" and kind in ("inner", "right")
    if route == "host" or kind != "inner":
        assert node.routes["device"] == 0
    elif keys in ("single", "multi", "negzero"):
        assert node.routes["device"] > 0  # the matcher took the inserts' batch


def test_join_custom_id_and_id_from_left(monkeypatch):
    """``id_spec`` result ids (a side's pointer column), duplicates poisoned through
    the error log, as in the reference."""
    rng = np.random.default_rng(4)
    left = {("l", i): (int(k), i) for i, k in enumerate(rng.integers(0, 10, 50))}
    right = {("r", i): (i % 10, f"r{i}") for i in range(12)}
    feed = [[(0, 1, k, r) for k, r in left.items()] + [(1, 1, k, r) for k, r in right.items()]]
    feed.append(_churn(left, rng, 0))

    for kind, spec in (("left", ("left", None)), ("inner", ("right", None))):

        def build(e, scope, kind=kind, spec=spec):
            ls, rs = scope.input_session(2), scope.input_session(2)
            return scope.join_tables(ls, rs, [0], [0], kind=kind, id_spec=spec), [ls, rs]

        _compare(build, feed, monkeypatch, "device")


# -- groupby -------------------------------------------------------------------------

#: kind -> (options, argument columns of the (k, v, s, i) rows)
REDUCERS = {
    "COUNT": ({}, []),
    "SUM": ({}, [1]),
    "MIN": ({}, [1]),
    "MAX": ({}, [2]),
    "ARG_MIN": ({}, [1, 3]),
    "ARG_MAX": ({}, [1, 3]),
    "UNIQUE": ({}, [0]),
    "ANY": ({}, [2]),
    "SORTED_TUPLE": ({"skip_nones": True}, [2]),
    "TUPLE": ({}, [3]),
    "EARLIEST": ({}, [2]),
    "LATEST": ({}, [2]),
    "STATEFUL": ({"combine": lambda entries: sum(a[0] * c for a, c in entries)}, [3]),
    "COUNT_DISTINCT": ({}, [2]),
}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kind", sorted(REDUCERS))
def test_groupby_reducer_matches_the_reference(kind, route, monkeypatch):
    rng = np.random.default_rng(sorted(REDUCERS).index(kind))
    rows = {
        (i,): (int(rng.integers(0, 9)), float(rng.integers(-20, 20)) * 0.25, f"s{rng.integers(0, 5)}", i)
        for i in range(N)
    }
    feed = [[(0, 1, k, r) for k, r in rows.items()]]
    feed.append(_churn(rows, rng))
    # retract every row of group 3: the group disappears from the output
    feed.append([(0, -1, k, rows.pop(k)) for k in sorted(rows) if rows[k][0] == 3])
    feed.append([(0, 1, ("new", i), (3, 1.0, "z", 1000 + i)) for i in range(3)])
    opts, cols = REDUCERS[kind]

    def build(e, scope):
        sess = scope.input_session(4)
        reducers = [(e.reducer(kind, **opts), cols), (e.reducer("COUNT"), [])]
        return scope.group_by_table(sess, [0], reducers), [sess]

    node, state = _compare(build, feed, monkeypatch, route)
    assert len(state) == 9
    if kind in ("COUNT", "SUM"):
        assert node.routes["rows"] == 0
        assert node.routes["device" if route == "device" else "host"] == len(feed)


def test_groupby_ndarray_reducer_matches_the_reference(monkeypatch):
    """The NDARRAY reducer's groups on their first commit. A later change of such a
    group raises in both engines (the row path compares old and new rows holding
    arrays with ``!=``, pathway_tpu/engine/graph.py:2283); the port keeps the
    reference's behaviour, and the second half of this test pins it."""
    rng = np.random.default_rng(21)
    rows = {(i,): (int(rng.integers(0, 9)), 0.0, "s", i) for i in range(N)}
    feed = [[(0, 1, k, r) for k, r in rows.items()]]

    def build(e, scope):
        sess = scope.input_session(4)
        return scope.group_by_table(sess, [0], [(e.reducer("NDARRAY"), [3])]), [sess]

    _compare(build, feed, monkeypatch, "device")
    feed.append(_churn(rows, rng))
    for e in (JAX, PORT):
        with pytest.raises(ValueError):
            _run(e, build, feed, monkeypatch, "device")


@pytest.mark.parametrize("route", ROUTES)
def test_groupby_multi_column_and_int_sums(route, monkeypatch):
    """Two by-columns (str, int), an int and a float sum and a count, with the
    columnar state held over many commits."""
    rng = np.random.default_rng(9)
    rows = {(i,): (f"w{rng.integers(0, 6)}", int(rng.integers(0, 4)), int(rng.integers(-99, 99)), float(rng.standard_normal())) for i in range(N)}
    feed = [[(0, 1, k, r) for k, r in rows.items()]]
    for _ in range(4):
        feed.append(_churn(rows, rng, frac=0.1))

    def build(e, scope):
        sess = scope.input_session(4)
        reducers = [(e.reducer("SUM"), [2]), (e.reducer("SUM"), [3]), (e.reducer("COUNT"), [])]
        return scope.group_by_table(sess, [0, 1], reducers), [sess]

    _compare(build, feed, monkeypatch, route)


# -- the other nodes -----------------------------------------------------------------


def _rows(n, rng):
    return {(i,): (int(rng.integers(-5, 5)), float(rng.standard_normal()), i) for i in range(n)}


def _feed_one(rows, rng):
    feed = [[(0, 1, k, r) for k, r in rows.items()]]
    feed.append(_churn(rows, rng))
    return feed


def _filter_build(e, scope):
    sess = scope.input_session(3)
    cond = scope.expression_table(
        sess,
        [e.ex.ColumnRef(0), e.ex.ColumnRef(1), e.ex.ColumnRef(2),
         e.ex.Binary(">", e.ex.ColumnRef(1), e.ex.Const(0.0))],
    )
    return scope.filter_table(cond, 3), [sess]


def _concat_build(e, scope):
    a, b = scope.input_session(3), scope.input_session(3)
    return scope.concat_tables([a, b]), [a, b]


def _reindex_build(e, scope):
    sess = scope.input_session(3)
    pre = scope.expression_table(
        sess,
        [e.ex.ColumnRef(0), e.ex.ColumnRef(1), e.ex.PointerFrom([e.ex.ColumnRef(2)], None)],
    )
    return scope.reindex_table(pre, 2), [sess]


def _flatten_build(e, scope):
    sess = scope.input_session(3)
    pre = scope.expression_table(
        sess,
        [e.ex.ColumnRef(0), e.ex.MakeTuple([e.ex.ColumnRef(1), e.ex.ColumnRef(2)]), e.ex.ColumnRef(2)],
    )
    return scope.flatten_table(pre, 1, with_origin=True), [sess]


def _ix_build(e, scope):
    keys, source = scope.input_session(3), scope.input_session(3)
    ptr = scope.expression_table(keys, [e.ex.PointerFrom([e.ex.ColumnRef(0)], None)])
    return scope.ix_table(ptr, source, 0, optional=True, strict=False), [keys, source]


def _update_rows_build(e, scope):
    a, b = scope.input_session(3), scope.input_session(3)
    return scope.update_rows_table(a, b), [a, b]


def _update_cells_build(e, scope):
    a, b = scope.input_session(3), scope.input_session(1)
    return scope.update_cells_table(a, b, [-1, 0, -1]), [a, b]


def _two_inputs_feed(rng, overlap: bool, second_arity: int = 3):
    a = _rows(N, rng)
    b = {
        ((i,) if overlap else ("b", i)): (int(rng.integers(-5, 5)), float(rng.standard_normal()), i)[:second_arity]
        for i in range(0, N, 3)
    }
    feed = [[(0, 1, k, r) for k, r in a.items()] + [(1, 1, k, r) for k, r in b.items()]]
    feed.append(_churn(a, rng, 0) + _churn(b, rng, 1))
    return feed


def _ix_feed(rng):
    # keys rows point (through ref_scalar of column 0) at source rows keyed (j,)
    keys = {("k", i): (int(rng.integers(0, 60)), 0.0, i) for i in range(N)}
    source = {(j,): (j, float(j) * 0.5, j) for j in range(50)}  # 50..59 miss
    feed = [[(0, 1, k, r) for k, r in keys.items()] + [(1, 1, k, r) for k, r in source.items()]]
    feed.append(_churn(keys, rng, 0) + _churn(source, rng, 1))
    return feed


NODE_CASES = {
    "filter": (_filter_build, lambda rng: _feed_one(_rows(N, rng), rng)),
    "concat": (_concat_build, lambda rng: _two_inputs_feed(rng, overlap=False)),
    "concat_duplicate_keys": (_concat_build, lambda rng: _two_inputs_feed(rng, overlap=True)),
    "reindex": (_reindex_build, lambda rng: _feed_one(_rows(N, rng), rng)),
    "flatten": (_flatten_build, lambda rng: _feed_one(_rows(N, rng), rng)),
    "ix": (_ix_build, _ix_feed),
    "update_rows": (_update_rows_build, lambda rng: _two_inputs_feed(rng, overlap=True)),
    "update_cells": (_update_cells_build, lambda rng: _two_inputs_feed(rng, overlap=True, second_arity=1)),
}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", sorted(NODE_CASES))
def test_node_matches_the_reference(case, route, monkeypatch):
    build, make_feed = NODE_CASES[case]
    feed = make_feed(np.random.default_rng(sorted(NODE_CASES).index(case)))
    _node, state = _compare(build, feed, monkeypatch, route)
    assert state


def test_static_source_and_run_static(monkeypatch):
    """A static table through ``Scheduler.run_static``: one commit at time 0."""
    seen = {}
    for e in (JAX, PORT):
        scope = e.g.Scope()
        src = scope.static_table([(e.ref(i), (i, f"v{i}")) for i in range(5)], 2)
        log = []
        scope.subscribe_table(src, on_change=lambda k, r, t, d, log=log: log.append((int(k), r, t, d)))
        sched = e.g.Scheduler(scope, optimize=False) if e is JAX else e.g.Scheduler(scope)
        sched.run_static()
        seen[e is PORT] = (sorted(log), sched.time)
    assert seen[True] == seen[False]
