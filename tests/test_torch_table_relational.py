"""The Table API's relational operations in the port against the JAX package, through
its entry points: ``pw.debug`` static tables and ``pw.run`` programs over
``pw.io.python``, compared on column names, row ids and values (floats through their
int64 views). The port's device operators run on the CPU (``device_ops.configure(
device="cpu")``); the JAX package runs with its device operators off, as it does on a
CPU."""

from __future__ import annotations

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch.engine import device_ops
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.internals.runner import GraphRunner


@pytest.fixture(autouse=True)
def _cpu_operators(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "1")
    device_ops.configure(device="cpu")
    yield
    device_ops.configure()
    TG.clear()
    JG.clear()


def _canon(v):
    if isinstance(v, float):
        return ("f", np.float64(v).view(np.int64).item())
    if isinstance(v, tuple):
        return tuple(_canon(x) for x in v)
    if isinstance(v, int) and not isinstance(v, bool):
        return int(v)
    return v


def _dicts(pw, table) -> tuple[list, dict]:
    data, names = pw.debug.table_to_dicts(table)
    return names, {int(k): {c: _canon(x) for c, x in row.items()} for k, row in data.items()}


def _both(monkeypatch, program):
    """``program(pw)`` -> a table, in the JAX package (device operators off) and in
    the port; their ``table_to_dicts`` must be equal."""
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")
    ref = _dicts(jpw, program(jpw))
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "1")
    got = _dicts(tpw, program(tpw))
    assert got == ref
    return got


ROWS = """
   | k | v    | s   | n | owner
1  | 1 | 1.5  | ab  | 1 | 2
2  | 1 | 2.0  | c   | 2 | 2
3  | 2 | 4.0  | de  | 3 | 1
4  | 3 | -1.0 | fgh | 4 | 1
5  | 2 | 0.5  | i   | 5 | 3
6  | 3 | 0.25 | j   | 6 | 9
"""


def _t(pw):
    return pw.debug.table_from_markdown(ROWS)


def _by_id(pw):
    t = _t(pw)
    p = t.select(p=t.pointer_from(t.k), n=t.n)
    return p.groupby(id=p.p).reduce(c=pw.reducers.count(), s=pw.reducers.sum(pw.this.n))


PROGRAMS = {
    "groupby_by_id": lambda pw: _by_id(pw),
    "groupby_instance": lambda pw: _t(pw).groupby(pw.this.k, instance=pw.this.owner).reduce(
        pw.this.k, pw.this.owner, s=pw.reducers.sum(pw.this.n)
    ),
    "reducer_expressions": lambda pw: _t(pw).groupby(pw.this.k).reduce(
        pw.this.k,
        twice=pw.reducers.sum(pw.this.v) * 2,
        avg=pw.reducers.avg(pw.this.v),
        first=pw.reducers.earliest(pw.this.s),
        st=pw.reducers.sorted_tuple(pw.this.s),
        tu=pw.reducers.tuple(pw.this.n),
        am=pw.reducers.argmax(pw.this.v),
        u=pw.reducers.unique(pw.this.k),
        cd=pw.reducers.count_distinct(pw.this.owner),
        custom=pw.reducers.stateful_single(lambda vals: max(vals) - min(vals), pw.this.n),
    ),
    "join_id_from_left": lambda pw: _t(pw).join_left(
        _t(pw).groupby(pw.this.k).reduce(pw.this.k, c=pw.reducers.count()),
        pw.left.k == pw.right.k,
        id=pw.left.id,
    ).select(pw.left.s, c=pw.right.c),
    "join_multi_key_and_star": lambda pw: _t(pw).join(
        _t(pw).select(kk=pw.this.k, oo=pw.this.owner, m=pw.this.n * 10),
        pw.left.k == pw.right.kk,
        pw.left.owner == pw.right.oo,
    ).select(*pw.left, m=pw.right.m),
    "this_ix_ref": lambda pw: _t(pw)
    .with_id_from(pw.this.n)
    .select(pw.this.s, owner_s=pw.this.ix_ref(pw.this.owner, optional=True).s),
    "filter_then_concat_reindex": lambda pw: _t(pw)
    .filter(pw.this.v > 0.4)
    .concat_reindex(_t(pw).filter(pw.this.k == 3)),
    "flatten_origin": lambda pw: _t(pw).flatten(pw.this.s, origin_id="origin"),
    "update_cells_operator": lambda pw: _t(pw) << _t(pw).filter(pw.this.k == 2).select(
        n=pw.this.n + 100
    ),
    "intersect_many": lambda pw: _t(pw).intersect(
        _t(pw).filter(pw.this.k > 1), _t(pw).filter(pw.this.v > 0.3)
    ),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_table_program_matches_the_reference(name, monkeypatch):
    names, rows = _both(monkeypatch, PROGRAMS[name])
    assert rows and names


def test_universe_relations_follow_the_reference():
    from pathway_tpu_torch.internals.universe import solver

    t = _t(tpw)
    a, b = t.filter(tpw.this.k > 1), t.filter(tpw.this.v > 0.3)
    c = a.concat(t.filter(tpw.this.k == 1))
    assert solver.query_is_subset(a._universe, c._universe)
    both = a.intersect(b)
    assert solver.query_is_subset(both._universe, a._universe)
    assert solver.query_is_subset(both._universe, b._universe)
    diff = t.difference(a)
    assert solver.query_is_subset(diff._universe, t._universe)
    assert not solver.query_is_subset(diff._universe, a._universe)
    other = t.select(x=tpw.this.v).with_universe_of(a)
    assert solver.query_are_equal(other._universe, a._universe)
    assert t.update_cells(a.select(tpw.this.v))._universe is t._universe


def test_reducer_outside_reduce_raises():
    t = _t(tpw)
    with pytest.raises(ValueError, match="only allowed inside .reduce"):
        GraphRunner().capture(t.select(x=tpw.reducers.count()))


def test_debug_helpers_match_the_reference(capsys, monkeypatch):
    schema = {"a": int, "b": str}

    def rows(pw):
        return pw.debug.table_from_rows(pw.schema_from_types(**schema), [(1, "x"), (2, "y")])

    _both(monkeypatch, rows)
    out = {}
    for pw in (jpw, tpw):
        pw.debug.compute_and_print(_t(pw).select(pw.this.k, pw.this.s))
        out[pw is tpw] = capsys.readouterr().out
    assert out[True] == out[False]
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame({"x": [1, 2, 3], "y": [0.5, 1.5, 2.5]})
    _both(monkeypatch, lambda pw: pw.debug.table_from_pandas(df))
    frames = [pw.debug.table_to_pandas(_t(pw)) for pw in (jpw, tpw)]
    assert frames[0].equals(frames[1])


def _stream_program(pw, n_rows: int, n_dim: int, captured: dict):
    """The shape of the ``relational_engine`` phase of chip_smoke.py at a small size:
    a python connector into a groupby, a left join with a static dimension table, a
    filter, and a concat_reindex with a second stream joined inner to the dimension
    table; the subscriber keeps the final state."""

    class Feed(pw.io.python.ConnectorSubject):
        def __init__(self, rows) -> None:
            super().__init__()
            self.rows = rows

        def run(self) -> None:
            for k, v in self.rows:
                self.next(k=k, v=v)

    rng = np.random.default_rng(5)
    keys = rng.integers(0, n_dim + 4, n_rows).tolist()
    vals = (rng.integers(-100, 100, n_rows) * 0.125).tolist()
    schema = pw.schema_from_types(k=int, v=float)
    a = pw.io.python.read(Feed(list(zip(keys, vals))), schema=schema, autocommit_duration_ms=5)
    b = pw.io.python.read(Feed(list(zip(keys[::3], vals[::3]))), schema=schema, autocommit_duration_ms=5)
    dim = pw.debug.table_from_rows(
        pw.schema_from_types(k=int, name=str), [(i, f"d{i}") for i in range(n_dim)]
    )
    g = a.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v), c=pw.reducers.count())
    j = g.join_left(dim, pw.left.k == pw.right.k).select(
        pw.left.k, pw.left.s, pw.left.c, name=pw.right.name
    )
    f = j.filter(pw.this.c > 1)
    bj = b.join_inner(dim, pw.left.k == pw.right.k).select(
        pw.left.k, s=pw.left.v, c=1, name=pw.right.name
    )
    out = f.concat_reindex(bj)

    def on_change(key, row, time, is_addition):
        if is_addition:
            captured[int(key)] = {c: _canon(x) for c, x in row.items()}
        else:
            captured.pop(int(key), None)

    pw.io.subscribe(out, on_change=on_change)
    return g, bj


def test_streaming_program_matches_the_reference_and_takes_the_device_route(monkeypatch):
    ref: dict = {}
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")
    _stream_program(jpw, 900, 12, ref)
    jpw.run()
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "1")
    got: dict = {}
    routes = []
    original = tpw.internals.runner.GraphRunner.run

    def run_and_keep(self):
        sched = original(self)
        routes.extend(getattr(n, "routes", None) for n in self.scope.nodes)
        return sched

    monkeypatch.setattr(tpw.internals.runner.GraphRunner, "run", run_and_keep)
    _stream_program(tpw, 900, 12, got)
    tpw.run()
    assert got == ref and len(got) > 12
    routes = [r for r in routes if r is not None]
    assert any(r["device"] > 0 and r["host"] == 0 for r in routes)  # groupby, inner join
    assert all(r["host"] == 0 for r in routes)
