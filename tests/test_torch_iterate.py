"""``pw.iterate`` and the graph algorithms over it in the port against the JAX package:
the fixed point, ``iteration_limit``, several fed-back tables and a result that is not
fed back, PageRank, Bellman-Ford and shortest paths on seeded graphs, bit for bit.

Streamed inputs: an iterated table fed by commits of insertions and retractions is held
to the JAX package's at every commit (deltas and state). PageRank over a streamed edge
table is held, commit by commit, to the JAX package's PageRank over a static table of
the same edges: the JAX package rebuilds the body's other tables inside every round,
where a connector's table is empty, so its own streamed PageRank emits nothing. The
port's device operators run on the CPU; the JAX package's are off."""

from __future__ import annotations

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu.stdlib import graphs as jgraphs
from pathway_tpu_torch.engine import device_ops
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.stdlib import graphs as tgraphs


@pytest.fixture(autouse=True)
def _cpu_operators():
    device_ops.configure(device="cpu")
    yield
    device_ops.configure()
    TG.clear()
    JG.clear()


def _canon(v):
    if isinstance(v, float):
        return ("f", np.float64(v).view(np.int64).item())
    if v is not None and type(v).__name__ == "Pointer":
        return ("ptr", int(v))
    return v


def _dicts(pw, monkeypatch, table) -> tuple[list, dict]:
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "1" if pw is tpw else "0")
    data, names = pw.debug.table_to_dicts(table)
    return names, {int(k): {c: _canon(x) for c, x in r.items()} for k, r in data.items()}


def _both(monkeypatch, program):
    got = _dicts(tpw, monkeypatch, program(tpw))
    want = _dicts(jpw, monkeypatch, program(jpw))
    assert got == want
    return got


def _collatz(pw):
    t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(5,), (16,), (1,), (27,)])

    def body(vals):
        return {"vals": vals.select(x=pw.apply(
            lambda v: v if v == 1 else (v // 2 if v % 2 == 0 else 3 * v + 1), vals.x))}

    return pw.iterate(body, vals=t).vals


def _limited(pw):
    t = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(0,), (10,)])
    return pw.iterate(lambda vals: {"vals": vals.select(x=vals.x + 1)},
                      iteration_limit=4, vals=t).vals


def _two_tables(pw, name):
    """Two fed-back tables that read each other, and a result that is not fed back."""
    a = pw.debug.table_from_rows(pw.schema_from_types(k=int, x=int), [(1, 40), (2, 7), (3, 64)])
    b = pw.debug.table_from_rows(pw.schema_from_types(k=int, y=int), [(1, 0), (2, 0), (3, 0)])

    def body(a, b):
        na = a.select(k=a.k, x=pw.if_else(a.x > 1, a.x // 2, a.x))
        j = b.join(a, b.k == a.k, id=b.id).select(k=b.k, y=b.y + pw.if_else(a.x > 1, 1, 0))
        steps = b.reduce(total=pw.reducers.sum(b.y))
        return {"a": na, "b": j, "steps": steps}

    return getattr(pw.iterate(body, a=a, b=b), name)


def _edges(pw, n_vertices: int, n_edges: int, seed: int, dist: bool = False):
    rng = np.random.default_rng(seed)
    us = rng.integers(0, n_vertices, n_edges)
    vs = (us + 1 + rng.integers(0, n_vertices - 1, n_edges)) % n_vertices
    if dist:
        ds = rng.integers(1, 9, n_edges) * 0.5
        return pw.debug.table_from_rows(
            pw.schema_from_types(u=int, v=int, dist=float),
            [(int(u), int(v), float(d)) for u, v, d in zip(us, vs, ds)])
    return pw.debug.table_from_rows(
        pw.schema_from_types(u=int, v=int), [(int(u), int(v)) for u, v in zip(us, vs)])


PROGRAMS = {
    "collatz_fixed_point": _collatz,
    "iteration_limit": _limited,
    "two_fed_back_tables_a": lambda pw: _two_tables(pw, "a"),
    "two_fed_back_tables_b": lambda pw: _two_tables(pw, "b"),
    "result_not_fed_back": lambda pw: _two_tables(pw, "steps"),
    "pagerank": lambda pw: (tgraphs if pw is tpw else jgraphs).pagerank(
        _edges(pw, 40, 160, 3), iteration_limit=12),
    "pagerank_to_convergence": lambda pw: (tgraphs if pw is tpw else jgraphs).pagerank(
        _edges(pw, 12, 30, 5), iteration_limit=200),
    "bellman_ford": lambda pw: (tgraphs if pw is tpw else jgraphs).bellman_ford(
        _edges(pw, 20, 40, 7).groupby(pw.this.u).reduce(
            v=pw.this.u, is_source=pw.this.u == 0),
        _edges(pw, 20, 60, 7, dist=True)),
    "shortest_paths": lambda pw: (tgraphs if pw is tpw else jgraphs).shortest_paths(
        _edges(pw, 30, 70, 9, dist=True), 4),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_matches_the_jax_package(monkeypatch, name):
    names, rows = _both(monkeypatch, PROGRAMS[name])
    assert rows, "the program produced no row"


def test_fixed_points_are_the_expected_ones(monkeypatch):
    _n, rows = _dicts(tpw, monkeypatch, _collatz(tpw))
    assert sorted(r["x"] for r in rows.values()) == [1, 1, 1, 1]
    _n, rows = _dicts(tpw, monkeypatch, _limited(tpw))
    assert sorted(r["x"] for r in rows.values()) == [4, 14]
    _n, rows = _dicts(tpw, monkeypatch, _two_tables(tpw, "steps"))
    assert [r["total"] for r in rows.values()] == [5 + 2 + 6]


def test_a_result_read_by_another_result_keeps_its_rows(monkeypatch):
    """The port keeps every result's state. The JAX package's inner run loses the state
    of a result that another result reads (here ``b``, read by ``steps``): its ``b`` and
    ``steps`` come out empty."""

    def program(pw):
        a = pw.debug.table_from_rows(pw.schema_from_types(k=int, x=int), [(1, 40), (2, 7)])
        b = pw.debug.table_from_rows(pw.schema_from_types(k=int, y=int), [(1, 0), (2, 0)])

        def body(a, b):
            na = a.select(k=a.k, x=pw.if_else(a.x > 1, a.x // 2, a.x))
            j = b.join(a, b.k == a.k, id=b.id).select(k=b.k, y=b.y + pw.if_else(a.x > 1, 1, 0))
            return {"a": na, "b": j, "steps": j.reduce(total=pw.reducers.sum(j.y))}

        return pw.iterate(body, a=a, b=b)

    def rows(pw, result, name):
        return sorted(tuple(r.values()) for r in _dicts(pw, monkeypatch, result[name])[1].values())

    ours, theirs = program(tpw), program(jpw)
    assert {n: rows(tpw, ours, n) for n in ("a", "b", "steps")} == {
        "a": [(1, 1), (2, 1)], "b": [(1, 5), (2, 2)], "steps": [(7,)]}
    assert rows(jpw, theirs, "a") == [(1, 1), (2, 1)]
    assert rows(jpw, theirs, "b") == [] and rows(jpw, theirs, "steps") == []


def test_pagerank_reads_the_edges_from_the_outer_graph():
    """The body's tables that depend on no parameter are the iteration node's inputs."""
    edges = _edges(tpw, 6, 10, 1)
    ranks = tgraphs.pagerank(edges, iteration_limit=3)
    engine = ranks._spec.params["engine"]
    captured = {t._spec.kind for t in engine.captured}
    assert edges in engine.captured
    assert captured == {"static", "groupby_reduce", "update_rows"}
    assert ranks._spec.inputs[1:] == engine.captured


def test_louvain_names_its_item():
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        tgraphs.louvain_communities(_edges(tpw, 4, 6, 0))


# -- streamed inputs ----------------------------------------------------------------------


def _session_table(pw, sessions: dict, name: str, **types):
    if pw is tpw:
        from pathway_tpu_torch.internals.table import TableSpec
    else:
        from pathway_tpu.internals.table import TableSpec
    schema = pw.schema_from_types(**types)
    names = schema.column_names()

    def attach(scope, **_kw):
        sessions[name] = scope.input_session(len(names))
        return sessions[name], None

    return pw.Table(TableSpec("input", [], {"attach": attach}), names, schema.dtypes(), name=name)


def _stream(pw, monkeypatch, program, commits, **types):
    """``program(pw, t)`` over a session-fed table ``t`` of ``types``; each commit's
    events are ``("+"/"-", id, row)``. -> per commit: (deltas, state)."""
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "1" if pw is tpw else "0")
    if pw is tpw:
        from pathway_tpu_torch.engine.graph import Scheduler
        from pathway_tpu_torch.internals.runner import GraphRunner
    else:
        from pathway_tpu.engine.graph import Scheduler
        from pathway_tpu.internals.runner import GraphRunner
    sessions: dict = {}
    t = _session_table(pw, sessions, "t", **types)
    runner = GraphRunner()
    node = runner.build(program(pw, t))
    runner.build(t)
    deltas: list = []
    runner.scope.subscribe_table(node, on_change=lambda key, row, time, diff: deltas.append(
        (int(key), tuple(map(_canon, row)), diff)))
    sched = Scheduler(runner.scope)
    log = []
    for events in commits:
        for op, rid, row in events:
            key = pw.debug.ref_scalar(rid)
            if op == "+":
                sessions["t"].insert(key, row)
            else:
                sessions["t"].remove(key, row)
        deltas.clear()
        sched.commit()
        state = {int(k): tuple(map(_canon, r)) for k, r in node.current.items()}
        log.append((sorted(deltas), state))
    return log


def _halving(pw, t):
    return pw.iterate(
        lambda vals: {"vals": vals.select(x=pw.if_else(vals.x % 2 == 0, vals.x // 2, vals.x))},
        vals=t,
    ).vals


def test_iterated_stream_matches_the_jax_package_at_every_commit(monkeypatch):
    commits = [
        [("+", 1, (96,)), ("+", 2, (7,)), ("+", 3, (40,))],
        [("-", 2, (7,)), ("+", 4, (1024,))],
        [],
        [("-", 1, (96,)), ("+", 1, (20,)), ("+", 5, (3,))],
    ]
    ours = _stream(tpw, monkeypatch, _halving, commits, x=int)
    theirs = _stream(jpw, monkeypatch, _halving, commits, x=int)
    assert ours == theirs
    assert ours[2] == ([], ours[1][1])  # a commit that changes no input emits nothing
    key = int(tpw.debug.ref_scalar(1))
    assert (key, (3,), -1) in ours[3][0] and (key, (5,), 1) in ours[3][0]


def _edge_commits(seed: int, n_vertices: int = 24):
    """Seeded edge commits: insertions, then retractions and more insertions."""
    rng = np.random.default_rng(seed)
    live: dict[int, tuple] = {}
    commits, next_id = [], 0
    for c in range(4):
        events = []
        if c >= 2:
            for rid in sorted(rng.choice(sorted(live), size=4, replace=False)):
                events.append(("-", int(rid), live.pop(int(rid))))
        for _ in range(30 if c == 0 else 8):
            u = int(rng.integers(0, n_vertices))
            row = (u, int((u + 1 + rng.integers(0, n_vertices - 1)) % n_vertices))
            events.append(("+", next_id, row))
            live[next_id] = row
            next_id += 1
        commits.append(events)
    return commits


def test_streamed_pagerank_matches_the_jax_static_run_at_every_commit(monkeypatch):
    commits = _edge_commits(11)
    ours = _stream(tpw, monkeypatch, lambda pw, t: tgraphs.pagerank(t, iteration_limit=8),
                   commits, u=int, v=int)
    live: dict[int, tuple] = {}
    previous: dict = {}
    for c, events in enumerate(commits):
        for op, rid, row in events:
            if op == "+":
                live[rid] = row
            else:
                del live[rid]
        edges = jpw.Table.from_rows(list(live.values()), jpw.schema_from_types(u=int, v=int),
                                    keys=[jpw.debug.ref_scalar(rid) for rid in live])
        _n, rows = _dicts(jpw, monkeypatch, jgraphs.pagerank(edges, iteration_limit=8))
        want = {k: (r["v"], r["rank"]) for k, r in rows.items()}
        deltas, state = ours[c]
        assert state == want, f"commit {c}"
        want_deltas = sorted(
            [(k, r, -1) for k, r in previous.items() if want.get(k) != r]
            + [(k, r, 1) for k, r in want.items() if previous.get(k) != r])
        assert deltas == want_deltas, f"commit {c}"
        previous = want
    assert all(deltas for deltas, _s in ours)


def test_streamed_pagerank_in_the_jax_package_emits_nothing(monkeypatch):
    """Why the streamed PageRank is held to static runs: the JAX package's inner rounds
    rebuild the edge table from its connector, empty."""
    commits = _edge_commits(11)[:1]
    theirs = _stream(jpw, monkeypatch, lambda pw, t: jgraphs.pagerank(t, iteration_limit=3),
                     commits, u=int, v=int)
    assert theirs == [([], {})]
