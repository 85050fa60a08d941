"""The port's ordering and dedup operators against the JAX runner's: ``Table.deduplicate``
(and ``stdlib.stateful.deduplicate``), ``Table.sort``, ``Table.having`` and
``apply_async`` with ``await_futures``, over streamed commits with inserts and
retractions. Each program is lowered by each package's own ``GraphRunner`` onto its own
engine; the test feeds the input sessions itself and commits through each package's
``Scheduler``, so the commits are the same in both. After every commit the output's
deltas and state (keys and rows) must be equal, and so must the error log's entries
(an acceptor that raises, an error value). Everything here is exact."""

from __future__ import annotations

import asyncio

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.internals.udfs.executors import stop_event_loop


@pytest.fixture(autouse=True)
def _clear():
    yield
    stop_event_loop()
    TG.clear()
    JG.clear()


def _modules(pw):
    if pw is tpw:
        from pathway_tpu_torch.engine.graph import Scheduler
        from pathway_tpu_torch.internals.runner import GraphRunner
        from pathway_tpu_torch.internals.table import TableSpec
    else:
        from pathway_tpu.engine.graph import Scheduler
        from pathway_tpu.internals.runner import GraphRunner
        from pathway_tpu.internals.table import TableSpec
    return Scheduler, GraphRunner, TableSpec


def _session_table(pw, sessions: dict, name: str, **types):
    """A table fed by an engine input session that the test drives (kept in
    ``sessions[name]`` once the runner builds it)."""
    _s, _r, TableSpec = _modules(pw)
    schema = pw.schema_from_types(**types)
    names = schema.column_names()

    def attach(scope, **_kw):
        sessions[name] = scope.input_session(len(names))
        return sessions[name], None

    return pw.Table(TableSpec("input", [], {"attach": attach}), names, schema.dtypes(), name=name)


def _canon(v):
    if type(v).__name__ == "Error":
        return "ERROR"
    if isinstance(v, float):
        return ("f", np.float64(v).view(np.int64).item())
    if isinstance(v, tuple):
        return tuple(_canon(x) for x in v)
    if v is not None and type(v).__name__ == "Pointer":
        return ("ptr", int(v))
    return v


def _drive(pw, program, commits):
    """Lower ``program(pw, tables)`` (-> the output table), then for each commit feed
    its events ``(table, "+"/"-", id, row)`` and commit. -> per commit: (the output's
    deltas, its state, the error log's new entries)."""
    Scheduler, GraphRunner, _t = _modules(pw)
    sessions: dict = {}
    tables = {
        "t": _session_table(pw, sessions, "t", k=int, v=int, s=str),
        "refs": _session_table(pw, sessions, "refs", r=int),
    }
    out = program(pw, tables)
    runner = GraphRunner()
    node = runner.build(out)
    for t in tables.values():
        runner.build(t)
    deltas: list = []
    runner.scope.subscribe_table(
        node, on_change=lambda key, row, time, diff: deltas.append((int(key), _canon(row), diff))
    )
    errors = runner.scope.error_log_default
    sched = Scheduler(runner.scope)
    log, seen_errors = [], 0
    for events in commits:
        for table, op, rid, row in events:
            key = pw.debug.ref_scalar(rid)
            if op == "+":
                sessions[table].insert(key, row)
            else:
                sessions[table].remove(key, row)
        deltas.clear()
        sched.commit()
        messages = sorted(r[0].split(": ", 1)[1] for r in errors.current.values())
        state = [(int(k), _canon(r)) for k, r in node.current.items()]
        log.append((sorted(deltas, key=repr), sorted(state, key=repr),
                    messages[seen_errors:] if len(messages) > seen_errors else []))
        seen_errors = len(messages)
    return log


def _commits(seed: int = 3, n_commits: int = 5):
    """Seeded events: inserts of rows (k, v, s) into ``t`` and retractions of live rows,
    re-inserts of a retracted id with a new value, and pointer rows into ``refs``."""
    rng = np.random.default_rng(seed)
    live: dict[int, tuple] = {}
    refs: set[int] = set()
    commits, next_id = [], 0
    for c in range(n_commits):
        events = []
        for rid in rng.choice(sorted(live), size=min(len(live), int(rng.integers(1, 4))),
                              replace=False) if live else []:
            rid = int(rid)
            events.append(("t", "-", rid, live.pop(rid)))
            if rng.random() < 0.5:  # the same id again, with a new value
                row = (int(rng.integers(0, 9)), int(rng.integers(-20, 20)), f"s{rid}x")
                events.append(("t", "+", rid, row))
                live[rid] = row
        for _ in range(int(rng.integers(4, 9))):
            row = (int(rng.integers(0, 9)), int(rng.integers(-20, 20)), f"s{next_id}")
            events.append(("t", "+", next_id, row))
            live[next_id] = row
            next_id += 1
        for r in rng.choice(next_id, size=3, replace=False):
            r = int(r)
            if r in refs:
                events.append(("refs", "-", 1000 + r, (r,)))
                refs.discard(r)
            else:
                events.append(("refs", "+", 1000 + r, (r,)))
                refs.add(r)
        commits.append(events)
    return commits


def _raising(new, old):
    if new == 7:
        raise ValueError("seven")
    return new > old


PROGRAMS = {
    "dedup_max_by_instance": lambda pw, T: T["t"].deduplicate(
        value=pw.this.v, instance=pw.this.k % 4, acceptor=lambda new, old: new > old),
    "dedup_whole_table": lambda pw, T: T["t"].deduplicate(
        value=pw.this.v, acceptor=lambda new, old: new < old),
    "dedup_instance_is_a_tuple": lambda pw, T: T["t"].deduplicate(
        value=pw.this.v, instance=pw.make_tuple(pw.this.k % 2, pw.this.s.str.slice(0, 2), None),
        acceptor=lambda new, old: abs(new) >= abs(old)),
    "dedup_acceptor_raises": lambda pw, T: T["t"].deduplicate(
        value=pw.this.v, instance=pw.this.k, acceptor=_raising),
    "dedup_error_value": lambda pw, T: T["t"].deduplicate(
        value=pw.this.v // (pw.this.k - 3), instance=pw.this.k % 3,
        acceptor=lambda new, old: new != old),
    "stateful_deduplicate": lambda pw, T: pw.stdlib.stateful.deduplicate(
        T["t"], value=pw.this.v, instance=pw.this.s.str.len(), acceptor=lambda new, old: new > old),
    "sort_by_instance": lambda pw, T: T["t"].sort(key=pw.this.v, instance=pw.this.k % 3),
    "sort_whole_table": lambda pw, T: T["t"].sort(key=pw.this.s),
    "sort_with_none_keys": lambda pw, T: T["t"].sort(
        key=pw.if_else(pw.this.v > 5, None, pw.this.v), instance=pw.this.k % 2),
    "sort_incomparable_mix": lambda pw, T: T["t"].sort(
        key=pw.apply(lambda v, s: s if v % 3 == 0 else (None if v % 5 == 0 else v), pw.this.v,
                     pw.this.s)),
    "sort_then_select": lambda pw, T: T["t"].sort(key=pw.this.v).select(
        has_prev=pw.this.prev.is_not_none(), has_next=pw.this.next.is_not_none()),
    "having": lambda pw, T: T["t"].having(
        T["refs"].select(p=T["t"].pointer_from(T["refs"].r)).p),
    "having_two_indexers": lambda pw, T: T["t"].having(
        T["refs"].select(p=T["t"].pointer_from(T["refs"].r)).p,
        T["refs"].select(p=T["t"].pointer_from(T["refs"].r + 1)).p),
    "apply_async_await_futures": lambda pw, T: T["t"].select(
        pw.this.k, w=pw.apply_async(_slow_double, pw.this.v),
        z=pw.apply_async(lambda s: s.upper(), pw.this.s)).await_futures(),
}


async def _slow_double(v):
    await asyncio.sleep(0.001 * (v % 3))
    if v == -13:
        raise ValueError("minus thirteen")
    return 2 * v


@pytest.mark.parametrize("seed", [3, 8])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_matches_the_jax_runner_at_every_commit(name, seed):
    commits = _commits(seed)
    ours = _drive(tpw, PROGRAMS[name], commits)
    theirs = _drive(jpw, PROGRAMS[name], commits)
    assert len(ours) == len(commits)
    for c, (o, t) in enumerate(zip(ours, theirs)):
        assert o == t, f"commit {c}"
    assert any(deltas and any(d < 0 for *_x, d in deltas) for deltas, _s, _e in ours), \
        "no retraction reached the output"


def test_error_reports_name_the_row_fault():
    commits = [[("t", "+", i, (2, v, "a")) for i, v in enumerate((1, 7, 3))]]
    (_d, state, errors), = _drive(tpw, PROGRAMS["dedup_acceptor_raises"], commits)
    assert errors == ["error in deduplicate acceptor: seven"]
    assert [row for _k, row in state] == [(2, 3, "a")]
    commits = [[("t", "+", 0, (3, 5, "a")), ("t", "+", 1, (4, 5, "b"))]]
    (_d, state, errors), = _drive(tpw, PROGRAMS["dedup_error_value"], commits)
    assert errors == ["ZeroDivisionError in //: integer division or modulo by zero",
                      "error value in deduplicate"]
    assert len(state) == 1


def test_sort_orders_none_first_then_values_then_ids():
    commits = [[("t", "+", i, (0, v, s)) for i, (v, s) in enumerate(
        [(4, "b"), (9, "a"), (1, "c"), (8, "d"), (1, "e")])]]
    (_d, state, _e), = _drive(tpw, PROGRAMS["sort_with_none_keys"], commits)
    by_key = {k: row for k, row in state}
    first = [k for k, (prev, _n) in by_key.items() if prev is None]
    order = []
    while first:
        order.append(first[0])
        nxt = by_key[first[0]][1]
        first = [nxt[1]] if nxt is not None else []
    ids = {int(tpw.ref_scalar(i)): i for i in range(5)}
    # v > 5 sorts as None (ids 1 and 3, by id order), then v = 1 (ids 2 and 4), then 4
    assert [ids[k] for k in order] == sorted([1, 3], key=lambda i: int(tpw.ref_scalar(i))) + \
        sorted([2, 4], key=lambda i: int(tpw.ref_scalar(i))) + [0]


def test_deduplicate_keys_are_the_instance_hash():
    from pathway_tpu.engine.value import hash_values as jhash
    from pathway_tpu_torch.engine.value import hash_values as thash

    for inst in [(1,), ("a",), (None,), (1, "a", None), ((1, "b"), 2.5), (True, -3), ()]:
        assert int(thash(inst, salt=b"dedup")) == int(jhash(inst, salt=b"dedup")), inst
    commits = [[("t", "+", i, (i % 4, i, "s")) for i in range(8)]]
    (_d, state, _e), = _drive(tpw, PROGRAMS["dedup_max_by_instance"], commits)
    assert sorted(k for k, _r in state) == sorted(int(thash((i,), salt=b"dedup")) for i in range(4))


def test_unported_list_lost_exactly_the_four_operators():
    from pathway_tpu_torch.internals import table as ttable

    for name in ("deduplicate", "having", "sort", "await_futures"):
        assert name not in ttable.UNPORTED
        assert getattr(tpw.Table, name).__qualname__ == f"Table.{name}"
