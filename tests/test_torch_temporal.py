"""The port's temporal operators against the JAX package's: every window kind (tumbling,
sliding, session, ``intervals_over``) under every behavior (none, a delay, a cutoff that
keeps or forgets results, exactly once), and the interval, asof, asof-now and window
joins in each ``how``.

Each program is lowered by each package's own ``GraphRunner``; the test feeds the input
sessions itself and commits through each package's ``Scheduler``, so both see the same
seeded commits of insertions, retractions, re-insertions and late rows (times behind the
watermark). After every commit the output's deltas and state (ids and rows, floats by
their bits) and the error log's new entries must be equal. Then a few programs run
through ``pw.run`` over ``pw.debug.StreamGenerator`` tables in both packages (the
delay's buffer flushes at the end of the stream), and ``compute_and_print_update_stream``
prints what the JAX package prints. The port's device operators run on the CPU; the JAX
package's are off, as they are on a CPU."""

from __future__ import annotations

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch.engine import device_ops
from pathway_tpu_torch.internals.parse_graph import G as TG


@pytest.fixture(autouse=True)
def _clear():
    device_ops.configure(device="cpu")
    yield
    device_ops.configure()
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
    """A table fed by an engine input session that the test drives."""
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


def _drive(pw, monkeypatch, program, commits):
    """Lower ``program(pw, tables)``, then for each commit feed its events ``(table,
    "+"/"-", id, row)`` and commit. -> per commit: (the output's deltas, its state, the
    error log's new entries)."""
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "1" if pw is tpw else "0")
    Scheduler, GraphRunner, _t = _modules(pw)
    sessions: dict = {}
    tables = {
        "t": _session_table(pw, sessions, "t", t=int, v=int, k=int),
        "r": _session_table(pw, sessions, "r", t=int, w=int, k=int),
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
            key = pw.debug.ref_scalar(table, rid)
            if op == "+":
                sessions[table].insert(key, row)
            else:
                sessions[table].remove(key, row)
        deltas.clear()
        sched.commit()
        messages = sorted(r[0].split(": ", 1)[1] for r in errors.current.values())
        state = [(int(k), _canon(r)) for k, r in node.current.items()]
        log.append((sorted(deltas, key=repr), sorted(state, key=repr), messages[seen_errors:]))
        seen_errors = len(messages)
    return log


def _commits(seed: int, n_commits: int = 6):
    """Seeded events on ``t`` (t, v, k) and ``r`` (t, w, k): each commit moves event time
    forward by about 8, inserts rows around it (some behind the watermark: late rows),
    retracts live rows and re-inserts some retracted ids with new values."""
    rng = np.random.default_rng(seed)
    live: dict[tuple[str, int], tuple] = {}
    commits, next_id, now = [], 0, 0
    for _c in range(n_commits):
        events = []
        if live:
            picks = rng.choice(len(live), size=min(len(live), int(rng.integers(1, 4))),
                               replace=False)
            for i in sorted(picks, reverse=True):
                table, rid = sorted(live)[i]
                events.append((table, "-", rid, live.pop((table, rid))))
                if rng.random() < 0.4:  # the same id again, with a new value
                    row = (now + int(rng.integers(-12, 4)), int(rng.integers(-9, 9)),
                           int(rng.integers(0, 3)))
                    events.append((table, "+", rid, row))
                    live[(table, rid)] = row
        for _ in range(int(rng.integers(3, 7))):
            table = "t" if rng.random() < 0.6 else "r"
            late = rng.random() < 0.2
            t = now - int(rng.integers(6, 20)) if late else now + int(rng.integers(0, 8))
            row = (t, int(rng.integers(-9, 9)), int(rng.integers(0, 3)))
            events.append((table, "+", next_id, row))
            live[(table, next_id)] = row
            next_id += 1
        now += int(rng.integers(5, 12))
        commits.append(events)
    return commits


def _windowed(window, behavior, instance: bool):
    def program(pw, T):
        t = T["t"]
        w = window(pw, T)
        b = behavior(pw) if behavior is not None else None
        return t.windowby(
            t.t, window=w, instance=t.k if instance else None, behavior=b
        ).reduce(
            start=pw.this._pw_window_start,
            end=pw.this._pw_window_end,
            n=pw.reducers.count(),
            s=pw.reducers.sum(pw.this.v),
            m=pw.reducers.max(pw.this.v),
        )

    return program


WINDOWS = {
    "tumbling": lambda pw, T: pw.temporal.tumbling(10),
    "tumbling_origin": lambda pw, T: pw.temporal.tumbling(10, origin=3),
    "sliding": lambda pw, T: pw.temporal.sliding(hop=5, duration=15),
    "session": lambda pw, T: pw.temporal.session(max_gap=4),
}
BEHAVIORS = {
    "none": None,
    "delay": lambda pw: pw.temporal.common_behavior(delay=5),
    "cutoff_keeps": lambda pw: pw.temporal.common_behavior(cutoff=4),
    "delay_cutoff_forgets": lambda pw: pw.temporal.common_behavior(
        delay=2, cutoff=6, keep_results=False),
    "exactly_once": lambda pw: pw.stdlib.temporal.exactly_once_behavior(),
    "exactly_once_shift": lambda pw: pw.stdlib.temporal.exactly_once_behavior(shift=3),
}

PROGRAMS = {
    f"windowby_{w}_{b}{'_instance' if inst else ''}": _windowed(WINDOWS[w], BEHAVIORS[b], inst)
    for w in WINDOWS for b in BEHAVIORS for inst in (False, True)
    if not (w == "session" and b.startswith("exactly_once"))
}
for _outer in (True, False):
    PROGRAMS[f"intervals_over_{'outer' if _outer else 'inner'}"] = (
        lambda outer: lambda pw, T: T["t"].windowby(
            T["t"].t,
            window=pw.temporal.intervals_over(
                at=T["r"].t, lower_bound=-4, upper_bound=2, is_outer=outer),
        ).reduce(pw.this._pw_window_start, n=pw.reducers.count(), s=pw.reducers.sum(pw.this.v))
    )(_outer)
for _how in ("inner", "left", "right", "outer"):
    for _on in (False, True):
        PROGRAMS[f"interval_join_{_how}{'_on' if _on else ''}"] = (
            lambda how, on: lambda pw, T: pw.temporal.interval_join(
                T["t"], T["r"], T["t"].t, T["r"].t, pw.temporal.interval(-3, 2),
                *([T["t"].k == T["r"].k] if on else []), how=how,
            ).select(lt=pw.left.t, v=pw.left.v, rt=pw.right.t, w=pw.right.w)
        )(_how, _on)
    for _dir in ("backward", "forward", "nearest"):
        PROGRAMS[f"asof_join_{_how}_{_dir}"] = (
            lambda how, direction: lambda pw, T: T["t"].asof_join(
                T["r"], T["t"].t, T["r"].t, T["t"].k == T["r"].k, how=how,
                direction=direction,
            ).select(lt=pw.left.t, v=pw.left.v, rt=pw.right.t, w=pw.right.w)
        )(_how, _dir)
    for _w in ("tumbling", "sliding", "session"):
        PROGRAMS[f"window_join_{_w}_{_how}"] = (
            lambda how, w: lambda pw, T: T["t"].window_join(
                T["r"], T["t"].t, T["r"].t, WINDOWS[w](pw, T), T["t"].k == T["r"].k, how=how,
            ).select(lt=pw.left.t, v=pw.left.v, rt=pw.right.t, w=pw.right.w)
        )(_how, _w)
for _how in ("inner", "left"):
    PROGRAMS[f"asof_now_join_{_how}"] = (
        lambda how: lambda pw, T: T["t"].asof_now_join(
            T["r"], T["t"].k == T["r"].k, how=how
        ).select(lt=pw.left.t, v=pw.left.v, rt=pw.right.t, w=pw.right.w)
    )(_how)
PROGRAMS["interval_join_two_conditions"] = lambda pw, T: T["t"].interval_join(
    T["r"], T["t"].t, T["r"].t, pw.temporal.interval(-5, 5),
    pw.left.k == pw.right.k, pw.left.v % 2 == pw.right.w % 2,
).select(lt=pw.left.t, rt=pw.right.t)
PROGRAMS["sessions_over_union_instance"] = lambda pw, T: pw.temporal.window_join_outer(
    T["t"], T["r"], T["t"].t, T["r"].t, pw.temporal.session(max_gap=3),
    left_instance=T["t"].k, right_instance=T["r"].k,
).select(lt=pw.left.t, rt=pw.right.t)
PROGRAMS["windowby_error_time"] = lambda pw, T: T["t"].windowby(
    pw.this.t // (pw.this.k - 1), window=pw.temporal.session(max_gap=2),
).reduce(pw.this._pw_window_start, n=pw.reducers.count())


@pytest.mark.parametrize("seed", [1, 6])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_matches_the_jax_runner_at_every_commit(monkeypatch, name, seed):
    commits = _commits(seed)
    ours = _drive(tpw, monkeypatch, PROGRAMS[name], commits)
    theirs = _drive(jpw, monkeypatch, PROGRAMS[name], commits)
    assert len(ours) == len(commits)
    for c, (o, t) in enumerate(zip(ours, theirs)):
        assert o == t, f"commit {c}"
    assert any(state for _d, state, _e in ours), "the program never produced a row"


@pytest.mark.parametrize("behavior", ["exactly_once", "exactly_once_shift"])
def test_exactly_once_on_sessions_raises_in_both(behavior):
    for pw in (tpw, jpw):
        t = pw.debug.table_from_markdown("t | v\n1 | 2")
        with pytest.raises(ValueError, match="unsupported for session windows"):
            t.windowby(t.t, window=pw.temporal.session(max_gap=2),
                       behavior=BEHAVIORS[behavior](pw)).reduce(n=pw.reducers.count())


def test_temporal_self_join_raises_in_both():
    for pw in (tpw, jpw):
        t = pw.debug.table_from_markdown("t | v\n1 | 2")
        with pytest.raises(ValueError, match="distinct table objects"):
            t.interval_join(t, t.t, t.t, pw.temporal.interval(0, 1))
        with pytest.raises(ValueError, match="distinct table objects"):
            t.window_join(t, t.t, t.t, pw.temporal.tumbling(2))


# -- through pw.run over StreamGenerator tables -----------------------------------------

BATCHES = [
    [(1, 10, 0), (12, 2, 1)],
    [(3, 5, 0), (4, 1, 1)],
    [(25, 7, 0), (2, 9, 1)],  # t=2 is late
    [(31, 4, 1)],
]


def _stream_run(pw, monkeypatch, program):
    """``program(pw, table)`` over a StreamGenerator table of BATCHES through ``pw.run``
    and ``pw.io.subscribe``. -> the update stream: (time, id, row, diff)."""
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "1" if pw is tpw else "0")

    class S(pw.Schema):
        t: int
        v: int
        k: int

    sg = pw.debug.StreamGenerator()
    t = sg.table_from_list_of_batches(
        [[{"t": a, "v": b, "k": c} for a, b, c in batch] for batch in BATCHES], S
    )
    updates: list = []
    pw.io.subscribe(
        program(pw, t),
        on_change=lambda key, row, time, is_addition: updates.append(
            (time, int(key), tuple(sorted((n, _canon(x)) for n, x in row.items())),
             1 if is_addition else -1)
        ),
    )
    pw.run()
    return sorted(updates, key=repr)


STREAM_PROGRAMS = {
    f"{w}_{b}": (lambda w, b: lambda pw, t: t.windowby(
        t.t, window=WINDOWS[w](pw, {}), instance=t.k,
        behavior=BEHAVIORS[b](pw) if BEHAVIORS[b] is not None else None,
    ).reduce(pw.this._pw_window_start, pw.this._pw_instance, s=pw.reducers.sum(pw.this.v)))(w, b)
    for w in ("tumbling", "sliding") for b in BEHAVIORS
}
STREAM_PROGRAMS["asof_now_join"] = lambda pw, t: t.asof_now_join(
    t.select(k=pw.this.k, u=pw.this.v * 3), pw.left.k == pw.right.k).select(pw.left.t, pw.right.u)


@pytest.mark.parametrize("name", sorted(STREAM_PROGRAMS))
def test_stream_generator_run_matches_the_jax_package(monkeypatch, name):
    ours = _stream_run(tpw, monkeypatch, STREAM_PROGRAMS[name])
    TG.clear()
    theirs = _stream_run(jpw, monkeypatch, STREAM_PROGRAMS[name])
    assert ours == theirs
    assert ours


def test_stream_generator_by_workers_matches_the_jax_package():
    def keys(pw):
        class S(pw.Schema):
            a: int

        t = pw.debug.StreamGenerator().table_from_list_of_batches_by_workers(
            [{0: [{"a": 1}], 1: [{"a": 2}, {"a": 3}]}, {1: [{"a": 4}]}], S
        )
        rows = []
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: rows.append(
            (int(key), row["a"], time)))
        pw.run()
        return sorted(rows)

    ours = keys(tpw)
    assert ours == keys(jpw)
    assert sorted(a for _k, a, _t in ours) == [1, 2, 3, 4]
    assert len({t for _k, _a, t in ours}) == 2  # one commit a batch


def test_compute_and_print_update_stream_matches_the_jax_package(capsys):
    def printed(pw):
        t = pw.debug.table_from_markdown(
            """
               | t  | v
            1  | 1  | 5
            2  | 12 | 2
            3  | 3  | 4
            """
        )
        res = t.windowby(t.t, window=pw.temporal.tumbling(10)).reduce(
            pw.this._pw_window_start, s=pw.reducers.sum(pw.this.v))
        pw.debug.compute_and_print_update_stream(res)
        return capsys.readouterr().out

    ours = printed(tpw)
    assert ours == printed(jpw)
    assert "__time__ | __diff__" in ours and len(ours.splitlines()) == 3


def test_compute_and_print_update_stream_runs_the_streamed_commits(capsys):
    """The port runs a StreamGenerator table commit by commit: its printed stream is the
    subscriber's update stream of the same program in the JAX package's ``pw.run`` (the
    JAX package's printer runs only static tables, and prints the header alone)."""

    class S(tpw.Schema):
        t: int
        v: int

    t = tpw.debug.StreamGenerator().table_from_list_of_batches(
        [[{"t": 1, "v": 5}], [{"t": 3, "v": 4}], [{"t": 12, "v": 2}]], S)
    res = t.windowby(t.t, window=tpw.temporal.tumbling(10)).reduce(
        pw_start=tpw.this._pw_window_start, s=tpw.reducers.sum(tpw.this.v))
    tpw.debug.compute_and_print_update_stream(res)
    lines = capsys.readouterr().out.splitlines()[1:]
    got = sorted((int(c[2]), int(c[3]), int(c[4])) for c in (ln.split(" | ") for ln in lines))

    class JS(jpw.Schema):
        t: int
        v: int

    jt = jpw.debug.StreamGenerator().table_from_list_of_batches(
        [[{"t": 1, "v": 5}], [{"t": 3, "v": 4}], [{"t": 12, "v": 2}]], JS)
    jres = jt.windowby(jt.t, window=jpw.temporal.tumbling(10)).reduce(
        pw_start=jpw.this._pw_window_start, s=jpw.reducers.sum(jpw.this.v))
    want = []
    jpw.io.subscribe(jres, on_change=lambda key, row, time, is_addition: want.append(
        (row["s"], time, 1 if is_addition else -1)))
    jpw.run()
    assert got == sorted(want)
    assert (5, 2, -1) in got  # the [0, 10) window revised at the second commit
