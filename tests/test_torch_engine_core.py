"""The engine's core, Scope-level programs built the same way in both packages and run
over several commits: ``node.current`` of every observed node and the subscribe logs
must be equal bit for bit (keys as ints, rows as values, the error sentinel as a
marker). Covers input sessions (plain and upsert, with retractions and removals that
carry no row), per-row expressions, restrict, zip, batched UDF application, and error
poisoning with its error log."""

from types import SimpleNamespace

import pytest

import pathway_tpu.engine.expression as jex
import pathway_tpu.engine.graph as jgraph
import pathway_tpu.engine.value as jval
import pathway_tpu_torch.engine.expression as tex
import pathway_tpu_torch.engine.graph as tgraph
import pathway_tpu_torch.engine.value as tval

JAX = SimpleNamespace(g=jgraph, ex=jex, v=jval)
PORT = SimpleNamespace(g=tgraph, ex=tex, v=tval)


def _plain(x, side):
    if side.v.is_error(x):
        return "<ERROR>"
    if isinstance(x, tuple):
        return tuple(_plain(y, side) for y in x)
    if isinstance(x, int) and not isinstance(x, bool):
        return int(x)  # Pointers as ints
    return x


def _state(node, side) -> dict:
    return {int(k): _plain(r, side) for k, r in node.current.items()}


def _log(entries, side) -> list:
    return [(int(k), _plain(r, side), t, d) for k, r, t, d in entries]


def _scheduler(side, scope):
    # the JAX scheduler's graph rewriter has no counterpart in the port yet
    if side is JAX:
        return side.g.Scheduler(scope, optimize=False)
    return side.g.Scheduler(scope)


def _select_program(side) -> dict:
    g, ex, v = side.g, side.ex, side.v
    scope = g.Scope()
    sess = scope.input_session(arity=2)
    ups = scope.input_session(arity=2, upsert=True)
    exprs = [
        ex.ColumnRef(0),
        ex.Binary("+", ex.ColumnRef(1), ex.Const(10)),
        ex.Binary("*", ex.ColumnRef(0), ex.ColumnRef(1)),
        ex.Apply(lambda a, b: f"{a}:{b}", [ex.ColumnRef(0), ex.ColumnRef(1)]),
        ex.KeyRef(),
        ex.PointerFrom([ex.ColumnRef(0)]),
        ex.IfElse(ex.Binary(">", ex.ColumnRef(1), ex.Const(2)), ex.Const("big"), ex.Const("small")),
        ex.MakeTuple([ex.ColumnRef(1), ex.ColumnRef(0)]),
    ]
    sel = scope.expression_table(sess, exprs)
    usel = scope.expression_table(ups, [ex.Binary("-", ex.ColumnRef(1), ex.ColumnRef(0))])
    log, ulog = [], []
    scope.subscribe_table(sel, on_change=lambda k, r, t, d: log.append((k, r, t, d)))
    scope.subscribe_table(usel, on_change=lambda k, r, t, d: ulog.append((k, r, t, d)))
    sched = _scheduler(side, scope)
    key = v.ref_scalar
    states = []
    for i in range(5):
        sess.insert(key(i), (i, i * 2))
        ups.insert(key("u", i), (i, 100))
    sched.commit()
    states.append((_state(sel, side), _state(usel, side)))
    sess.remove(key(1), (1, 2))  # retraction with its row
    sess.remove(key(3))  # row-less removal: resolved against the state
    sess.insert(key(7), (7, 1))
    ups.insert(key("u", 2), (2, 7))  # upsert: retracts the old row first
    ups.remove(key("u", 4))
    sched.commit()
    states.append((_state(sel, side), _state(usel, side)))
    sess.insert(key(1), (1, 9))  # re-insert of a removed key
    ups.insert(key("u", 2), (2, 8))
    ups.insert(key("u", 2), (2, 9))  # two upserts of one key in one commit
    sched.commit()
    states.append((_state(sel, side), _state(usel, side)))
    sched.finish()
    return {"states": states, "log": _log(log, side), "ulog": _log(ulog, side)}


def _restrict_zip_program(side) -> dict:
    g, v = side.g, side.v
    scope = g.Scope()
    left = scope.input_session(arity=1)
    right = scope.input_session(arity=2)
    restricted = scope.restrict_table(left, right)
    zipped = scope.zip_tables([restricted, right])
    sched = _scheduler(side, scope)
    key = v.ref_scalar
    states = []
    for i in range(6):
        left.insert(key(i), (f"l{i}",))
    for i in range(0, 6, 2):
        right.insert(key(i), (i, -i))
    sched.commit()
    states.append((_state(restricted, side), _state(zipped, side)))
    right.remove(key(2), (2, -2))  # the key leaves the universe
    right.insert(key(3), (3, -3))  # and another enters it
    left.remove(key(4), ("l4",))
    sched.commit()
    states.append((_state(restricted, side), _state(zipped, side)))
    right.remove(key(0), (0, 0))
    right.insert(key(0), (0, 42))  # a row update in one commit
    sched.commit()
    states.append((_state(restricted, side), _state(zipped, side)))
    return {"states": states}


def _batch_apply_program(side) -> dict:
    g, v = side.g, side.v
    scope = g.Scope()
    sess = scope.input_session(arity=2)
    calls = []

    def rows_fn(rows):
        calls.append(len(rows))
        return [(True, a * 3 + b) if b >= 0 else (False, ValueError("negative")) for a, b in rows]

    applied = scope.batch_apply_table(sess, rows_fn, [0, 1])
    nones = scope.batch_apply_table(sess, rows_fn, [1, 0], propagate_none=True)
    sched = _scheduler(side, scope)
    key = v.ref_scalar
    states = []
    for i in range(5):
        sess.insert(key(i), (i, i - 1))  # row 0 fails in the UDF
    sess.insert(key("n"), (1, None))
    sched.commit()
    states.append((_state(applied, side), _state(nones, side)))
    sess.remove(key(2), (2, 1))
    sess.insert(key(9), (9, 9))
    sched.commit()
    states.append((_state(applied, side), _state(nones, side)))
    errors = sorted(r[0] for r in scope.error_log_default.current.values())
    return {"states": states, "calls": calls, "errors": errors}


def _error_program(side) -> dict:
    g, ex, v = side.g, side.ex, side.v
    scope = g.Scope()
    sess = scope.input_session(arity=2)
    div = scope.expression_table(sess, [ex.ColumnRef(0), ex.Binary("//", ex.ColumnRef(0), ex.ColumnRef(1))])
    cleaned = scope.remove_errors_from_table(div)
    seen = []
    scope.subscribe_table(div, on_change=lambda k, r, t, d: seen.append((k, r, t, d)))
    sched = _scheduler(side, scope)
    key = v.ref_scalar
    sess.insert(key(1), (7, 2))
    sess.insert(key(2), (7, 0))  # 7 // 0 -> ERROR, logged once
    sess.insert(key(3), (-7, 2))
    sched.commit()
    first = (_state(div, side), _state(cleaned, side))
    errors = sorted(r[0] for r in scope.error_log_default.current.values())
    sess.remove(key(2), (7, 0))
    sched.commit()
    second = (_state(div, side), _state(cleaned, side))
    errors_after = sorted(r[0] for r in scope.error_log_default.current.values())
    return {
        "states": [first, second],
        "errors": errors,
        "errors_after": errors_after,
        "log": _log(seen, side),
    }


@pytest.mark.parametrize(
    "program", [_select_program, _restrict_zip_program, _batch_apply_program, _error_program]
)
def test_program_matches_jax(program):
    assert program(PORT) == program(JAX)


def test_error_poisoning_is_logged_once():
    out = _error_program(PORT)
    div, cleaned = out["states"][0]
    key = tval.ref_scalar
    assert div == {int(key(1)): (7, 3), int(key(2)): (7, "<ERROR>"), int(key(3)): (-7, -4)}
    assert cleaned == {int(key(1)): (7, 3), int(key(3)): (-7, -4)}
    # the division is logged once; the subscriber skips the poisoned row and says so
    assert [e for e in out["errors"] if "ZeroDivisionError" in e] == [
        "ExpressionNode: ZeroDivisionError in //: integer division or modulo by zero"
    ]
    assert out["errors"][1] == "SubscribeNode: error value in output row"
    assert all("<ERROR>" not in r for _k, r, _t, _d in out["log"])
