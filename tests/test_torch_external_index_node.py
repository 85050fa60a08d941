"""The as-of-now index operator, ``ExternalIndexNode``: the scenarios of
``tests/test_indexing.py::TestEngineOperator``, each run in both packages on the same
inputs (the JAX package's ``DeviceKnnIndex`` on the CPU, the port's with
``device="cpu"``), with every answer compared bit for bit: reply keys as ints, scores
as the same f32 values, and the subscribe log of the same-commit update."""

from types import SimpleNamespace

import numpy as np
import pytest

import pathway_tpu.engine.external_index as jext
import pathway_tpu.engine.graph as jgraph
import pathway_tpu.engine.value as jval
import pathway_tpu_torch.engine.external_index as text
import pathway_tpu_torch.engine.graph as tgraph
import pathway_tpu_torch.engine.value as tval

JAX = SimpleNamespace(
    g=jgraph, v=jval, node=jext.ExternalIndexNode,
    index=lambda dim, capacity: jext.DeviceKnnIndex(dim=dim, capacity=capacity),
    scheduler=lambda scope: jgraph.Scheduler(scope, optimize=False),
)
PORT = SimpleNamespace(
    g=tgraph, v=tval, node=text.ExternalIndexNode,
    index=lambda dim, capacity: text.DeviceKnnIndex(dim=dim, capacity=capacity, device="cpu"),
    scheduler=tgraph.Scheduler,
)


def _vec(*xs):
    return tuple(float(x) for x in xs)


def _answers(node) -> dict:
    return {
        int(k): (tuple(int(i) for i in ids), tuple(scores))
        for k, (ids, scores) in node.current.items()
    }


def _setup(side, k=2, capacity=4):
    scope = side.g.Scope()
    index_in = scope.input_session(arity=1)
    query_in = scope.input_session(arity=1)
    node = side.node(
        scope, index_in, query_in, side.index(2, capacity), index_col=0, query_col=0, k=k
    )
    return scope, index_in, query_in, node, side.scheduler(scope)


def _as_of_now_no_revision(side) -> list:
    scope, index_in, query_in, node, sched = _setup(side)
    key = side.v.ref_scalar
    d1, d2, d3, q1, q2 = key(1), key(2), key(3), key("q1"), key("q2")
    out = []
    index_in.insert(d1, (_vec(1, 0),))
    index_in.insert(d2, (_vec(0, 1),))
    sched.commit()
    query_in.insert(q1, (_vec(1, 0.1),))
    sched.commit()
    out.append(_answers(node))
    assert node.current[q1][0][0] == d1
    index_in.insert(d3, (_vec(1, 0.1),))  # a better doc later must not revise q1
    sched.commit()
    out.append(_answers(node))
    assert node.current[q1][0][0] == d1
    query_in.insert(q2, (_vec(1, 0.1),))  # but a new identical query sees it
    sched.commit()
    out.append(_answers(node))
    assert node.current[q2][0][0] == d3
    return out


def _query_deletion_retracts_answer(side) -> list:
    scope, index_in, query_in, node, sched = _setup(side)
    key = side.v.ref_scalar
    out = []
    index_in.insert(key(1), (_vec(1, 0),))
    sched.commit()
    q = key("q")
    query_in.insert(q, (_vec(1, 0),))
    sched.commit()
    out.append(_answers(node))
    assert q in node.current
    query_in.remove(q, (_vec(1, 0),))
    sched.commit()
    out.append(_answers(node))
    assert q not in node.current
    return out


def _index_delete_affects_new_queries_only(side) -> list:
    scope, index_in, query_in, node, sched = _setup(side, k=1)
    key = side.v.ref_scalar
    d1, q1, q2 = key(1), key("q1"), key("q2")
    out = []
    index_in.insert(d1, (_vec(1, 0),))
    sched.commit()
    query_in.insert(q1, (_vec(1, 0),))
    sched.commit()
    index_in.remove(d1, (_vec(1, 0),))
    sched.commit()
    out.append(_answers(node))
    assert node.current[q1][0][0] == d1  # sticky answer
    query_in.insert(q2, (_vec(1, 0),))
    sched.commit()
    out.append(_answers(node))
    assert node.current[q2] == ((), ())  # empty index now
    return out


def _same_commit_query_update_single_retraction(side) -> list:
    scope, index_in, query_in, node, sched = _setup(side, k=1)
    key = side.v.ref_scalar
    index_in.insert(key(1), (_vec(1, 0),))
    index_in.insert(key(2), (_vec(0, 1),))
    sched.commit()
    q = key("q")
    query_in.insert(q, (_vec(1, 0),))
    sched.commit()
    seen = []
    scope.subscribe_table(node, on_change=lambda k, row, t, d: seen.append((k, row, d)))
    query_in.remove(q, (_vec(1, 0),))  # a query row update in one commit
    query_in.insert(q, (_vec(0, 1),))
    sched.commit()
    diffs = [d for k, _r, d in seen if k == q]
    assert sorted(diffs) == [-1, 1]  # exactly one retraction and one insertion
    assert q in node.current
    log = [(int(k), tuple(int(i) for i in r[0]), r[1], d) for k, r, d in seen]
    return [_answers(node), log]


def _capacity_growth(side) -> list:
    scope, index_in, query_in, node, sched = _setup(side, k=3)
    key = side.v.ref_scalar
    for i in range(20):  # more than the initial capacity of 4: the index grows
        index_in.insert(key(i), (_vec(np.cos(i), np.sin(i)),))
    sched.commit()
    q = key("q")
    query_in.insert(q, (_vec(np.cos(7), np.sin(7)),))
    sched.commit()
    assert node.current[q][0][0] == key(7)
    return [_answers(node), node.ext_index.capacity]


@pytest.mark.parametrize(
    "scenario",
    [
        _as_of_now_no_revision,
        _query_deletion_retracts_answer,
        _index_delete_affects_new_queries_only,
        _same_commit_query_update_single_retraction,
        _capacity_growth,
    ],
)
def test_scenario_matches_jax(scenario):
    assert scenario(PORT) == scenario(JAX)


def test_error_and_none_vectors_are_reported_not_indexed():
    scope, index_in, query_in, node, sched = _setup(PORT)
    key = tval.ref_scalar
    index_in.insert(key(1), (_vec(1, 0),))
    index_in.insert(key(2), (None,))
    index_in.insert(key(3), (tval.ERROR,))
    query_in.insert(key("q"), (None,))
    sched.commit()
    assert len(node.ext_index) == 1
    assert node.current == {}
    errors = sorted(r[0] for r in scope.error_log_default.current.values())
    assert errors == [
        "ExternalIndexNode: error/None vector in index input",
        "ExternalIndexNode: error/None vector in index input",
        "ExternalIndexNode: error/None vector in query input",
    ]


def test_requery_of_a_live_key_replaces_its_answer():
    scope, index_in, query_in, node, sched = _setup(PORT, k=1)
    key = tval.ref_scalar
    index_in.insert(key(1), (_vec(1, 0),))
    index_in.insert(key(2), (_vec(0, 1),))
    sched.commit()
    q = key("q")
    query_in.insert(q, (_vec(1, 0),))
    sched.commit()
    query_in.insert(q, (_vec(0, 1),))  # the same key again, no deletion first
    sched.commit()
    assert node.current[q][0] == (key(2),)
