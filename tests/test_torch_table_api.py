"""The port's public surface against the reference's names: every public name of the
reference ``Table`` is on the port's ``Table``, either ported (a select-derived
operation gives the reference's columns and runs through ``pw.run``; a relational
operation gives the reference's ids and values through ``pw.debug``) or raising
``NotImplementedError`` naming its ROADMAP item; and the keyword arguments of the
reference's ``DataIndex``, ``query_as_of_now`` and embedder are accepted and honoured,
or refused with the item that ports them."""

from __future__ import annotations

import re
import threading

import numpy as np
import pytest

import pathway_tpu_torch as tpw
from pathway_tpu_torch.engine import device as tdev
from pathway_tpu_torch.engine import device_pipeline as dp
from pathway_tpu_torch.internals import table as ttable
from pathway_tpu_torch.internals.parse_graph import G

ITEM = re.compile(r"ROADMAP queue 1 item \d+")


def _reference_names() -> list[str]:
    from pathway_tpu.internals.table import Table as JTable

    return sorted(n for n in dir(JTable) if not n.startswith("_"))


class _Idle(tpw.io.python.ConnectorSubject):
    def run(self) -> None:
        pass


@pytest.fixture
def tables():
    """(port table, reference table) with the same schema."""
    import pathway_tpu as jpw
    from pathway_tpu.internals.parse_graph import G as JG

    class JIdle(jpw.io.python.ConnectorSubject):
        def run(self) -> None:
            pass

    ours = tpw.io.python.read(_Idle(), schema=tpw.schema_from_types(a=int, b=float, c=str))
    theirs = jpw.io.python.read(JIdle(), schema=jpw.schema_from_types(a=int, b=float, c=str))
    yield ours, theirs
    G.clear()
    JG.clear()


#: the ported select-derived operations: (name, how to call it on a table of a, b, c)
PORTED_CALLS = {
    "with_columns": lambda t, pw: t.with_columns(d=pw.this.a + 1, b=pw.this.a),
    "without": lambda t, pw: t.without("b", pw.this.c),
    "rename": lambda t, pw: t.rename({"a": "x"}, y=pw.this.b),
    "rename_columns": lambda t, pw: t.rename_columns(z=pw.this.c),
    "rename_by_dict": lambda t, pw: t.rename_by_dict({"b": "q"}),
    "with_prefix": lambda t, pw: t.with_prefix("p_"),
    "with_suffix": lambda t, pw: t.with_suffix("_s"),
    "copy": lambda t, pw: t.copy(),
    "cast_to_types": lambda t, pw: t.cast_to_types(a=float),
    "update_types": lambda t, pw: t.update_types(b=int),
}
ALREADY_PORTED = {
    "column_names", "id", "keys", "pointer_from", "promise_universe_is_equal_to",
    "promise_universe_is_subset_of", "promise_universes_are_equal", "remove_errors",
    "restrict", "schema", "select", "slice", "typehints",
}

#: the ported relational operations: (name, how to call it on the tables of
#: ``_relational_tables``, through either package's ``pw``)
RELATIONAL_CALLS = {
    "filter": lambda pw, T: T["t"].filter(pw.this.v > 1.0),
    "split": lambda pw, T: T["t"].split(pw.this.v > 1.0)[1],
    "groupby": lambda pw, T: T["t"].groupby(pw.this.k).reduce(
        pw.this.k, s=pw.reducers.sum(pw.this.v), c=pw.reducers.count()
    ),
    "reduce": lambda pw, T: T["t"].reduce(
        c=pw.reducers.count(), m=pw.reducers.min(pw.this.v), a=pw.reducers.avg(pw.this.n)
    ),
    "join": lambda pw, T: T["t"].join(T["d"], pw.left.k == pw.right.k).select(
        pw.left.s, pw.right.label
    ),
    "join_inner": lambda pw, T: T["t"].join_inner(T["d"], T["t"].k == T["d"].k).select(
        T["t"].n, T["d"].label
    ),
    "join_left": lambda pw, T: T["t"].join_left(T["d"], pw.left.k == pw.right.k).select(
        pw.left.n, label=pw.right.label
    ),
    "join_right": lambda pw, T: T["t"].join_right(T["d"], pw.left.k == pw.right.k).select(
        k=pw.right.k, n=pw.left.n
    ),
    "join_outer": lambda pw, T: T["t"].join_outer(T["d"], pw.left.k == pw.right.k).select(
        pw.left.n, pw.right.label
    ),
    "concat": lambda pw, T: T["t"].concat(T["u"]),
    "concat_reindex": lambda pw, T: T["t"].concat_reindex(T["t"]),
    "with_id": lambda pw, T: T["t"].with_id(T["t"].pointer_from(pw.this.s)),
    "with_id_from": lambda pw, T: T["t"].with_id_from(pw.this.s, pw.this.k),
    "with_universe_of": lambda pw, T: T["t"].select(x=pw.this.v * 2).with_universe_of(T["t"]),
    "update_rows": lambda pw, T: T["t"].update_rows(T["v"]),
    "update_cells": lambda pw, T: T["t"].update_cells(T["v"].select(pw.this.v)),
    "intersect": lambda pw, T: T["t"].intersect(T["v"]),
    "difference": lambda pw, T: T["t"].difference(T["v"]),
    "flatten": lambda pw, T: T["t"].flatten(pw.this.s),
    "ix": lambda pw, T: T["d"].ix(T["t"].pointer_from(T["t"].k)),
    "ix_ref": lambda pw, T: T["d"].ix_ref(T["t"].k),
    "sort": lambda pw, T: T["t"].sort(key=pw.this.v, instance=pw.this.k),
    "deduplicate": lambda pw, T: T["t"].deduplicate(
        value=pw.this.n, instance=pw.this.k, acceptor=lambda new, old: new > old
    ),
    "having": lambda pw, T: T["t"].having(T["d"].select(p=T["t"].pointer_from(T["d"].k)).p),
    "await_futures": lambda pw, T: T["t"].select(
        pw.this.k, w=pw.apply_async(lambda x: 2 * x, pw.this.n)
    ).await_futures(),
    "windowby": lambda pw, T: T["t"].windowby(
        pw.this.n, window=pw.temporal.sliding(hop=10, duration=20), instance=pw.this.k
    ).reduce(pw.this._pw_window_start, c=pw.reducers.count(), s=pw.reducers.sum(pw.this.v)),
    "interval_join": lambda pw, T: T["t"].interval_join(
        T["u"], T["t"].n, T["u"].n, pw.temporal.interval(-20, 20), how="outer"
    ).select(a=pw.left.s, b=pw.right.s),
    "asof_join": lambda pw, T: T["t"].asof_join(
        T["v"], T["t"].n, T["v"].n, how="left", direction="nearest"
    ).select(pw.left.s, w=pw.right.v),
    "asof_now_join": lambda pw, T: T["t"].asof_now_join(
        T["d"], pw.left.k == pw.right.k, how="left"
    ).select(pw.left.n, pw.right.label),
    "window_join": lambda pw, T: T["t"].window_join(
        T["u"], T["t"].n, T["u"].n, pw.temporal.tumbling(50), how="outer"
    ).select(a=pw.left.s, b=pw.right.s),
    "empty": lambda pw, T: pw.Table.empty(a=int, b=str),
    "from_rows": lambda pw, T: pw.Table.from_rows(
        [(1, "a"), (2, "b")], pw.schema_from_types(a=int, b=str)
    ),
}

_MARKDOWN = {
    "t": """
       | k | v    | s   | n
    1  | 1 | 1.5  | ab  | 10
    2  | 1 | 2.0  | c   | 20
    3  | 2 | 4.0  | de  | 30
    4  | 3 | -1.0 | fgh | 40
    5  | 2 | 0.5  | i   | 50
    """,
    "u": """
       | k | v    | s   | n
    11 | 4 | 9.0  | x   | 60
    12 | 1 | 0.25 | yz  | 70
    """,
    "v": """
       | k | v    | s   | n
    3  | 7 | 7.5  | q   | 80
    4  | 8 | 8.5  | r   | 90
    6  | 9 | 9.5  | s   | 100
    """,
    "d": """
       | k | label
    1  | 1 | one
    2  | 2 | two
    9  | 9 | nine
    """,
}


def _relational_result(pw, name: str) -> tuple[list, dict]:
    tables = {n: pw.debug.table_from_markdown(md) for n, md in _MARKDOWN.items()}
    data, names = pw.debug.table_to_dicts(RELATIONAL_CALLS[name](pw, tables))
    return names, {
        int(k): {c: (np.float64(x).view(np.int64).item() if isinstance(x, float) else x)
                 for c, x in row.items()}
        for k, row in data.items()
    }


def test_every_reference_name_is_ported_or_names_its_item():
    names = _reference_names()
    assert len(names) > 50
    for name in names:
        assert hasattr(tpw.Table, name), name
        if name in PORTED_CALLS or name in ALREADY_PORTED or name in RELATIONAL_CALLS:
            assert name not in ttable.UNPORTED, name
            continue
        assert name in ttable.UNPORTED, f"{name} is neither ported nor listed"
    assert set(ttable.UNPORTED) <= set(names)  # no name of our own invention


#: the methods that raised naming item 11 until the temporal operators were ported:
#: (how to call it on a table of a, b, c, through either package's ``pw``)
TEMPORAL_CALLS = {
    "windowby": lambda t, pw: t.windowby(t.a, window=pw.temporal.tumbling(10)).reduce(
        n=pw.reducers.count()
    ),
    "interval_join": lambda t, pw: t.interval_join(
        t.select(*t), pw.left.a, pw.right.a, pw.temporal.interval(0, 5)
    ).select(pw.left.b),
    "asof_join": lambda t, pw: t.asof_join(t.select(*t), pw.left.a, pw.right.a).select(
        pw.right.c
    ),
    "asof_now_join": lambda t, pw: t.asof_now_join(
        t.select(*t), pw.left.c == pw.right.c
    ).select(pw.left.a),
    "window_join": lambda t, pw: t.window_join(
        t.select(*t), t.a, pw.right.a, pw.temporal.session(max_gap=2)
    ).select(pw.right.b),
}


@pytest.mark.parametrize("name", sorted({*ttable.UNPORTED, *TEMPORAL_CALLS}))
def test_unported_method_raises_naming_its_item(tables, name):
    t, ref = tables
    if name in TEMPORAL_CALLS:  # ported since: the reference's columns and dtypes
        import pathway_tpu as jpw

        assert name not in ttable.UNPORTED
        out, want = TEMPORAL_CALLS[name](t, tpw), TEMPORAL_CALLS[name](ref, jpw)
        assert out.column_names() == want.column_names()
        assert [repr(out._dtypes[n]) for n in out.column_names()] == [
            repr(want._dtypes[n]) for n in want.column_names()
        ]
        return
    with pytest.raises(NotImplementedError, match=ITEM) as info:
        getattr(t, name)(t.a)
    assert f"Table.{name}" in str(info.value)
    with pytest.raises(NotImplementedError, match=ITEM):
        getattr(tpw.Table, name)()  # also when called on the class (the constructors)


@pytest.mark.parametrize("name", sorted(RELATIONAL_CALLS))
def test_ported_relational_operation_matches_the_reference(name, monkeypatch):
    """Each ported relational operation through ``pw.debug``: the reference's column
    names, row ids and values, bit for bit (the port's device operators on the CPU)."""
    import pathway_tpu as jpw

    from pathway_tpu_torch.engine import device_ops

    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")
    ref = _relational_result(jpw, name)
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "1")
    device_ops.configure(device="cpu")
    try:
        got = _relational_result(tpw, name)
    finally:
        device_ops.configure()
    assert got == ref
    assert name not in ttable.UNPORTED


@pytest.mark.parametrize("name", sorted(PORTED_CALLS))
def test_ported_select_operation_gives_the_reference_columns(tables, name):
    import pathway_tpu as jpw

    ours, theirs = tables
    out, ref = PORTED_CALLS[name](ours, tpw), PORTED_CALLS[name](theirs, jpw)
    assert out.column_names() == ref.column_names()
    assert [repr(out._dtypes[n]) for n in out.column_names()] == [
        repr(ref._dtypes[n]) for n in ref.column_names()
    ]


def test_universe_promises_and_slice(tables):
    t, _ = tables
    other = tpw.io.python.read(_Idle(), schema=tpw.schema_from_types(a=int))
    assert t.promise_universes_are_equal(other) is t
    from pathway_tpu_torch.internals.universe import solver

    assert solver.query_are_equal(t._universe, other._universe)
    assert t.slice is t


def test_ported_operations_run():
    """A chain of the ported operations through ``pw.run``."""

    class Feed(tpw.io.python.ConnectorSubject):
        def run(self) -> None:
            for i in range(4):
                self.next(a=i, b=i * 0.5, c=f"r{i}")

    t = tpw.io.python.read(Feed(), schema=tpw.schema_from_types(a=int, b=float, c=str))
    out = (
        t.with_columns(d=tpw.this.a * 10)
        .without("c")
        .rename(x=tpw.this.a)
        .with_suffix("_s")
        .cast_to_types(x_s=float)
    )
    rows = []
    tpw.io.subscribe(out, on_change=lambda key, row, time, is_addition: rows.append(row))
    tpw.run()
    assert sorted(rows, key=lambda r: r["x_s"]) == [
        {"x_s": float(i), "b_s": i * 0.5, "d_s": i * 10} for i in range(4)
    ]


# -- keyword arguments of the reference ------------------------------------------------


def test_data_index_keeps_metadata_column(tables):
    from pathway_tpu_torch.stdlib.indexing import DataIndex, HostKnnFactory

    t, _ = tables
    meta = t.c
    index = DataIndex(t, HostKnnFactory(dimensions=2), t.a, metadata_column=meta)
    assert index.metadata_column is meta
    assert DataIndex(t, HostKnnFactory(dimensions=2), t.a).metadata_column is None


@pytest.mark.parametrize("with_scores", [True, False])
def test_query_as_of_now_takes_with_scores_as_the_reference_does(tables, with_scores):
    import pathway_tpu as jpw
    from pathway_tpu.stdlib.indexing import DataIndex as JDataIndex
    from pathway_tpu.stdlib.indexing import HostKnnFactory as JHostKnnFactory

    from pathway_tpu_torch.stdlib.indexing import DataIndex, HostKnnFactory

    ours, theirs = tables
    q = tpw.io.python.read(_Idle(), schema=tpw.schema_from_types(a=int, c=str))

    class JIdle(jpw.io.python.ConnectorSubject):
        def run(self) -> None:
            pass

    jq = jpw.io.python.read(JIdle(), schema=jpw.schema_from_types(a=int, c=str))
    res = DataIndex(ours, HostKnnFactory(dimensions=2), ours.a).query_as_of_now(
        q, q.a, with_scores=with_scores
    )
    ref = JDataIndex(theirs, JHostKnnFactory(dimensions=2), theirs.a).query_as_of_now(
        jq, jq.a, with_scores=with_scores
    )
    assert res.column_names() == ref.column_names()
    assert "_pw_index_reply_scores" in res.column_names()


def test_brute_force_knn_factory_is_the_device_factory():
    from pathway_tpu_torch.engine import DeviceKnnIndex
    from pathway_tpu_torch.stdlib.indexing import BruteForceKnnFactory, DeviceKnnFactory

    factory = BruteForceKnnFactory(dimensions=4, capacity=8, device="cpu")
    assert isinstance(factory, DeviceKnnFactory)
    index = factory.build()
    assert isinstance(index, DeviceKnnIndex) and index.capacity == 8 and index.dim == 4


def _tiny_embedder(**kw):
    from pathway_tpu_torch.models import EncoderConfig
    from pathway_tpu_torch.xpacks.llm import EncoderEmbedder

    cfg = EncoderConfig(vocab_size=64, hidden=16, layers=1, heads=2, intermediate=32, max_len=16)
    return EncoderEmbedder(cfg, max_len=8, max_batch_size=4, device="cpu", **kw)


def test_embedder_cache_strategy_is_not_ported_yet():
    """``EncoderEmbedder(cache_strategy=)`` serves repeated texts from the cache: the
    rows equal the uncached embedder's bit for bit, each distinct text is embedded
    once, and the cache keys are the JAX package's for the same cache name and text."""
    from pathway_tpu.internals.udfs.caches import _digest as jax_digest
    from pathway_tpu_torch.internals.udfs import InMemoryCache

    cache = InMemoryCache()
    cached = _tiny_embedder(cache_strategy=cache, device_resident=False)
    plain = _tiny_embedder(device_resident=False)
    texts = ["stream table", "vector engine", "stream table", "commit"]
    calls = []
    inner = cached._fn
    cached._fn = lambda batch: calls.append(list(batch)) or inner(batch)
    rows = cached.execute_rows([(t,) for t in texts], n_pos=1)
    again = cached.execute_rows([("commit",), ("stream table",)], n_pos=1)
    want = plain.execute_rows([(t,) for t in texts], n_pos=1)
    assert calls == [["stream table", "vector engine", "commit"]]
    for (ok, v), (wok, w) in zip(rows + again, want + [want[3], want[0]]):
        assert ok and wok
        np.testing.assert_array_equal(np.asarray(v), np.asarray(w))
    assert set(cache._data) == {jax_digest(cached._cache_name, (t,)) for t in set(texts)}


@pytest.mark.parametrize(
    "device_resident, env, lazy",
    [(None, None, True), (True, "0", True), (False, None, False), (None, "0", False)],
)
def test_embedder_device_resident(monkeypatch, device_resident, env, lazy):
    """``device_resident`` (else ``PATHWAY_DEVICE_RESIDENT_UDF``, on by default) picks
    lazy device rows or host arrays; both carry the bits of ``embed_batch``."""
    if env is None:
        monkeypatch.delenv("PATHWAY_DEVICE_RESIDENT_UDF", raising=False)
    else:
        monkeypatch.setenv("PATHWAY_DEVICE_RESIDENT_UDF", env)
    emb = _tiny_embedder(device_resident=device_resident)
    texts = ["stream table index", "vector engine", "commit"]
    rows = emb.execute_rows([(t,) for t in texts], n_pos=1)
    assert all(ok for ok, _v in rows)
    values = [v for _ok, v in rows]
    assert all(isinstance(v, tdev.LazyDeviceVector) == lazy for v in values)
    if not lazy:
        assert all(isinstance(v, np.ndarray) and v.dtype == np.float32 for v in values)
    ref = emb.embed_batch(texts).numpy()
    assert np.array_equal(np.stack([np.asarray(v) for v in values]), ref)
    tdev._LIVE_HANDLES.clear()
    dp.PIPELINE.stop_worker()
    assert not [t for t in threading.enumerate() if t.name == "pw-device-pipeline"]
