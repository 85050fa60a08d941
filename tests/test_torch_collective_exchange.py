"""The port's collective exchange (``engine/collective_exchange.py`` over
``ops/bucket_swap.py``) against the JAX package's.

``exchange`` itself: the same ``Columns`` built in both packages go through the JAX
package's exchange (forced, on the 8 simulated CPU devices of ``conftest.py``) and the
port's (forced, ``device_ops.configure(device="cpu")``, where the swap runs its plain
version); every destination's keys, diffs and columns must be the same bytes, with the
output kept on the host or delivered resident and materialized.

Then the reference's corpus (``tests/test_collective_exchange.py``) on the port's
``ShardedScheduler``, ``ShardedGraphRunner`` and a single-process
``DistributedScheduler``: forced on and off give the same state bits, and the
framework programs also the JAX package's sharded state with its collective on. The
port's deliberate difference from the reference (its mesh rule: forced mode puts every
shard on the configured device) is asserted in ``test_mesh_ready``.
"""

from __future__ import annotations

import struct

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import collective_exchange as jcx
from pathway_tpu.engine.batch import Columns as JColumns
from pathway_tpu.engine.routing import columnar_shards as jshards
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu.internals.runner import ShardedGraphRunner as JShardedGraphRunner
from pathway_tpu_torch.engine import collective_exchange as cx
from pathway_tpu_torch.engine import device_ops as dops
from pathway_tpu_torch.engine import device_residency as dres
from pathway_tpu_torch.engine import routing
from pathway_tpu_torch.engine.batch import Columns
from pathway_tpu_torch.engine.graph import Scope
from pathway_tpu_torch.engine.persistence import MemoryBackend, OperatorSnapshotManager
from pathway_tpu_torch.engine.reducers import CountReducer, SumReducer
from pathway_tpu_torch.engine.routing import columnar_shards
from pathway_tpu_torch.engine.sharded import ShardedScheduler
from pathway_tpu_torch.engine.value import ref_scalar
from pathway_tpu_torch.internals import metrics as tmetrics
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.internals.runner import GraphRunner, ShardedGraphRunner
from pathway_tpu_torch.optimize import placement as tplace
from pathway_tpu_torch.ops import bucket_swap as bs

N_WORKERS = 4
PLANES = ("elided", "host_deliveries", "collective_deliveries", "repartitions")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("PATHWAY_TPU_COLLECTIVE_EXCHANGE", "PATHWAY_TPU_DEVICE_OPS",
                "PATHWAY_TPU_DEVICE_RESIDENCY"):
        monkeypatch.delenv(var, raising=False)
    dops.configure(device="cpu")
    cx.reset_counters()
    jcx.reset_counters()
    dres.reset_counters()
    dops.reset_counters()
    tplace.POLICY.reset()
    launches = bs.BUCKET_SWAP.launches
    yield
    live = dres.live_resident_batches()
    dres.decay_resident_batches()
    assert live == 0
    assert bs.BUCKET_SWAP.launches == launches  # CPU tensors never reach the kernel
    dops.configure()
    cx.reset_counters()
    jcx.reset_counters()
    dres.reset_counters()
    dops.reset_counters()
    tplace.POLICY.reset()
    TG.clear()
    JG.clear()


def _set(monkeypatch, on: bool) -> None:
    monkeypatch.setenv("PATHWAY_TPU_COLLECTIVE_EXCHANGE", "1" if on else "0")


def _canon(obj):
    """NaN-safe, ndarray-safe canonical form, floats by their bits."""
    if isinstance(obj, np.ndarray):
        obj = obj.tolist()
    if isinstance(obj, (list, tuple)):
        return tuple(_canon(x) for x in obj)
    if isinstance(obj, float):
        return ("f", struct.pack("<d", obj))
    if type(obj).__name__ == "Pointer":
        return ("ptr", int(obj))
    return obj


def _state(current: dict) -> dict:
    return {int(k): _canon(v) for k, v in current.items()}


# -- exchange against the JAX package's ---------------------------------------------------


def _batch(case: str, rng) -> tuple:
    """(n, kbytes, cols, diffs, shards) for one case, from ``rng``."""
    n = 1 if case == "one_row" else 700
    kb = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    diffs = rng.choice([-1, 1], n).astype(np.int64)
    if case == "key_bool":  # W = 17: key | bool
        cols, diffs = [rng.integers(0, 2, n).astype(bool)], None
    elif case == "nan":
        vals = rng.standard_normal(n)
        vals[::7] = np.nan
        keys = rng.integers(0, 5, n).astype(np.float64)
        keys[::11] = np.nan
        cols = [keys, vals]
    else:  # int, float, bool and fixed-width U columns: W = 16 + 8 + 8 + 8 + 1 + 20
        cols = [
            rng.integers(-9, 9, n),
            rng.standard_normal(n),
            rng.integers(0, 2, n).astype(bool),
            np.array([f"k{i % 13}" for i in rng.integers(0, 1000, n)], dtype="<U5"),
        ]
    if case == "nan":
        # the destinations of a NaN-keyed groupby: routing hashes the NaN bits
        shards = columnar_shards(("cols", [0]), Columns(n, cols, kbytes=kb), N_WORKERS)
        want = jshards(("cols", [0]), JColumns(n, cols, kbytes=kb), N_WORKERS)
        assert np.array_equal(shards, want)
    elif case == "all_to_one":
        shards = np.full(n, 2, np.int64)
    elif case == "empty_destination":
        shards = rng.choice([0, 1, 3], n).astype(np.int64)
    else:
        shards = rng.integers(0, N_WORKERS, n).astype(np.int64)
    return n, kb, cols, diffs, shards


def _parts_bits(parts) -> list:
    out = []
    for p in parts:
        if p is None:
            out.append(None)
            continue
        out.append((
            p.n,
            p.kbytes().tobytes(),
            None if p.diffs is None else p.diffs.tobytes(),
            tuple((c.dtype.str, c.tobytes()) for c in p.cols),
        ))
    return out


class _Eligible:
    """A consumer the placement pass marked device-eligible."""

    index = 9
    _device_ops_eligible = "groupby"


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
@pytest.mark.parametrize(
    "case", ["mixed", "key_bool", "nan", "empty_destination", "all_to_one", "one_row"]
)
def test_exchange_equals_the_reference(case, resident, monkeypatch):
    rng = np.random.default_rng(7)
    n, kb, cols, diffs, shards = _batch(case, rng)
    _set(monkeypatch, True)
    want = jcx.exchange(
        0, JColumns(n, [c.copy() for c in cols], kbytes=kb.copy(),
                    diffs=None if diffs is None else diffs.copy()), shards, N_WORKERS)
    if resident:
        monkeypatch.setenv("PATHWAY_TPU_DEVICE_RESIDENCY", "1")
    got = cx.exchange(
        0, Columns(n, [c.copy() for c in cols], kbytes=kb.copy(),
                   diffs=None if diffs is None else diffs.copy()),
        shards, N_WORKERS, consumer=_Eligible() if resident else None)
    assert got is not None and want is not None
    assert all((p is None) or isinstance(p, dres.DeviceResidentColumns) is resident for p in got)
    assert _parts_bits(got) == _parts_bits(want)
    assert [p is None for p in got] == [not (shards == d).any() for d in range(N_WORKERS)]
    assert cx.COLLECTIVE_STATS["exchanges"] == 1
    dres.decay_resident_batches()


def test_pack_layout_is_the_reference_wire_layout():
    rng = np.random.default_rng(3)
    n, kb, cols, diffs, _shards = _batch("mixed", rng)
    got = cx._pack_payload(Columns(n, cols, kbytes=kb, diffs=diffs))
    want = jcx._pack_payload(JColumns(n, cols, kbytes=kb, diffs=diffs))
    assert got[0].tobytes() == want[0].tobytes() and got[0].shape == want[0].shape == (n, 61)
    assert got[1] == want[1] and got[2] == want[2]
    back = cx._unpack_rows(got[0], got[1], got[2])
    assert _parts_bits([back]) == _parts_bits([Columns(n, cols, kbytes=kb, diffs=diffs)])


def test_bucket_swap_plain_version_is_the_gather():
    rng = np.random.default_rng(5)
    import torch

    payload = torch.from_numpy(rng.integers(0, 256, (300, 28), dtype=np.uint8))
    shards = rng.integers(0, 3, 300)
    perm = torch.from_numpy(np.argsort(shards, kind="stable").astype(np.int32))
    out = bs.bucket_swap(payload, perm)
    assert torch.equal(out, payload[perm.long()])
    assert bs.word_bytes(28, 0, 64) == 4 and bs.word_bytes(40, 8, 16) == 8
    assert bs.word_bytes(64, 16, 32) == 16 and bs.word_bytes(17, 0, 0) == 1
    assert bs.word_bytes(64, 16, 4) == 4
    with pytest.raises(TypeError):
        bs.bucket_swap(payload, perm.long())


# -- env contract, mesh rule, stats -----------------------------------------------------


@pytest.mark.parametrize(
    "flag,device,enabled,forced",
    [
        ("0", None, False, False),
        ("off", "cpu", False, False),
        ("1", "cpu", True, True),
        ("force", None, True, True),
        (None, "cpu", False, False),  # auto: a CPU device never engages
        (None, None, True, False),  # auto on the card
    ],
)
def test_env_contract(monkeypatch, flag, device, enabled, forced):
    if flag is not None:
        monkeypatch.setenv("PATHWAY_TPU_COLLECTIVE_EXCHANGE", flag)
    dops.configure(device=device)
    assert (cx.enabled(), cx.forced()) == (enabled, forced)
    if flag is not None:
        assert (jcx.enabled(), jcx.forced()) == (enabled, forced)


def test_mesh_ready(monkeypatch):
    """Auto mode keeps the reference's rule, one CUDA device per shard (none here);
    forced mode puts the shards on the configured device, so any count >= 2 holds."""
    import torch

    for n in (0, 1):
        assert not cx.mesh_ready(n)
    assert cx.mesh_ready(2) is (torch.cuda.device_count() >= 2)
    assert not cx.mesh_ready(4096)
    _set(monkeypatch, True)
    assert not cx.mesh_ready(1)
    assert cx.mesh_ready(N_WORKERS) and cx.mesh_ready(4096)
    assert jcx.mesh_ready(N_WORKERS) and not jcx.mesh_ready(4096)  # the reference's rule


def test_auto_mode_declines_before_anything(monkeypatch):
    """Auto on a mesh of one card per shard would span cards: the host gather."""
    dops.configure(device=None)
    monkeypatch.setattr(cx, "mesh_ready", lambda n: True)
    cols = Columns(600, [np.arange(600)], kbytes=np.zeros((600, 16), np.uint8))
    assert cx.exchange(0, cols, np.arange(600) % 2, 2) is None
    assert dres.stats()["h2d"]["events"] == 0 and dict(cx.COLLECTIVE_STATS) == {
        "exchanges": 0, "declined_non_codeable": 0}


def test_stats_shape(monkeypatch):
    """The reference's shape, less what the port does not have: the per-edge policy's
    ``placement`` (auto mode declines until item 6) and the ``errors`` a device
    failure declines into there (here it raises)."""
    _set(monkeypatch, True)
    got = cx.stats()
    want = jcx.stats()
    assert set(want) - set(got) == {"placement"} and set(got) <= set(want)
    assert got == {"enabled": True, "forced": True,
                   "events": {"exchanges": 0, "declined_non_codeable": 0},
                   "ns_total": 0, "bytes_total": 0}
    assert set(want["events"]) - set(got["events"]) == {"errors"}
    assert {k: want["events"][k] for k in got["events"]} == got["events"]


def test_metric_families(monkeypatch):
    _run_sharded(True, monkeypatch)
    snap = tmetrics.REGISTRY.snapshot()
    for fam in ("pathway_collective_exchange_events_total",
                "pathway_collective_exchange_ns_total",
                "pathway_collective_exchange_bytes_total"):
        assert fam in snap, fam
    assert tmetrics.REGISTRY.counter("pathway_collective_exchange_bytes_total").value > 0
    assert tmetrics.REGISTRY.counter("pathway_collective_exchange_ns_total").value > 0
    events = {s["labels"]["kind"]: s["value"]
              for s in snap["pathway_collective_exchange_events_total"]["series"]}
    assert events["exchanges"] == cx.COLLECTIVE_STATS["exchanges"] > 0
    # the path label tells the exchange family's delivery planes apart
    paths = {s["labels"].get("path") for s in snap["pathway_exchange_events_total"]["series"]}
    assert {"device", "host", "elided", "total"} <= paths


def test_kernel_time_is_recorded(monkeypatch):
    _run_sharded(True, monkeypatch)
    assert dops.hit_counts()["collective_exchange.all_to_all"] == cx.COLLECTIVE_STATS["exchanges"]


# -- the framework corpus ------------------------------------------------------------------


def _corpus(pw):
    def groupby_int():
        t = pw.debug.table_from_rows(
            pw.schema_from_types(k=int, v=int, w=float),
            [(i % 7, i, i * 0.25) for i in range(400)],
        )
        sel = t.select(k=t.k, v=t.v * 2 + 1, w=t.w)
        flt = sel.filter(sel.v > 7)
        return flt.groupby(flt.k).reduce(
            k=flt.k, total=pw.reducers.sum(flt.v), wsum=pw.reducers.sum(flt.w),
            cnt=pw.reducers.count(),
        )

    def join_int():
        orders = pw.debug.table_from_rows(
            pw.schema_from_types(oid=int, cust=int, amount=float),
            [(i, i % 9, float(i) * 1.5) for i in range(280)],
        )
        custs = pw.debug.table_from_rows(
            pw.schema_from_types(cid=int, region=int), [(i, i % 2) for i in range(9)]
        )
        j = orders.join(custs, orders.cust == custs.cid)
        return j.select(cust=orders.cust, region=custs.region, amount=orders.amount)

    def join_groupby_skew():
        # every order on one customer: one full destination, the others empty
        orders = pw.debug.table_from_rows(
            pw.schema_from_types(oid=int, cust=int, amount=float),
            [(i, 3, float(i)) for i in range(300)],
        )
        custs = pw.debug.table_from_rows(
            pw.schema_from_types(cid=int, region=int), [(i, i % 2) for i in range(4)]
        )
        j = orders.join(custs, orders.cust == custs.cid).select(
            region=custs.region, amount=orders.amount
        )
        return j.groupby(j.region).reduce(
            region=j.region, total=pw.reducers.sum(j.amount), cnt=pw.reducers.count()
        )

    def groupby_str():
        t = pw.debug.table_from_rows(
            pw.schema_from_types(k=str, v=int), [(f"k{i % 5}", i) for i in range(300)]
        )
        return t.groupby(t.k).reduce(k=t.k, total=pw.reducers.sum(t.v), cnt=pw.reducers.count())

    return {"groupby_int": groupby_int, "join_int": join_int,
            "join_groupby_skew": join_groupby_skew, "groupby_str": groupby_str}


def _knn(pw):
    from pathway_tpu_torch.stdlib.indexing import DataIndex, HostKnnFactory

    docs = pw.debug.table_from_rows(
        pw.schema_from_types(doc=int, emb=tuple),
        [(i, tuple(float((i * 7 + j * 3) % 13 - 6) for j in range(4))) for i in range(40)],
    )
    queries = pw.debug.table_from_rows(
        pw.schema_from_types(q=int, qemb=tuple),
        [(i, tuple(float((i * 5 + j) % 13 - 6) for j in range(4))) for i in range(9)],
    )
    index = DataIndex(docs, HostKnnFactory(dimensions=4), docs.emb)
    return index.query_as_of_now(queries, queries.qemb, number_of_matches=3)


def _capture(runner, build, g) -> dict:
    g.clear()
    try:
        (state,) = runner.capture(build())
    finally:
        g.clear()
    return _state(state)


class _Planes:
    """The exchange's counters over a block: the planes must add up."""

    def __enter__(self):
        self.before = {k: routing.EXCHANGE_STATS[k] for k in PLANES}
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            d = {k: routing.EXCHANGE_STATS[k] - self.before[k] for k in PLANES}
            self.delta = d
            assert d["elided"] + d["host_deliveries"] + d["collective_deliveries"] == d["repartitions"]
            assert d["repartitions"] > 0


@pytest.mark.parametrize("name", sorted(_corpus(tpw)))
def test_sharded_parity(name, monkeypatch):
    """Off and forced on give the port's same state bits, equal to ``threads=1``'s and
    to the JAX package's sharded run with its collective on."""
    _set(monkeypatch, False)
    with _Planes() as off_planes:
        off = _capture(ShardedGraphRunner(N_WORKERS), _corpus(tpw)[name], TG)
    assert off_planes.delta["collective_deliveries"] == 0 and cx.COLLECTIVE_STATS["exchanges"] == 0
    one = _capture(GraphRunner(), _corpus(tpw)[name], TG)
    _set(monkeypatch, True)
    with _Planes() as on_planes:
        on = _capture(ShardedGraphRunner(N_WORKERS), _corpus(tpw)[name], TG)
    ref = _capture(JShardedGraphRunner(N_WORKERS), _corpus(jpw)[name], JG)
    assert on == off == one == ref
    assert on_planes.delta["collective_deliveries"] == cx.COLLECTIVE_STATS["exchanges"] > 0
    assert jcx.COLLECTIVE_STATS["exchanges"] > 0


def test_knn_routes_by_pin_and_entries(monkeypatch):
    """The index's edges are pinned or carry rows: the collective sees none of them,
    and the answers are the host run's."""
    _set(monkeypatch, False)
    off = _capture(ShardedGraphRunner(N_WORKERS), lambda: _knn(tpw), TG)
    _set(monkeypatch, True)
    on = _capture(ShardedGraphRunner(N_WORKERS), lambda: _knn(tpw), TG)
    assert on == off and len(on) == 9


def test_exchange_invariant_with_elision(monkeypatch):
    """The framework runner elides edges too: each delivery still lands on one plane."""
    _set(monkeypatch, True)
    with _Planes() as planes:
        _capture(ShardedGraphRunner(N_WORKERS), _corpus(tpw)["groupby_int"], TG)
    assert planes.delta["collective_deliveries"] > 0


# -- the raw-scope corpus: retractions, NaN, cancelling batches ----------------------------


def _build_scopes(n_workers, eligible=False):
    scopes, sessions, aggs = [], [], []
    for _w in range(n_workers):
        sc = Scope()
        sess = sc.input_session(3)
        agg = sc.group_by_table(
            sess, by_cols=[0],
            reducers=[(SumReducer(), [1]), (SumReducer(), [2]), (CountReducer(), [])],
        )
        if eligible:
            agg._device_ops_eligible = "groupby"  # what the placement pass stamps
        scopes.append(sc)
        sessions.append(sess)
        aggs.append(agg)
    return scopes, sessions, aggs


def _feed(sess, sched, nan_keys=False, nan_vals=False):
    live = {}

    def key(i):
        if nan_keys and i % 97 == 0:
            return float("nan")
        return float(i % 7) if nan_keys else i % 7

    def ins(i, row):
        live[i] = row
        sess.insert(ref_scalar(i), row)

    def rm(i):
        sess.remove(ref_scalar(i), live.pop(i))

    for i in range(600):
        v = float("nan") if nan_vals and i % 89 == 0 else i * 0.5
        ins(i, (key(i), i, v))
    sched.commit()
    for i in range(100, 150):  # retract, reinsert modified
        rm(i)
        ins(i, (key(i), i + 1000, i * 0.25))
    sched.commit()
    sched.commit()  # an empty commit
    ins(10_000, (key(3), 1, 1.0))  # a cancelling batch
    rm(10_000)
    sched.commit()
    for i in [k for k in list(live) if _canon(live[k][0]) == _canon(key(6))]:
        rm(i)  # a group retracted to extinction
    sched.commit()


def _run_sharded(on, monkeypatch, nan_keys=False, nan_vals=False, eligible=False):
    if on is not None:
        _set(monkeypatch, on)
    scopes, sessions, aggs = _build_scopes(N_WORKERS, eligible)
    sched = ShardedScheduler(scopes)
    _feed(sessions[0], sched, nan_keys=nan_keys, nan_vals=nan_vals)
    merged = {}
    for agg in aggs:
        merged.update(agg.current)
    return _state(merged)


@pytest.mark.parametrize(
    "nan_keys,nan_vals", [(False, False), (True, False), (False, True)],
    ids=["retractions", "nan_keys", "nan_values"],
)
def test_raw_scope_parity(nan_keys, nan_vals, monkeypatch):
    off = _run_sharded(False, monkeypatch, nan_keys, nan_vals)
    assert cx.COLLECTIVE_STATS["exchanges"] == 0
    with _Planes() as planes:
        on = _run_sharded(True, monkeypatch, nan_keys, nan_vals)
    assert off == on
    assert planes.delta["collective_deliveries"] == cx.COLLECTIVE_STATS["exchanges"] > 0
    if nan_keys:
        assert any(_is_nan(v[0]) for v in on.values())
    if nan_vals:
        assert any(_is_nan(v[2]) for v in on.values())


def _is_nan(c) -> bool:
    """Whether a canonical value is a float NaN."""
    return isinstance(c, tuple) and c[0] == "f" and np.isnan(struct.unpack("<d", c[1])[0])


def test_error_log_parity(monkeypatch):
    from pathway_tpu_torch.engine import expression as ex

    def run(on):
        _set(monkeypatch, on)
        scopes, logs, aggs = [], [], []
        for w in range(N_WORKERS):
            sc = Scope()
            sess = sc.input_session(2)
            e1 = sc.expression_table(
                sess,
                [ex.Binary("%", ex.ColumnRef(0), ex.Const(5)),
                 ex.Binary("/", ex.Const(1.0), ex.ColumnRef(1))],  # x == 0 gives ERROR
            )
            gb = sc.group_by_table(
                e1, by_cols=[0], reducers=[(SumReducer(), [1]), (CountReducer(), [])]
            )
            scopes.append(sc)
            logs.append(sc.error_log_default)
            aggs.append(gb)
            if w == 0:
                feed = sess
        sched = ShardedScheduler(scopes)
        for i in range(400):
            feed.insert(ref_scalar(i), (i, float(i % 5)))
        sched.commit()
        log = sorted(repr(entry) for lg in logs for entry in lg.current.values())
        merged = {}
        for agg in aggs:
            merged.update(agg.current)
        return _state(merged), log

    cur_off, log_off = run(False)
    cur_on, log_on = run(True)
    assert cur_off == cur_on and log_off == log_on and log_on
    assert cx.COLLECTIVE_STATS["exchanges"] > 0


def test_object_column_declines_to_host(monkeypatch):
    """A mixed-type column is an object column, which cannot travel raw: the exchange
    declines and the host path delivers the same bits."""

    def run(on):
        _set(monkeypatch, on)
        scopes, sessions, aggs = [], [], []
        for _w in range(N_WORKERS):
            sc = Scope()
            sess = sc.input_session(2)
            agg = sc.group_by_table(sess, by_cols=[0], reducers=[(CountReducer(), [])])
            scopes.append(sc)
            sessions.append(sess)
            aggs.append(agg)
        sched = ShardedScheduler(scopes)
        for i in range(300):
            sessions[0].insert(ref_scalar(i), (i % 7, i if i % 2 else f"s{i}"))
        sched.commit()
        merged = {}
        for agg in aggs:
            merged.update(agg.current)
        return _state(merged)

    off = run(False)
    assert cx.COLLECTIVE_STATS["declined_non_codeable"] == 0
    on = run(True)
    assert off == on and cx.COLLECTIVE_STATS["declined_non_codeable"] > 0


def _dead_swap(payload, perm):
    raise RuntimeError("pt_bucket_swap did not launch")


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
def test_swap_failure_raises_with_no_push(resident, monkeypatch):
    """A swap that fails on the device raises out of ``exchange``: no parts, no
    completed exchange, and the host path does not take the batch over."""
    _set(monkeypatch, True)
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_RESIDENCY", "1" if resident else "0")
    monkeypatch.setattr(cx, "bucket_swap", _dead_swap)
    cols = Columns(600, [np.arange(600)], kbytes=np.zeros((600, 16), np.uint8))

    class Consumer:
        _device_ops_eligible = "groupby"
        index = 3

    with pytest.raises(RuntimeError, match="did not launch"):
        cx.exchange(0, cols, np.arange(600) % N_WORKERS, N_WORKERS, consumer=Consumer())
    assert dict(cx.COLLECTIVE_STATS) == {"exchanges": 0, "declined_non_codeable": 0}
    assert dres.RESIDENCY_STATS["resident_batches"] == 0


def test_swap_failure_raises_out_of_the_scheduler(monkeypatch):
    """Through ``ShardedScheduler``: the commit raises, no collective delivery is
    counted and no worker's groupby received a part."""
    monkeypatch.setattr(cx, "bucket_swap", _dead_swap)
    _set(monkeypatch, True)
    scopes, sessions, aggs = _build_scopes(N_WORKERS, False)
    sched = ShardedScheduler(scopes)
    before = dict(routing.EXCHANGE_STATS)
    for i in range(600):
        sessions[0].insert(ref_scalar(i), (i % 7, i, i * 0.5))
    with pytest.raises(RuntimeError, match="did not launch"):
        sched.commit()
    assert routing.EXCHANGE_STATS["collective_deliveries"] == before["collective_deliveries"]
    assert routing.EXCHANGE_STATS["host_deliveries"] == before["host_deliveries"]
    assert all(not agg.current for agg in aggs)
    assert cx.COLLECTIVE_STATS["exchanges"] == 0


def test_a_failed_build_raises(monkeypatch):
    """The kernel's build stays outside the swap's seam: it raises."""
    _set(monkeypatch, True)

    def no_card(device):
        raise RuntimeError("kernel build failed: nvcc exited 1")

    monkeypatch.setattr(cx, "prepare", no_card)
    cols = Columns(10, [np.arange(10)], kbytes=np.zeros((10, 16), np.uint8))
    with pytest.raises(RuntimeError, match="kernel build failed"):
        cx.exchange(0, cols, np.arange(10) % 2, 2)
    assert cx.COLLECTIVE_STATS["exchanges"] == 0 and dres.stats()["h2d"]["events"] == 0


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_planes_add_up(on, monkeypatch):
    with _Planes() as planes:
        _run_sharded(on, monkeypatch)
    assert (planes.delta["collective_deliveries"] > 0) is on


@pytest.mark.parametrize("snap_on,restore_on", [(True, False), (False, True)])
def test_checkpoint_cross_restore(snap_on, restore_on, monkeypatch):
    """The plane is a run-time choice, not graph structure: a snapshot taken with the
    collective forced restores with it off, and the other way round."""
    backend = MemoryBackend()

    def snap(on, restore_only=False):
        _set(monkeypatch, on)
        scopes, sessions, aggs = _build_scopes(N_WORKERS)
        mgr = OperatorSnapshotManager(backend)
        if restore_only:
            assert mgr.restore(scopes, []) is not None
        else:
            sched = ShardedScheduler(scopes)
            for i in range(600):
                sessions[0].insert(ref_scalar(i), (i % 7, i, i * 0.5))
            sched.commit()
            for i in range(100, 150):
                sessions[0].remove(ref_scalar(i), (i % 7, i, i * 0.5))
            sched.commit()
            mgr.snapshot(scopes, [], sched.time)
        merged = {}
        for agg in aggs:
            merged.update(agg.current)
        return _state(merged)

    live = snap(snap_on)
    assert snap(restore_on, restore_only=True) == live


def _distributed_run(on, monkeypatch, eligible=False):
    from pathway_tpu_torch.engine import distributed as dist

    _set(monkeypatch, on)
    scopes, sessions, aggs = [], [], []
    for _w in range(2):
        sc = Scope()
        sess = sc.input_session(2)
        agg = sc.group_by_table(
            sess, by_cols=[0], reducers=[(SumReducer(), [1]), (CountReducer(), [])]
        )
        if eligible:
            agg._device_ops_eligible = "groupby"
        scopes.append(sc)
        sessions.append(sess)
        aggs.append(agg)
    transport = dist.MeshTransport(0, 1, addresses=[("127.0.0.1", 0)])
    try:
        sched = dist.DistributedScheduler(scopes, 0, 1, transport, n_shared=len(scopes[0].nodes))
        sched.announce_topology()
        for i in range(500):
            sessions[0].insert(ref_scalar(i), (i % 13, float(i)))
        sched.commit_local()
        for i in range(50, 80):
            sessions[0].remove(ref_scalar(i), (i % 13, float(i)))
        sched.commit_local()
    finally:
        transport.close()
    merged = {}
    for agg in aggs:
        merged.update(agg.current)
    return _state(merged)


def test_distributed_single_process(monkeypatch):
    """A single-process DistributedScheduler's workers are all local: its columnar
    repartitions take the collective, with the host run's bits."""
    off = _distributed_run(False, monkeypatch)
    assert cx.COLLECTIVE_STATS["exchanges"] == 0
    with _Planes() as planes:
        on = _distributed_run(True, monkeypatch)
    assert off == on
    assert planes.delta["collective_deliveries"] == cx.COLLECTIVE_STATS["exchanges"] > 0
