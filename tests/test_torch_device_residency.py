"""The port's residency plane (``engine/device_residency.py``): the transfer counters
and their metric families, the commit-boundary decay, the seam keys placement reads, the
``PATHWAY_TPU_DEVICE_RESIDENCY`` modes, and the resident batches the collective exchange
delivers (``DeviceResidentColumns``, the join's device key twins); each against the JAX
package's where the JAX package can run here. ``device_column`` is held to numpy's
``.view`` of the same bytes and to the materialized ``cols[i]``: the JAX package's
``device_column`` imports ``jax.experimental.enable_x64``, which this JAX lacks.

The device operators' upload and fetch are counted at their tensors' sizes: the
segment reduction uploads one ``[1 + columns, rows]`` int64 stack and fetches one ``[1 +
columns, groups]`` int64 block; the matcher uploads both key arrays and fetches the two
index arrays. The operators run on CPU tensors here, where the counts are the same.
"""

from __future__ import annotations

import importlib
import re

import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import collective_exchange as jcx
from pathway_tpu.engine import device_residency as jres
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu.optimize import placement as jplace
from pathway_tpu_torch.engine import collective_exchange as cx
from pathway_tpu_torch.engine import device_ops as dops
from pathway_tpu_torch.engine import device_pipeline as dp
from pathway_tpu_torch.engine import device_residency as dres
from pathway_tpu_torch.engine import graph as tgraph
from pathway_tpu_torch.engine import reducers as tred
from pathway_tpu_torch.engine.batch import Columns
from pathway_tpu_torch.engine.value import ref_scalar as tref
from pathway_tpu_torch.internals import metrics as tmetrics
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.optimize import placement as tplace


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("PATHWAY_TPU_DEVICE_OPS", "PATHWAY_TPU_DEVICE_RESIDENCY",
                "PATHWAY_TPU_COLLECTIVE_EXCHANGE"):
        monkeypatch.delenv(var, raising=False)
    dops.configure(device="cpu")
    dres.reset_counters()
    dops.reset_counters()
    cx.reset_counters()
    tplace.POLICY.reset()
    yield
    live = dres.live_resident_batches()
    dres.decay_resident_batches()
    assert live == 0
    dops.configure()
    dres.reset_counters()
    dops.reset_counters()
    cx.reset_counters()
    jcx.reset_counters()
    tplace.POLICY.reset()
    jplace.POLICY.reset()
    TG.clear()
    JG.clear()


# -- counters -------------------------------------------------------------------------


def test_stats_shape_matches_the_reference(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_RESIDENCY", "1")
    jres.reset_counters()
    assert dres.stats() == jres.stats()
    assert dres.stats() == {
        "enabled": True,
        "forced": True,
        "events": {
            "resident_batches": 0,
            "materializations": 0,
            "device_consumes": 0,
            "declines": 0,
        },
        "h2d": {"events": 0, "bytes": 0},
        "d2h": {"events": 0, "bytes": 0},
        "bytes_saved": 0,
    }


def test_counters_count_and_reset_as_the_reference(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_RESIDENCY", "0")
    jres.reset_counters()
    for mod in (dres, jres):
        mod.record_h2d(100)
        mod.record_h2d(28)
        mod.record_d2h(64)
        mod.record_saved(0)  # nothing saved: not counted
        mod.record_saved(12)
        mod.RESIDENCY_STATS["declines"] += 1
    assert dres.stats() == jres.stats()
    assert dres.stats()["h2d"] == {"events": 2, "bytes": 128}
    assert dres.stats()["d2h"] == {"events": 1, "bytes": 64}
    assert dres.stats()["bytes_saved"] == 12
    dres.reset_counters()
    jres.reset_counters()
    assert dres.stats() == jres.stats()
    assert dres.stats()["h2d"] == {"events": 0, "bytes": 0}


@pytest.mark.parametrize(
    "family",
    [
        "pathway_device_transfer_h2d_events_total",
        "pathway_device_transfer_h2d_bytes_total",
        "pathway_device_transfer_d2h_events_total",
        "pathway_device_transfer_d2h_bytes_total",
        "pathway_device_residency_bytes_saved_total",
    ],
)
def test_metric_families_mirror_the_counters(family):
    dres.record_h2d(10)
    dres.record_d2h(20)
    dres.record_saved(30)
    want = {
        "pathway_device_transfer_h2d_events_total": 1,
        "pathway_device_transfer_h2d_bytes_total": 10,
        "pathway_device_transfer_d2h_events_total": 1,
        "pathway_device_transfer_d2h_bytes_total": 20,
        "pathway_device_residency_bytes_saved_total": 30,
    }[family]
    assert tmetrics.REGISTRY.counter(family).value == want


def test_event_counters_mirror_into_their_family():
    dres.RESIDENCY_STATS["materializations"] += 2
    fam = "pathway_device_residency_events_total"
    assert tmetrics.REGISTRY.counter(fam, kind="materializations").value == 2.0
    dres.reset_counters()
    assert tmetrics.REGISTRY.counter(fam, kind="materializations").value == 0.0


def test_placement_gauges_are_collected(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "1")
    tplace.POLICY.seed("groupby", 4, device=True)
    tplace.POLICY.seed("join", 6)
    samples = {
        (name, tuple(sorted(labels.items()))): value
        for name, _kind, _help, labels, value in tmetrics.REGISTRY.collect()
    }
    assert samples[("pathway_device_ops_placement", (("op", "groupby:4"),))] == 1
    assert samples[("pathway_device_ops_placement", (("op", "join:6"),))] == 0
    assert ("pathway_optimizer_chains_fused", ()) in samples


# -- the device operators' uploads and fetches ---------------------------------------------


@pytest.mark.parametrize("cols", [[], ["i"], ["f"], ["i", None, "f", "f"]])
def test_segment_reduce_counts_its_upload_and_fetch(cols):
    rng = np.random.default_rng(1)
    n, nu = 1000, 37
    inverse = rng.integers(0, nu, n)
    diffs = rng.choice([-1, 1], n)
    vals = [
        None if c is None
        else rng.integers(-9, 9, n) if c == "i"
        else rng.standard_normal(n)
        for c in cols
    ]
    dops.segment_reduce_dispatch(inverse, diffs, vals, nu).fetch()
    live = 1 + sum(c is not None for c in cols)
    st = dres.stats()
    assert st["h2d"] == {"events": 1, "bytes": (1 + live) * n * 8}  # + the group index
    assert st["d2h"] == {"events": 1, "bytes": live * nu * 8}


@pytest.mark.parametrize("case", ["matches", "no_matches", "swapped"])
def test_matcher_counts_its_uploads_and_fetch(case):
    rng = np.random.default_rng(2)
    la = rng.integers(0, 50, 400)
    ra = rng.integers(0, 50, 30) if case != "no_matches" else rng.integers(100, 200, 30)
    if case == "swapped":
        la, ra = ra, la
    l_idx, r_idx = dops.match_pairs([la], [ra])
    st = dres.stats()
    assert st["h2d"] == {"events": 2, "bytes": la.nbytes + ra.nbytes}
    if case == "no_matches":
        assert len(l_idx) == 0 and st["d2h"] == {"events": 0, "bytes": 0}
    else:
        assert st["d2h"] == {"events": 1, "bytes": l_idx.nbytes + r_idx.nbytes}
        assert len(l_idx) > 0


# -- decay ----------------------------------------------------------------------------------


class _Resident:
    def __init__(self) -> None:
        self.decayed = False

    def decay(self) -> None:
        self.decayed = True


def test_nothing_is_resident_on_one_card(monkeypatch):
    """A forced groupby leaves no resident batch behind any commit."""
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "1")
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_RESIDENCY", "1")
    scope = tgraph.Scope()
    facts = scope.input_session(2)
    scope.group_by_table(
        facts, by_cols=[0], reducers=[(tred.make_reducer(tred.ReducerKind.SUM), [1])]
    )
    sched = tgraph.Scheduler(scope)
    for c in range(3):
        for i in range(600):
            facts.insert(tref(c * 600 + i), (i % 13, i))
        sched.commit()
        assert dres.live_resident_batches() == 0
    assert dres.stats()["h2d"]["events"] == 3 and dres.stats()["events"]["resident_batches"] == 0


@pytest.mark.parametrize("seam", ["commit_boundary", "drain", "drain_until"])
def test_every_commit_seam_decays_resident_batches(seam):
    held = _Resident()
    dres._LIVE_RESIDENT.add(held)
    assert dres.live_resident_batches() == 1
    if seam == "commit_boundary":
        dp.commit_boundary(0)
    elif seam == "drain":
        dp.drain()
    else:
        dp.drain_until(0)
    assert held.decayed and dres.live_resident_batches() == 0
    dres.decay_resident_batches()  # the empty set: a no-op


def test_pipeline_stats_report_the_planes(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_RESIDENCY", "1")
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "1")
    monkeypatch.setenv("PATHWAY_TPU_COLLECTIVE_EXCHANGE", "1")
    s = dp.PIPELINE.stats()
    assert s["device_residency"]["forced"] is True
    assert s["device_ops"]["enabled"] is True
    assert s["collective_exchange"] == {
        "enabled": True,
        "events": {"exchanges": 0, "declined_non_codeable": 0},
    }


# -- modes ----------------------------------------------------------------------------------


@pytest.mark.parametrize(
    "flag,device,enabled,forced",
    [
        ("0", None, False, False),
        ("off", "cuda", False, False),
        ("1", "cpu", True, True),
        ("force", None, True, True),
        (None, "cpu", False, False),  # auto: a CPU device keeps nothing resident
        (None, None, True, False),  # auto on the card
        (None, "cuda", True, False),
    ],
)
def test_modes(monkeypatch, flag, device, enabled, forced):
    if flag is not None:
        monkeypatch.setenv("PATHWAY_TPU_DEVICE_RESIDENCY", flag)
    dops.configure(device=device)
    assert (dres.enabled(), dres.forced()) == (enabled, forced)
    if flag in ("0", "off", "1", "force"):
        assert (jres.enabled(), jres.forced()) == (enabled, forced)


# -- seam keys ------------------------------------------------------------------------------


def _program(pw):
    orders = pw.debug.table_from_rows(
        pw.schema_from_types(cust=int, amount=int), [(i % 7, i) for i in range(50)]
    )
    custs = pw.debug.table_from_rows(
        pw.schema_from_types(cid=int, region=int), [(i, i % 3) for i in range(7)]
    )
    j = orders.join(custs, orders.cust == custs.cid).select(
        region=custs.region, amount=orders.amount
    )
    return j.groupby(j.region).reduce(j.region, total=pw.reducers.sum(j.amount))


def _seams(pw, place, res):
    runner = importlib.import_module(pw.__name__ + ".internals.runner").GraphRunner()
    runner.build(_program(pw))
    place.POLICY.reset()
    place.run_pass([runner.scope])
    keys = {n.index: res.consumer_seam_key(n) for n in runner.scope.nodes}
    ok = {n.index: res.consumer_resident_ok(n) for n in runner.scope.nodes}
    return keys, ok, place.POLICY.decisions()


@pytest.mark.parametrize("residency", ["1", "0"])
def test_seam_keys_match_the_reference(monkeypatch, residency):
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "1")
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_RESIDENCY", residency)
    got = _seams(tpw, tplace, dres)
    want = _seams(jpw, jplace, jres)
    assert got == want
    keys, ok, dec = got
    kinds = {k[0] for k in keys.values() if k is not None}
    assert kinds == {"join", "groupby"}
    assert any(v for v in ok.values()) is (residency == "1")
    assert any(d["links"] for d in dec.values())  # the join feeds the groupby


def test_seam_key_of_nothing_is_none():
    assert dres.consumer_seam_key(None) is None

    class _Plain:
        index = 3

    assert dres.consumer_seam_key(_Plain()) is None
    assert dres.consumer_resident_ok(_Plain()) is False


def test_auto_mode_follows_the_measured_placement(monkeypatch):
    """Auto mode: a seam is resident-eligible only while its operator sits on the
    card."""
    monkeypatch.setattr(dops, "configured_on_card", lambda: True)
    dops.configure(device="cpu")

    class _Op:
        index = 5
        _device_ops_eligible = "groupby"

    assert dres.enabled() and not dres.forced()
    assert dres.consumer_resident_ok(_Op()) is False
    tplace.POLICY.seed("groupby", 5, device=True)
    assert dres.consumer_resident_ok(_Op()) is True


# -- resident batches -----------------------------------------------------------------------


def _packed_fixture(n=640, with_diffs=True):
    """A host Columns and its packed wire payload (the exchange's layout)."""
    kb = np.ascontiguousarray(
        (np.arange(n * 16, dtype=np.int64) % 251).astype(np.uint8).reshape(n, 16)
    )
    cols = [np.arange(n, dtype=np.int64) * 3 - 7, np.arange(n, dtype=np.float64) * 0.5 - 2.0]
    diffs = np.where(np.arange(n) % 5 == 0, -1, 1).astype(np.int64) if with_diffs else None
    host = Columns(n, cols, kbytes=kb, diffs=diffs)
    payload, layout, has_diffs = cx._pack_payload(host)
    assert payload is not None
    return host, payload, layout, has_diffs


def _resident_from(payload, layout, has_diffs, seam_key=None):
    return dres.DeviceResidentColumns.from_device_rows(
        torch.from_numpy(payload.copy()), layout, has_diffs, seam_key=seam_key
    )


def test_resident_columns_lazy_then_bit_exact():
    host, payload, layout, has_diffs = _packed_fixture()
    res = _resident_from(payload, layout, has_diffs)
    # the diffs are fetched at once (every delivery path screens them), nothing else
    assert res.n == host.n and np.array_equal(res.diffs, host.diffs)
    assert res.resident() and not res._materialized()
    assert dres.stats()["d2h"] == {"events": 1, "bytes": 8 * host.n}
    assert dres.RESIDENCY_STATS["materializations"] == 0
    # the first host access materializes the same bits
    assert np.array_equal(res.kbytes(), host.kbytes())
    assert res._materialized() and dres.RESIDENCY_STATS["materializations"] == 1
    assert dres.stats()["d2h"] == {"events": 2, "bytes": 8 * host.n + payload.nbytes}
    for got, want in zip(res.cols, host.cols):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert res.resident()  # the device rows outlive materialization
    res.kbytes()
    assert dres.RESIDENCY_STATS["materializations"] == 1
    res.decay()


def test_resident_columns_no_diffs():
    host, payload, layout, has_diffs = _packed_fixture(with_diffs=False)
    assert not has_diffs
    res = _resident_from(payload, layout, has_diffs)
    assert res.diffs is None and dres.stats()["d2h"]["events"] == 0
    for got, want in zip(res.cols, host.cols):
        assert got.tobytes() == want.tobytes()
    res.decay()


_VIEW_DTYPES = [np.bool_, np.int8, np.uint8, np.int16, np.int32, np.int64, np.float16,
                np.float32, np.float64, np.complex64, np.complex128]


@pytest.mark.parametrize("diffs", [False, True])
@pytest.mark.parametrize("lead", [np.bool_, np.int16, np.float32], ids=["w1", "w2", "w4"])
def test_device_column_every_width_at_unaligned_offsets(lead, diffs):
    """Every viewable dtype after a narrow column, so that its lane's offset and the row
    stride divide nothing: each lane equals numpy's ``.view`` of the same bytes and the
    materialized column, and asking for it materializes nothing."""
    rng = np.random.default_rng(11)
    n = 37
    cols = [rng.integers(0, 2, n).astype(lead)]
    for dt in _VIEW_DTYPES:
        raw = rng.integers(0, 256, n * np.dtype(dt).itemsize, dtype=np.uint8)
        if dt is np.bool_:
            raw = raw % 2
        cols.append(raw.view(dt))
    kb = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    host = Columns(n, cols, kbytes=kb, diffs=np.ones(n, np.int64) if diffs else None)
    payload, layout, has_diffs = cx._pack_payload(host)
    res = _resident_from(payload, layout, has_diffs)
    off = 16 + (8 if diffs else 0)
    unaligned = 0
    for i, (dt, width) in enumerate(layout):
        got = res.device_column(i)
        want = np.ascontiguousarray(payload[:, off : off + width]).view(dt).ravel()
        unaligned += off % width != 0
        off += width
        assert got.shape == (n,)
        assert got.numpy().tobytes() == want.tobytes() == cols[i].tobytes()
    assert unaligned >= 2  # lanes whose offset their width does not divide
    assert not res._materialized()
    for i, want in enumerate(cols):
        assert res.device_column(i).numpy().tobytes() == res.cols[i].tobytes()
    res.decay()


@pytest.mark.parametrize("col", [np.array(["ab", "c"] * 5), np.arange(10).astype("datetime64[s]"),
                                 np.arange(10, dtype=">i8")], ids=["U", "datetime64", "big_endian"])
def test_device_column_of_an_unviewable_dtype_raises(col):
    host = Columns(10, [np.arange(10), col], kbytes=np.zeros((10, 16), np.uint8))
    payload, layout, has_diffs = cx._pack_payload(host)
    res = _resident_from(payload, layout, has_diffs)
    assert res.device_column(0).tolist() == list(range(10))
    with pytest.raises(TypeError, match=re.escape(str(col.dtype))):
        res.device_column(1)
    assert res.cols[1].tobytes() == col.tobytes()  # the host side decodes it
    res.decay()


def test_decay_materializes_and_drops_the_rows():
    host, payload, layout, has_diffs = _packed_fixture()
    res = _resident_from(payload, layout, has_diffs)
    res.decay()
    assert not res.resident() and dres.live_resident_batches() == 1
    assert res.device_rows() is None and res.device_column(0) is None
    assert np.array_equal(res.kbytes(), host.kbytes())
    assert np.array_equal(res.cols[1], host.cols[1])
    res.decay()  # idempotent
    dres.decay_resident_batches()


def test_decay_resident_batches_sweeps_the_live_set():
    host, payload, layout, has_diffs = _packed_fixture()
    a = _resident_from(payload, layout, has_diffs)
    b = _resident_from(payload, layout, has_diffs)
    assert dres.live_resident_batches() == 2
    dres.decay_resident_batches()
    assert not a.resident() and not b.resident() and dres.live_resident_batches() == 0
    assert np.array_equal(a.cols[0], host.cols[0])
    dres.decay_resident_batches()


def test_gather_after_materialize_matches_the_host():
    host, payload, layout, has_diffs = _packed_fixture()
    res = _resident_from(payload, layout, has_diffs)
    idx = np.arange(0, host.n, 3, dtype=np.int64)
    got, want = res.gather(idx), host.gather(idx)
    assert np.array_equal(got.kbytes(), want.kbytes())
    assert np.array_equal(got.diffs, want.diffs)
    for g, w in zip(got.cols, want.cols):
        assert g.tobytes() == w.tobytes()
    res.decay()


def test_materialize_records_the_seam():
    host, payload, layout, has_diffs = _packed_fixture()
    res = _resident_from(payload, layout, has_diffs, seam_key=("join", 4))
    res.cols
    dec = tplace.POLICY.decisions()["join:4"]
    assert dec["seam_events"] == 1 and dec["seam_ns_per_row"] > 0
    res.decay()


# -- the exchange's two ends --------------------------------------------------------------

N_WORKERS = 4


class _Consumer:
    def __init__(self, kind=None, index=0, downstream=None):
        if kind is not None:
            self._device_ops_eligible = kind
        if downstream is not None:
            self._device_residency_downstream = downstream
        self.index = index


def _set_env(monkeypatch, residency_on, device_ops=False):
    # the collective forced in both modes, so that residency is the one variable
    monkeypatch.setenv("PATHWAY_TPU_COLLECTIVE_EXCHANGE", "1")
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "1" if device_ops else "0")
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_RESIDENCY", "1" if residency_on else "0")


def _run_exchange(columns, shards, consumer, monkeypatch, residency_on):
    _set_env(monkeypatch, residency_on)
    parts = cx.exchange(0, columns, shards, N_WORKERS, consumer=consumer)
    assert parts is not None
    return parts


def _parts_bits(parts):
    return [
        None if p is None else (
            p.kbytes().tobytes(),
            None if p.diffs is None else p.diffs.tobytes(),
            tuple((c.dtype.str, c.tobytes()) for c in p.cols),
        )
        for p in parts
    ]


def test_resident_egress_parity(monkeypatch):
    """Resident parts are zero-copy slices of the swap's output and materialize the host
    parts' bits; the d2h bytes are the host run's plus the eager diffs (no padded tail
    exists to save)."""
    host, payload, layout, has_diffs = _packed_fixture(n=700)
    shards = (np.arange(700, dtype=np.int64) * 7) % N_WORKERS
    consumer = _Consumer(kind="groupby", index=7)
    off = _run_exchange(host, shards, consumer, monkeypatch, False)
    assert dres.RESIDENCY_STATS["resident_batches"] == 0
    s_off = dres.stats()
    dres.reset_counters()
    on = _run_exchange(host, shards, consumer, monkeypatch, True)
    assert all(isinstance(p, dres.DeviceResidentColumns) for p in on)
    assert dres.RESIDENCY_STATS["resident_batches"] == N_WORKERS
    base = on[0].device_rows().untyped_storage().data_ptr()
    assert all(p.device_rows().untyped_storage().data_ptr() == base for p in on)
    assert _parts_bits(on) == _parts_bits(off)
    s_on = dres.stats()
    assert s_on["h2d"] == s_off["h2d"]
    assert s_on["d2h"]["bytes"] == s_off["d2h"]["bytes"] + 8 * host.n
    assert s_on["bytes_saved"] == s_off["bytes_saved"] == 0
    dres.decay_resident_batches()


def test_resident_ingress_repack(monkeypatch):
    """A still-resident input re-packs from its device rows: only the order crosses to
    the device, and the parts equal packing the same batch on the host."""
    host, payload, layout, has_diffs = _packed_fixture(n=650)
    shards = (np.arange(650, dtype=np.int64) * 11) % N_WORKERS
    off = _run_exchange(host, shards, None, monkeypatch, False)
    h2d_host = dres.stats()["h2d"]["bytes"]
    assert h2d_host == payload.nbytes + 4 * host.n
    res = _resident_from(payload, layout, has_diffs)
    dres.reset_counters()
    on = _run_exchange(res, shards, None, monkeypatch, True)
    s = dres.stats()
    assert s["events"]["device_consumes"] == 1
    assert s["h2d"]["bytes"] == 4 * host.n  # the payload never crossed again
    assert s["bytes_saved"] == payload.nbytes
    assert _parts_bits(on) == _parts_bits(off)
    assert not res._materialized()
    res.decay()


def test_resident_egress_failure_raises(monkeypatch):
    """A failure while wrapping the resident parts raises out of the exchange: the
    output is not fetched to the host instead, and no exchange completes."""
    host, payload, layout, has_diffs = _packed_fixture(n=600)
    shards = np.arange(600, dtype=np.int64) % N_WORKERS
    consumer = _Consumer(kind="groupby", index=7)

    def boom(*a, **k):
        raise RuntimeError("the resident wrap failed")

    monkeypatch.setattr(dres.DeviceResidentColumns, "from_device_rows", boom)
    _set_env(monkeypatch, True)
    with pytest.raises(RuntimeError, match="resident wrap failed"):
        cx.exchange(0, host, shards, N_WORKERS, consumer=consumer)
    assert dres.RESIDENCY_STATS["declines"] == 0
    assert dres.stats()["d2h"]["events"] == 0  # nothing fetched in its place
    assert cx.COLLECTIVE_STATS["exchanges"] == 0


# -- the raw-scope corpus under residency ---------------------------------------------------


def _build_scopes(n_workers):
    scopes, sessions, aggs = [], [], []
    for _w in range(n_workers):
        sc = tgraph.Scope()
        sess = sc.input_session(3)
        agg = sc.group_by_table(
            sess, by_cols=[0],
            reducers=[(tred.SumReducer(), [1]), (tred.SumReducer(), [2]), (tred.CountReducer(), [])],
        )
        agg._device_ops_eligible = "groupby"  # raw scopes: what the placement pass stamps
        scopes.append(sc)
        sessions.append(sess)
        aggs.append(agg)
    return scopes, sessions, aggs


def _canon(obj):
    if isinstance(obj, np.ndarray):
        obj = obj.tolist()
    if isinstance(obj, (list, tuple)):
        return tuple(_canon(x) for x in obj)
    if isinstance(obj, float):
        return ("f", np.float64(obj).tobytes())
    return obj


def _feed(sess, sched, nan_keys=False, nan_vals=False):
    live = {}

    def key(i):
        if nan_keys and i % 97 == 0:
            return float("nan")
        return float(i % 7) if nan_keys else i % 7

    def ins(i, row):
        live[i] = row
        sess.insert(tref(i), row)

    def rm(i):
        sess.remove(tref(i), live.pop(i))

    for i in range(600):
        ins(i, (key(i), i, float("nan") if nan_vals and i % 89 == 0 else i * 0.5))
    sched.commit()
    assert dres.live_resident_batches() == 0
    for i in range(100, 150):
        rm(i)
        ins(i, (key(i), i + 1000, i * 0.25))
    sched.commit()
    sched.commit()
    ins(10_000, (key(3), 1, 1.0))
    rm(10_000)
    sched.commit()
    for i in [k for k in list(live) if _canon(live[k][0]) == _canon(key(6))]:
        rm(i)
    sched.commit()
    assert dres.live_resident_batches() == 0


def _run_sharded(on, monkeypatch, nan_keys=False, nan_vals=False):
    from pathway_tpu_torch.engine.sharded import ShardedScheduler

    _set_env(monkeypatch, on)
    scopes, sessions, aggs = _build_scopes(N_WORKERS)
    sched = ShardedScheduler(scopes)
    _feed(sessions[0], sched, nan_keys=nan_keys, nan_vals=nan_vals)
    merged = {}
    for agg in aggs:
        merged.update(agg.current)
    return {int(k): _canon(v) for k, v in merged.items()}


@pytest.mark.parametrize("nan_keys,nan_vals", [(False, False), (True, False), (False, True)],
                         ids=["retractions", "nan_keys", "nan_values"])
def test_raw_scope_parity(nan_keys, nan_vals, monkeypatch):
    off = _run_sharded(False, monkeypatch, nan_keys, nan_vals)
    assert dres.RESIDENCY_STATS["resident_batches"] == 0
    on = _run_sharded(True, monkeypatch, nan_keys, nan_vals)
    assert off == on
    assert dres.RESIDENCY_STATS["resident_batches"] > 0
    assert dres.RESIDENCY_STATS["materializations"] == dres.RESIDENCY_STATS["resident_batches"]


def test_raw_scope_transfer_bytes(monkeypatch):
    """The port's own accounting (no padded buffer): residency on moves the same h2d
    bytes as off, and d2h at most off's plus the eager diff fetch, 8 bytes a row."""
    off = _run_sharded(False, monkeypatch)
    s_off = dres.stats()
    dres.reset_counters()
    cx.reset_counters()
    on = _run_sharded(True, monkeypatch)
    s_on = dres.stats()
    assert off == on
    rows = cx.COLLECTIVE_STATS["exchanges"] and int(
        cx.stats()["bytes_total"]) // (16 + 8 + 8 + 8 + 8)
    assert rows > 0
    assert s_on["h2d"] == s_off["h2d"]
    assert s_off["d2h"]["bytes"] <= s_on["d2h"]["bytes"] <= s_off["d2h"]["bytes"] + 8 * rows
    assert s_on["bytes_saved"] == s_off["bytes_saved"] == 0


def test_commit_boundary_decays_residents(monkeypatch):
    from pathway_tpu_torch.engine.sharded import ShardedScheduler

    _set_env(monkeypatch, True)
    scopes, sessions, _aggs = _build_scopes(N_WORKERS)
    sched = ShardedScheduler(scopes)
    for i in range(600):
        sessions[0].insert(tref(i), (i % 7, i, i * 0.5))
    sched.commit()
    assert dres.RESIDENCY_STATS["resident_batches"] > 0
    assert dres.live_resident_batches() == 0  # swept at the boundary


def test_swap_failure_raises_before_residency(monkeypatch):
    """A swap that fails on the device raises out of the commit: no batch was kept
    resident and the host gather did not deliver it instead."""
    from pathway_tpu_torch.engine.routing import EXCHANGE_STATS

    def dead_swap(payload, perm):
        raise RuntimeError("the swap died mid-collective")

    monkeypatch.setattr(cx, "bucket_swap", dead_swap)
    hosts = EXCHANGE_STATS["host_deliveries"]
    with pytest.raises(RuntimeError, match="mid-collective"):
        _run_sharded(True, monkeypatch)
    assert EXCHANGE_STATS["host_deliveries"] == hosts
    assert dres.RESIDENCY_STATS["resident_batches"] == 0
    assert cx.COLLECTIVE_STATS["exchanges"] == 0


def test_object_column_mid_chain_declines(monkeypatch):
    from pathway_tpu_torch.engine.sharded import ShardedScheduler

    def run(on):
        _set_env(monkeypatch, on)
        scopes, sessions, aggs = [], [], []
        for _w in range(N_WORKERS):
            sc = tgraph.Scope()
            sess = sc.input_session(2)
            agg = sc.group_by_table(sess, by_cols=[0], reducers=[(tred.CountReducer(), [])])
            agg._device_ops_eligible = "groupby"
            scopes.append(sc)
            sessions.append(sess)
            aggs.append(agg)
        sched = ShardedScheduler(scopes)
        for i in range(300):
            sessions[0].insert(tref(i), (i % 7, i if i % 2 else f"s{i}"))
        sched.commit()
        merged = {}
        for agg in aggs:
            merged.update(agg.current)
        return {int(k): _canon(v) for k, v in merged.items()}

    assert run(False) == run(True)
    assert cx.COLLECTIVE_STATS["declined_non_codeable"] > 0
    assert dres.RESIDENCY_STATS["resident_batches"] == 0


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_exchange_invariant_with_residency(on, monkeypatch):
    """A delivery that stays resident still counts once, on the collective plane."""
    from pathway_tpu_torch.engine.routing import EXCHANGE_STATS

    planes = ("elided", "host_deliveries", "collective_deliveries", "repartitions")
    before = {k: EXCHANGE_STATS[k] for k in planes}
    _run_sharded(on, monkeypatch)
    d = {k: EXCHANGE_STATS[k] - before[k] for k in planes}
    assert d["repartitions"] > 0 and d["collective_deliveries"] > 0
    assert d["elided"] + d["host_deliveries"] + d["collective_deliveries"] == d["repartitions"]
    assert (dres.RESIDENCY_STATS["resident_batches"] > 0) is on


# -- framework runners: the groupby feeding the join ------------------------------------------


def _chain(pw):
    t = pw.debug.table_from_rows(
        pw.schema_from_types(k=int, v=int, w=float), [(i % 50, i, i * 0.25) for i in range(800)]
    )
    g = t.groupby(t.k).reduce(k=t.k, total=pw.reducers.sum(t.v), cnt=pw.reducers.count())
    d = pw.debug.table_from_rows(
        pw.schema_from_types(k2=int, label=int), [(i, i % 3) for i in range(50)]
    )
    j = g.join(d, g.k == d.k2)
    return j.select(k=g.k, total=g.total, cnt=g.cnt, label=d.label)


def _groupby_only(pw):
    t = pw.debug.table_from_rows(
        pw.schema_from_types(k=int, v=int, w=float), [(i % 7, i, i * 0.5) for i in range(700)]
    )
    sel = t.select(k=t.k, v=t.v * 2 + 1, w=t.w)
    flt = sel.filter(sel.v > 7)
    return flt.groupby(flt.k).reduce(
        k=flt.k, total=pw.reducers.sum(flt.v), wsum=pw.reducers.sum(flt.w), cnt=pw.reducers.count()
    )


def _capture(pw, g, build, runner):
    g.clear()
    try:
        (state,) = runner.capture(build(pw))
    finally:
        g.clear()
    return {int(k): _canon(v) for k, v in state.items()}


@pytest.mark.parametrize("name", ["chain", "groupby_only"])
def test_framework_sharded_parity(name, monkeypatch):
    """Residency on and off give the same state bits, the JAX package's sharded state
    with its collective on; the placement pass (not a hand annotation) found the
    eligible consumers."""
    from pathway_tpu.internals.runner import ShardedGraphRunner as JSharded
    from pathway_tpu_torch.internals.runner import ShardedGraphRunner

    build = {"chain": _chain, "groupby_only": _groupby_only}[name]
    _set_env(monkeypatch, False, device_ops=True)
    off = _capture(tpw, TG, build, ShardedGraphRunner(N_WORKERS))
    assert dres.RESIDENCY_STATS["resident_batches"] == 0
    assert dres.RESIDENCY_STATS["device_consumes"] == 0
    _set_env(monkeypatch, True, device_ops=True)
    on = _capture(tpw, TG, build, ShardedGraphRunner(N_WORKERS))
    assert off == on
    assert dres.RESIDENCY_STATS["resident_batches"] > 0
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")  # the JAX package's forced ops need x64
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_RESIDENCY", "0")
    assert _capture(jpw, JG, build, JSharded(N_WORKERS)) == on


def test_framework_matches_one_worker(monkeypatch):
    from pathway_tpu_torch.internals.runner import GraphRunner, ShardedGraphRunner

    _set_env(monkeypatch, False, device_ops=True)
    base = _capture(tpw, TG, _chain, GraphRunner())
    _set_env(monkeypatch, True, device_ops=True)
    assert _capture(tpw, TG, _chain, ShardedGraphRunner(N_WORKERS)) == base


def _join_run(pkg, monkeypatch, residency, device_ops="1", commits=2, joins_out=None):
    """A raw-scope inner join over 4 workers of the package ``pkg`` (its ``engine``
    modules): each side's bulk commit is read on worker 0 and repartitioned by the join
    key, so every join replica receives one part a side (a resident one under
    residency, whose int64 key column gives the matcher its twin)."""
    graph = importlib.import_module(pkg.__name__ + ".engine.graph")
    sharded = importlib.import_module(pkg.__name__ + ".engine.sharded")
    ref = importlib.import_module(pkg.__name__ + ".engine.value").ref_scalar
    _set_env(monkeypatch, residency)
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", device_ops)
    scopes, lefts, rights, joins = [], [], [], []
    for _w in range(N_WORKERS):
        sc = graph.Scope()
        left, right = sc.input_session(2), sc.input_session(2)
        join = sc.join_tables(left, right, [0], [0])
        join._device_ops_eligible = "join"  # what the placement pass stamps
        scopes.append(sc)
        lefts.append(left)
        rights.append(right)
        joins.append(join)
    sched = sharded.ShardedScheduler(scopes)
    for c in range(commits):
        for i in range(600):
            lefts[0].insert(ref(c * 1000 + i), (i % 50 + c, i * 3))
        for i in range(300):
            rights[0].insert(ref(10_000 + c * 1000 + i), (i % 60, float(i) * 0.5))
        sched.commit()
        assert dres.live_resident_batches() == 0
    if joins_out is not None:
        joins_out.extend(joins)
    merged = {}
    for join in joins:
        merged.update(join.current)
    return {int(k): _canon(v) for k, v in merged.items()}


def test_join_consumes_device_key_twins(monkeypatch):
    """Resident deliveries give the join's sides device twins of their int64 key, which
    the matcher consumes in place of uploads; the output is the twin-less run's and the
    JAX package's."""
    off = _join_run(tpw, monkeypatch, False)
    assert dres.RESIDENCY_STATS["device_consumes"] == 0
    h2d_off = dres.stats()["h2d"]["bytes"]
    dres.reset_counters()
    on = _join_run(tpw, monkeypatch, True)
    assert on == off and len(on) > 0
    consumed = dres.RESIDENCY_STATS["device_consumes"]
    assert consumed > 0 and dres.stats()["bytes_saved"] >= 8 * consumed
    assert dres.stats()["h2d"]["bytes"] < h2d_off
    assert _join_run(jpw, monkeypatch, False, device_ops="0") == on


def test_join_blocks_keep_no_device_twins(monkeypatch):
    """A twin serves the commit that delivered it: the blocks the join keeps hold no
    device tensor, so device memory does not grow with the join's state."""
    joins = []
    on = _join_run(tpw, monkeypatch, True, commits=4, joins_out=joins)
    assert dres.RESIDENCY_STATS["device_consumes"] > 0
    blocks = [blk for j in joins for blk in j._blocks_left + j._blocks_right]
    assert len(blocks) >= 4 * N_WORKERS and all(blk.dev_jks is None for blk in blocks)
    dres.reset_counters()
    assert _join_run(tpw, monkeypatch, False, commits=4) == on


def test_join_consumes_a_twin_only_when_unified_by_identity():
    """The matcher takes a twin only when the array it would upload is the array the
    twin mirrors; a cast in the unification drops it."""
    la = np.arange(40, dtype=np.int64) % 7
    ra = np.arange(9, dtype=np.int64)
    twin_l = torch.from_numpy(la.copy())
    got = dops.match_pairs([la], [ra], l_dev=twin_l)
    assert dres.RESIDENCY_STATS["device_consumes"] == 1
    assert dres.stats()["h2d"]["bytes"] == ra.nbytes and dres.stats()["bytes_saved"] == la.nbytes
    want = tgraph._match_join_pairs(la, ra)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    dres.reset_counters()
    la32 = la.astype(np.int32)  # its codes are a widened copy: the twin is dropped
    got = dops.match_pairs([la32], [ra], l_dev=twin_l)
    assert dres.RESIDENCY_STATS["device_consumes"] == 0
    assert dres.stats()["h2d"]["bytes"] == la.nbytes + ra.nbytes
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


class TestCheckpointCompat:
    """Resident batches decay at commit boundaries, so a snapshot taken with residency
    on restores with it off, and the other way round."""

    def _snap(self, on, backend, monkeypatch, restore_only=False):
        from pathway_tpu_torch.engine.persistence import OperatorSnapshotManager
        from pathway_tpu_torch.engine.sharded import ShardedScheduler

        _set_env(monkeypatch, on)
        scopes, sessions, aggs = _build_scopes(N_WORKERS)
        mgr = OperatorSnapshotManager(backend)
        if restore_only:
            assert mgr.restore(scopes, []) is not None
        else:
            sched = ShardedScheduler(scopes)
            for i in range(600):
                sessions[0].insert(tref(i), (i % 7, i, i * 0.5))
            sched.commit()
            for i in range(100, 150):
                sessions[0].remove(tref(i), (i % 7, i, i * 0.5))
            sched.commit()
            mgr.snapshot(scopes, [], sched.time)
        merged = {}
        for agg in aggs:
            merged.update(agg.current)
        return {int(k): _canon(v) for k, v in merged.items()}

    @pytest.mark.parametrize("snap_on,restore_on", [(True, False), (False, True)])
    def test_cross_restore(self, snap_on, restore_on, monkeypatch):
        from pathway_tpu_torch.engine.persistence import MemoryBackend

        backend = MemoryBackend()
        live = self._snap(snap_on, backend, monkeypatch)
        assert self._snap(restore_on, backend, monkeypatch, restore_only=True) == live


def test_distributed_single_process_residency(monkeypatch):
    from pathway_tpu_torch.engine import distributed as dist

    def run(on):
        _set_env(monkeypatch, on)
        scopes, sessions, aggs = [], [], []
        for _w in range(2):
            sc = tgraph.Scope()
            sess = sc.input_session(2)
            agg = sc.group_by_table(
                sess, by_cols=[0], reducers=[(tred.SumReducer(), [1]), (tred.CountReducer(), [])]
            )
            agg._device_ops_eligible = "groupby"
            scopes.append(sc)
            sessions.append(sess)
            aggs.append(agg)
        transport = dist.MeshTransport(0, 1, addresses=[("127.0.0.1", 0)])
        try:
            sched = dist.DistributedScheduler(scopes, 0, 1, transport,
                                              n_shared=len(scopes[0].nodes))
            sched.announce_topology()
            for i in range(500):
                sessions[0].insert(tref(i), (i % 13, float(i)))
            sched.commit_local()
            for i in range(50, 80):
                sessions[0].remove(tref(i), (i % 13, float(i)))
            sched.commit_local()
        finally:
            transport.close()
        merged = {}
        for agg in aggs:
            merged.update(agg.current)
        return {int(k): _canon(v) for k, v in merged.items()}

    off = run(False)
    assert dres.RESIDENCY_STATS["resident_batches"] == 0
    on = run(True)
    assert off == on and dres.RESIDENCY_STATS["resident_batches"] > 0


# -- chain-aware placement --------------------------------------------------------------------


class TestChainAwarePlacement:
    """The seam credit against the JAX package's policy on the same calls."""

    def _policies(self):
        return [
            mod.PlacementPolicy(enabled_fn=lambda: True, forced_fn=lambda: False,
                                min_rows_fn=lambda: 0)
            for mod in (tplace, jplace)
        ]

    def _probe(self, pol, host_ns, device_ns):
        for _ in range(pol.PROBE_CALLS):
            pol.record("groupby", 1, False, 1, host_ns)
        for _ in range(pol.PROBE_CALLS):
            pol.record("groupby", 1, True, 1, device_ns)

    @pytest.mark.parametrize("residency,neighbour,flips", [
        ("1", True, True), ("0", True, False), ("1", False, False)
    ], ids=["credit", "residency_off", "neighbour_on_host"])
    def test_seam_credit(self, monkeypatch, residency, neighbour, flips):
        monkeypatch.setenv("PATHWAY_TPU_DEVICE_RESIDENCY", residency)
        got = []
        for pol in self._policies():
            # the card measures a little slower than the host: host under hysteresis
            self._probe(pol, host_ns=100, device_ns=110)
            assert not pol.choose("groupby", 1, 1000)
            pol.seed("join", 2, device=neighbour)
            pol.link("groupby", 1, "join", 2)
            pol.record_seam("groupby", 1, 1, 50)
            got.append((pol.choose("groupby", 1, 1000), pol.decisions()))
        assert got[0] == got[1]
        assert got[0][0] is flips
        dec = got[0][1]["groupby:1"]
        assert dec["links"] == ["join:2"] and dec["seam_events"] == 1
        assert dec["seam_ns_per_row"] == 50.0


def test_a_run_records_real_seams(monkeypatch):
    """Resident deliveries materialized at the groupbys report their cost to the
    groupbys' seams, which chain-aware placement reads."""
    from pathway_tpu_torch.internals.runner import ShardedGraphRunner

    _set_env(monkeypatch, True, device_ops=True)
    _capture(tpw, TG, _chain, ShardedGraphRunner(N_WORKERS))
    decisions = tplace.POLICY.decisions()
    assert any(d["seam_events"] > 0 for d in decisions.values())
    assert any(d["links"] for d in decisions.values())
