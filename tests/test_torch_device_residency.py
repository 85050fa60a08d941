"""The port's single-card residency plane (``engine/device_residency.py``): the transfer
counters and their metric families, the commit-boundary decay, the seam keys placement
reads, and the ``PATHWAY_TPU_DEVICE_RESIDENCY`` modes; each against the JAX package's
where the JAX package can run here.

The device operators' upload and fetch are counted at their tensors' sizes: the
segment reduction uploads one ``[1 + columns, rows]`` int64 stack and fetches one ``[1 +
columns, groups]`` int64 block; the matcher uploads both key arrays and fetches the two
index arrays. The operators run on CPU tensors here, where the counts are the same.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import device_residency as jres
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu.optimize import placement as jplace
from pathway_tpu_torch.engine import device_ops as dops
from pathway_tpu_torch.engine import device_pipeline as dp
from pathway_tpu_torch.engine import device_residency as dres
from pathway_tpu_torch.engine import graph as tgraph
from pathway_tpu_torch.engine import reducers as tred
from pathway_tpu_torch.engine.value import ref_scalar as tref
from pathway_tpu_torch.internals import metrics as tmetrics
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.optimize import placement as tplace


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("PATHWAY_TPU_DEVICE_OPS", "PATHWAY_TPU_DEVICE_RESIDENCY"):
        monkeypatch.delenv(var, raising=False)
    dops.configure(device="cpu")
    dres.reset_counters()
    dops.reset_counters()
    tplace.POLICY.reset()
    yield
    dops.configure()
    dres.reset_counters()
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
    s = dp.PIPELINE.stats()
    assert s["device_residency"]["forced"] is True
    assert s["device_ops"]["enabled"] is True
    assert s["collective_exchange"] is None  # the sharded runners' plane


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
