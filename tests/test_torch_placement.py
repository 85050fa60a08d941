"""The port's measurement-driven placement (``optimize/placement.py``) against the JAX
package's.

``PlacementPolicy`` is pure Python and deterministic given its calls: both packages'
policies are driven with the same synthetic ``choose`` / ``record`` sequences
(bootstrap, hysteresis, the re-probe every 256 calls, a drifting cost, ``min_rows``,
forced and disabled gates, chain credit with residency on and off), and every decision
and the final ``decisions()`` snapshot must be equal. The placement pass's eligible and
placed counts, seeds and links on the JAX package's optimizer corpus equal the JAX
package's under ``PATHWAY_TPU_DEVICE_OPS=1``.

Through the engine: in auto mode the groupby and the join consult the policy (each side
probed ``PROBE_CALLS`` times), under ``=1`` they bypass it, under ``=0`` they keep the
host kernels, and every mode gives the host kernels' bits. On this CPU box auto mode is
engaged by declaring the configured CPU device a card (``configured_on_card``), so the
device operators run their plain versions on CPU tensors; with no card and the default
device, auto mode raises at the first batch it places on the card.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu.optimize import placement as jplace
from pathway_tpu_torch.engine import device_ops as dops
from pathway_tpu_torch.engine import graph as tgraph
from pathway_tpu_torch.engine import reducers as tred
from pathway_tpu_torch.engine.value import ref_scalar as tref
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.optimize import placement as tplace


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("PATHWAY_TPU_DEVICE_OPS", raising=False)
    monkeypatch.delenv("PATHWAY_TPU_DEVICE_OPS_MIN_ROWS", raising=False)
    monkeypatch.delenv("PATHWAY_TPU_DEVICE_RESIDENCY", raising=False)
    dops.configure(device="cpu")
    tplace.POLICY.reset()
    yield
    dops.configure()
    tplace.POLICY.reset()
    jplace.POLICY.reset()
    TG.clear()
    JG.clear()


# -- the policy under synthetic calls -------------------------------------------------


def _cost(step: int, device: bool, scenario: str) -> int:
    """ns per row of one side at one step (deterministic)."""
    if scenario == "device_wins":
        return 50 if device else 100
    if scenario == "host_wins":
        return 100 if device else 50
    if scenario == "inside_hysteresis":
        return 90 if device else 100  # 10% cheaper: no flip
    if scenario == "past_hysteresis":
        return 70 + step % 3 if device else 100
    if scenario == "drift":
        # the card wins first, then loses from step 300: the re-probe finds it
        if step < 300:
            return 40 if device else 100
        return 400 if device else 100
    if scenario == "noisy":
        return (60 + (step * 37) % 90) if device else (70 + (step * 53) % 70)
    raise AssertionError(scenario)


SCENARIOS = ["device_wins", "host_wins", "inside_hysteresis", "past_hysteresis", "drift", "noisy"]


def _drive(pol, scenario: str, steps: int = 700, rows=lambda s: 1000) -> list:
    seq = []
    for step in range(steps):
        n = rows(step)
        dev = pol.choose("groupby", 3, n)
        seq.append(dev)
        pol.record("groupby", 3, dev, n, _cost(step, dev, scenario) * n)
    return seq


def _policies(enabled=True, forced=False, min_rows=512):
    gates = dict(
        enabled_fn=lambda: enabled, forced_fn=lambda: forced, min_rows_fn=lambda: min_rows
    )
    return jplace.PlacementPolicy(**gates), tplace.PlacementPolicy(**gates)


def test_the_policy_constants_are_the_reference_s():
    for name in ("PROBE_CALLS", "HYSTERESIS", "REPROBE_EVERY"):
        assert getattr(tplace.PlacementPolicy, name) == getattr(jplace.PlacementPolicy, name)
    assert tplace._ALPHA == jplace._ALPHA
    assert (tplace.PlacementPolicy.PROBE_CALLS, tplace.PlacementPolicy.HYSTERESIS,
            tplace.PlacementPolicy.REPROBE_EVERY, tplace._ALPHA) == (3, 1.2, 256, 0.3)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_decision_sequence_matches_the_reference(scenario):
    jpol, tpol = _policies()
    want = _drive(jpol, scenario)
    got = _drive(tpol, scenario)
    assert got == want
    assert tpol.decisions() == jpol.decisions()
    # bootstrap: three calls on the card, then three on the host
    assert got[:6] == [True] * 3 + [False] * 3


def test_drift_is_recovered_by_the_reprobe():
    _jpol, tpol = _policies()
    seq = _drive(tpol, "drift")
    assert seq[299] is True  # the card won the first phase
    assert seq[-1] is False  # the re-probe saw it lose and flipped to the host
    st = tpol.decisions()["groupby:3"]
    assert st["device"] is False and st["host_calls"] > 3 and st["device_calls"] > 3


@pytest.mark.parametrize(
    "gates", [dict(min_rows=512), dict(min_rows=0), dict(forced=True), dict(enabled=False)],
    ids=["min_rows_512", "min_rows_0", "forced", "disabled"],
)
def test_gates_match_the_reference(gates):
    """Batches alternate below and above ``min_rows``."""
    jpol, tpol = _policies(**gates)
    rows = lambda s: 100 if s % 3 == 0 else 2000  # noqa: E731
    want = _drive(jpol, "noisy", steps=400, rows=rows)
    got = _drive(tpol, "noisy", steps=400, rows=rows)
    assert got == want
    assert tpol.decisions() == jpol.decisions()
    if gates.get("forced"):
        assert all(got)
    if gates.get("enabled") is False:
        assert not any(got)


def _probe(pol, host_ns, device_ns):
    # host first, so record()'s bootstrap credit does not pre-place on the card
    for _ in range(pol.PROBE_CALLS):
        pol.record("groupby", 1, False, 1, host_ns)
    for _ in range(pol.PROBE_CALLS):
        pol.record("groupby", 1, True, 1, device_ns)


@pytest.mark.parametrize("residency", ["1", "0"])
@pytest.mark.parametrize("neighbour_on_card", [True, False])
def test_chain_credit_matches_the_reference(monkeypatch, residency, neighbour_on_card):
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_RESIDENCY", residency)
    out = []
    for pol in _policies(min_rows=0):
        _probe(pol, host_ns=100, device_ns=110)
        first = pol.choose("groupby", 1, 1000)
        pol.seed("join", 2, device=True if neighbour_on_card else None)
        pol.link("groupby", 1, "join", 2)
        pol.record_seam("groupby", 1, 1, 50)
        second = pol.choose("groupby", 1, 1000)
        out.append((first, second, pol.is_device("groupby", 1), pol.decisions()))
    assert out[1] == out[0]
    first, second, _on, dec = out[1]
    assert first is False
    # the seam credit flips the placement only with residency on and the neighbour on
    # the card
    assert second is (residency == "1" and neighbour_on_card)
    assert dec["groupby:1"]["links"] == ["join:2"] and dec["groupby:1"]["seam_events"] == 1
    assert dec["groupby:1"]["seam_ns_per_row"] == 50.0


def test_reset_clears_stats_and_links():
    _jpol, tpol = _policies()
    tpol.link("groupby", 1, "join", 2)
    tpol.reset()
    assert tpol.decisions() == {}


@pytest.mark.parametrize("raw", [None, "0", "100", "-5", "many"])
def test_min_rows_reads_the_reference_s_variable(monkeypatch, raw):
    if raw is not None:
        monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS_MIN_ROWS", raw)
    assert tplace.min_rows() == jplace.min_rows()


# -- the default policy's gates --------------------------------------------------------


@pytest.mark.parametrize(
    "flag,device,rows,want",
    [
        ("0", "cpu", 10_000, False),
        ("1", "cpu", 1, True),  # forced: even a 1-row batch
        ("force", "cpu", 1, True),
        (None, "cpu", 10_000, False),  # auto on a CPU device: host kernels
        (None, None, 10_000, True),  # auto on the card: bootstrap probes the card
        (None, None, 511, False),  # below min_rows
        (None, "cuda", 10_000, True),
    ],
)
def test_default_policy_modes(monkeypatch, flag, device, rows, want):
    if flag is not None:
        monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", flag)
    dops.configure(device=device)
    assert tplace.POLICY.choose("join", 0, rows) is want
    assert dops.forced() is (flag in ("1", "force"))


def test_env_contract(monkeypatch):
    for flag, enabled, forced in (("0", False, False), ("off", False, False),
                                  ("1", True, True), ("force", True, True)):
        monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", flag)
        assert (dops.enabled(), dops.forced()) == (enabled, forced)
    monkeypatch.delenv("PATHWAY_TPU_DEVICE_OPS")
    dops.configure(device="cpu")
    assert (dops.enabled(), dops.forced()) == (False, False)
    dops.configure()
    assert (dops.enabled(), dops.forced()) == (True, False)
    assert "placement" in dops.stats() and dops.stats()["forced"] is False


# -- the placement pass on the optimizer corpus --------------------------------------


def _corpus(pw, name):
    if name == "groupby":
        t = pw.debug.table_from_rows(
            pw.schema_from_types(k=str, v=int), [(f"k{i % 5}", i) for i in range(60)]
        )
        sel = t.select(k=t.k, v=t.v * 2 + 1)
        flt = sel.filter(sel.v > 7)
        return flt.groupby(flt.k).reduce(
            k=flt.k, total=pw.reducers.sum(flt.v), cnt=pw.reducers.count()
        )
    if name == "join":
        orders = pw.debug.table_from_rows(
            pw.schema_from_types(oid=int, cust=str, amount=float),
            [(i, f"c{i % 4}", float(i) * 1.5) for i in range(40)],
        )
        custs = pw.debug.table_from_rows(
            pw.schema_from_types(name=str, region=str),
            [(f"c{i}", f"r{i % 2}") for i in range(4)],
        )
        j = orders.join(custs, orders.cust == custs.name)
        return j.select(cust=orders.cust, region=custs.region, amount=orders.amount)
    if name == "join_groupby":
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
    if name == "temporal":
        tmp = importlib.import_module(pw.__name__ + ".stdlib.temporal")
        t = pw.debug.table_from_rows(
            pw.schema_from_types(t=int, k=str, v=int),
            [(i % 23, f"k{i % 3}", i) for i in range(50)],
        )
        win = t.windowby(t.t, window=tmp.tumbling(duration=10), instance=t.k)
        return win.reduce(
            instance=pw.this["_pw_instance"],
            start=pw.this["_pw_window_start"],
            total=pw.reducers.sum(pw.this.v),
        )
    raise AssertionError(name)


def _pass(pw, place, name):
    runner_mod = importlib.import_module(pw.__name__ + ".internals.runner")
    runner = runner_mod.GraphRunner()
    runner.build(_corpus(pw, name))
    place.POLICY.reset()
    counts = place.run_pass([runner.scope])
    seams = {
        n.index: (getattr(n, "_device_ops_eligible", None),
                  getattr(n, "_device_residency_downstream", None))
        for n in runner.scope.nodes
    }
    return counts, place.POLICY.decisions(), seams


@pytest.mark.parametrize("name", ["groupby", "join", "join_groupby", "temporal"])
@pytest.mark.parametrize("flag", ["1", "0"])
def test_run_pass_matches_the_reference_on_the_corpus(monkeypatch, name, flag):
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", flag)
    got = _pass(tpw, tplace, name)
    want = _pass(jpw, jplace, name)
    assert got == want
    if flag == "1":
        assert got[0][0] > 0 and got[0][0] == got[0][1]  # forced: every one placed
    else:
        assert got[0] == (0, 0) and got[1] == {}


# -- through the engine ------------------------------------------------------------------


def _program(scope):
    """A groupby (count, sum of an int and a float column) and an inner join of the
    groupby's output with a dimension table, both fed per commit."""
    facts = scope.input_session(3)
    dims = scope.input_session(2)
    gb = scope.group_by_table(
        facts,
        by_cols=[0],
        reducers=[
            (tred.make_reducer(tred.ReducerKind.COUNT), []),
            (tred.make_reducer(tred.ReducerKind.SUM), [1]),
            (tred.make_reducer(tred.ReducerKind.SUM), [2]),
        ],
    )
    j = scope.join_tables(facts, dims, [0], [0])
    return facts, dims, gb, j


def _commits(seed=3, n_commits=8, rows=600):
    rng = np.random.default_rng(seed)
    out = []
    for c in range(n_commits):
        keys = rng.integers(0, 97, rows)
        ints = rng.integers(-1000, 1000, rows)
        floats = rng.standard_normal(rows)
        out.append([
            (tref(c * rows + i), (int(k), int(a), float(f)))
            for i, (k, a, f) in enumerate(zip(keys, ints, floats))
        ])
    return out


def _bits(node) -> dict:
    return {
        int(k): tuple(np.float64(x).view(np.int64).item() if isinstance(x, float) else x
                      for x in row)
        for k, row in node.current.items()
    }


def _drive_engine(commits):
    scope = tgraph.Scope()
    facts, dims, gb, j = _program(scope)
    sched = tgraph.Scheduler(scope)
    for d in range(97):
        dims.insert(tref(10**9 + d), (d, d * 3))
    for rows in commits:
        for k, r in rows:
            facts.insert(k, r)
        sched.commit()
    return gb, j, _bits(gb), _bits(j)


@pytest.mark.parametrize("mode", ["auto", "forced", "host"])
def test_groupby_and_join_follow_the_mode_and_give_the_host_bits(monkeypatch, mode):
    commits = _commits()
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")
    _gb0, _j0, want_gb, want_j = _drive_engine(commits)
    tplace.POLICY.reset()
    if mode == "forced":
        monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "1")
    elif mode == "auto":
        monkeypatch.delenv("PATHWAY_TPU_DEVICE_OPS")
        monkeypatch.setattr(dops, "configured_on_card", lambda: True)
        dops.configure(device="cpu")
    gb, j, got_gb, got_j = _drive_engine(commits)
    assert got_gb == want_gb and got_j == want_j
    dec = tplace.POLICY.decisions()
    if mode == "host":
        assert dec == {} and gb.routes["device"] == 0 and j.routes["device"] == 0
        return
    for key, node in ((f"groupby:{gb.index}", gb), (f"join:{j.index}", j)):
        st = dec[key]
        if mode == "forced":
            # the policy is bypassed: every batch on the card, nothing probed on the host
            assert st["host_calls"] == 0 and st["device_calls"] == len(commits)
            assert node.routes["host"] == 0
        else:
            assert st["host_calls"] >= tplace.PlacementPolicy.PROBE_CALLS
            assert st["device_calls"] >= tplace.PlacementPolicy.PROBE_CALLS
            assert st["host_calls"] + st["device_calls"] == len(commits)


def test_auto_mode_with_no_card_raises(monkeypatch):
    """The default device is the card: with none, the first batch placed on it raises
    (no fallback to the host)."""
    if dops.torch.cuda.is_available():
        pytest.skip("this box has a card")
    dops.configure()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _drive_engine(_commits(n_commits=1))
