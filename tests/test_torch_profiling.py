"""The port's sampling profiler against the JAX package's (``internals/profiling.py``):
``classify_stack`` is equal on the same frames, each path given in both packages' form;
the sampler's folding, adaptive period and epoch fence agree for the same inputs; the
documents (``profile_document``, ``merge_documents``, ``phase_totals``,
``folded_text``, ``speedscope``, ``validate_profile``,
``reconcile_with_critical_path``) are equal on the same payloads. On this box, which
has no card, ``device_counters()`` has no memory section and makes no CUDA context; a
profiled ``pw.run`` exports a document that both validators accept."""

from __future__ import annotations

import copy
import json
import os
import threading
import time

import pytest
import torch

import pathway_tpu_torch as tpw
from pathway_tpu.internals import profiling as jpr
from pathway_tpu_torch.engine import device_ops as tdops
from pathway_tpu_torch.engine import device_pipeline as tdp
from pathway_tpu_torch.internals import metrics as tm
from pathway_tpu_torch.internals import profiling as tpr
from pathway_tpu_torch.internals.parse_graph import G as TG

BOTH = {"jax": jpr, "torch": tpr}


@pytest.fixture(autouse=True)
def _reset():
    yield
    tpr.PROFILER.stop()
    tpr.PROFILER.configure(enabled=False, clear=True)
    TG.clear()


def _payload(worker: int = 0, seq: int = 1, epoch: int = 0, samples=None) -> dict:
    if samples is None:
        samples = [["operator", "runner:main;graph:process", 0.5, 5]]
    return {"v": 1, "worker": worker, "pid": 40000 + worker, "seq": seq, "epoch": epoch,
            "wall_s": 1.0, "rate_hz": 50.0, "samples": samples,
            "sample_count": sum(int(s[3]) for s in samples), "dropped_stacks": 0, "device": {}}


class _Code:
    def __init__(self, filename: str, name: str) -> None:
        self.co_filename = filename
        self.co_name = name


class _Frame:
    def __init__(self, code: _Code, back) -> None:
        self.f_code = code
        self.f_back = back


def _chain(*pairs: tuple[str, str]) -> _Frame:
    """A frame chain from leaf-first ``(filename, func)`` pairs -> its leaf frame."""
    frame = None
    for filename, func in reversed(pairs):
        frame = _Frame(_Code(filename, func), frame)
    return frame


STACKS = [
    [("engine/reducers.py", "step"), ("engine/graph.py", "process"),
     ("engine/distributed.py", "_exchange_rounds")],
    [("engine/distributed.py", "_exchange_rounds")],
    [("engine/distributed.py", "_metrics_snapshot")],
    [("serving/server.py", "do_GET")],
    [("serving/snapshot.py", "read")],
    [("engine/device_pipeline.py", "_complete"), ("engine/device.py", "decay")],
    [("engine/device_ops.py", "groupby_commit")],
    [("engine/connectors.py", "poll"), ("internals/runner.py", "_pump_drivers")],
    [("engine/routing.py", "route_batch")],
    [("engine/graph.py", "process")],
    [("engine/temporal.py", "advance")],
    [("engine/external_index.py", "process")],
    [("engine/batch.py", "consolidate")],
    [("engine/expression.py", "evaluate")],
    [("optimize/fuse.py", "process"), ("engine/graph.py", "propagate")],
    [("/usr/lib/python3.12/threading.py", "wait")],
    [],
]


@pytest.mark.parametrize("stack", STACKS)
@pytest.mark.parametrize("root", ["/site/pathway_tpu", "/site/pathway_tpu_torch",
                                  "C:\\site\\pathway_tpu_torch"])
def test_classify_stack_is_equal_in_both_path_forms(stack, root):
    sep = "\\" if root.startswith("C:") else "/"
    frames = [(p if p.startswith("/usr") else root + sep + p.replace("/", sep), f)
              for p, f in stack]
    assert tpr.classify_stack(frames) == jpr.classify_stack(frames)
    # the port's own files and the reference's classify alike
    ref = [(p if p.startswith("/usr") else "/site/pathway_tpu/" + p, f) for p, f in stack]
    assert tpr.classify_stack(frames) == jpr.classify_stack(ref)


def test_the_completion_thread_classifies_as_device():
    """The pipeline's completion thread, parked in a CUDA event's sync, is device time."""
    from pathway_tpu_torch.engine import device, device_pipeline

    frames = [(torch.cuda.__file__, "synchronize"), (device.__file__, "decay"),
              (device_pipeline.__file__, "_run")]
    assert tpr.classify_stack(frames) == "device"


def test_folding_adaptive_period_and_fence_agree():
    got = {}
    for name, pr in BOTH.items():
        p = pr.SampleProfiler(enabled=False)
        frames = {
            1: _chain(("/site/engine/graph.py", "process"), ("/site/runner.py", "run")),
            2: _chain(("/site/engine/connectors.py", "poll")),
            3: _chain(*[(f"/site/m{i}.py", f"f{i}") for i in range(pr.MAX_DEPTH + 5)]),
            9: _chain(("/site/engine/graph.py", "process")),
        }
        n = [p._ingest(frames, own_tid=9, weight=0.02) for _ in range(3)]
        folded = {k: [round(v[0], 9), v[1]] for k, v in p._folded.items()}
        periods = []
        p.configure(enabled=False, hz=50.0)
        for cost in [0.01] * 5 + [0.0] * 8 + [1.0] * 12:
            p._adapt(cost)
            periods.append((p.period, p._overhead_ema))
        fence = [p.absorb(1, _payload(worker=1, seq=2, epoch=1)),
                 p.absorb(1, _payload(worker=1, seq=1, epoch=1)),
                 p.absorb(2, _payload(worker=2, epoch=0)), p.epoch,
                 p.absorb(3, {"epoch": "x"})]
        p.prune(dead=(5,), width=2)
        fence.append(sorted(p._peers))
        got[name] = (n, folded, periods, fence)
    assert got["jax"] == got["torch"]
    assert got["torch"][3] == [True, False, False, 1, False, [1]]


def test_stack_overflow_folds_into_truncated_alike(monkeypatch):
    got = {}
    for name, pr in BOTH.items():
        monkeypatch.setattr(pr, "MAX_STACKS", 4)
        p = pr.SampleProfiler(enabled=False)
        for i in range(10):
            p._ingest({1: _chain((f"/site/engine/graph.py{i}", "process"))}, own_tid=0, weight=0.1)
        got[name] = (sorted(p._folded), p._dropped, p._samples)
    assert got["jax"] == got["torch"]
    assert ("operator", "(truncated)") in got["torch"][0]


def _docs(pr) -> list[dict]:
    return [
        pr.profile_document({1: _payload(worker=1), 0: _payload(worker=0)}),
        pr.profile_document({0: _payload(seq=1, samples=[["ingest", "a:b", 0.1, 1]])}),
        pr.profile_document({0: _payload(seq=5, samples=[["device", "c:d", 0.2, 2]]),
                             2: _payload(worker=2, samples=[["exchange", "a:b;e:f", 0.25, 2],
                                                            ["other", "x:y", 0.125, 1],
                                                            ["serving", "s:t", 0.5, 3]])}),
    ]


def test_documents_are_equal():
    got = {}
    for name, pr in BOTH.items():
        docs = _docs(pr)
        merged = pr.merge_documents(docs[1:][::-1])
        cp = {"wall_s": 1.0, "host_compute_s": 0.5, "exchange_s": 0.1, "queue_wait_s": 0.3,
              "device_s": 0.1}
        cp_shares = dict(cp, shares={"host_compute": 0.2, "exchange": 0.2, "queue_wait": 0.4,
                                     "device": 0.2})
        got[name] = (
            docs, merged, [pr.phase_totals(d) for d in docs],
            [pr.folded_text(d) for d in docs], pr.folded_text({"workers": {}}),
            [pr.speedscope(d) for d in docs],
            [pr.validate_profile(copy.deepcopy(d)) for d in docs],
            [pr.reconcile_with_critical_path(d, c) for d in docs for c in (cp, cp_shares)],
            pr.reconcile_with_critical_path({"operator": 1.0, "ingest": 1.0}, cp),
        )
    assert got["jax"] == got["torch"]
    assert got["torch"][1]["workers"]["0"]["seq"] == 5


MUTATIONS = [
    lambda d: d.update(version=99),
    lambda d: d.update(workers={}),
    lambda d: d.update(workers=[1]),
    lambda d: d["workers"]["0"].update(samples=[["warp", "a:b", 0.1, 1]]),
    lambda d: d["workers"]["0"].update(samples=[["operator", "", 0.1, 1]]),
    lambda d: d["workers"]["0"].update(samples=[["operator", "a:b", -0.1, 1]]),
    lambda d: d["workers"]["0"].update(samples=[["operator", "a:b", float("nan"), 1]]),
    lambda d: d["workers"]["0"].update(samples=[["operator", "a:b", float("inf"), 1]]),
    lambda d: d["workers"]["0"].update(samples=[["operator", "a:b", 0.1, 0]]),
    lambda d: d["workers"]["0"].update(samples=[["operator", "a:b", 0.1]]),
    lambda d: d["workers"]["0"].update(samples="x"),
    lambda d: d["workers"]["0"].update(epoch=-1),
    lambda d: d["workers"].update({"0": 3}),
    lambda d: d.clear(),
]


@pytest.mark.parametrize("i", range(len(MUTATIONS)))
def test_validate_profile_rejects_alike(i):
    outs = []
    for pr in BOTH.values():
        doc = pr.profile_document({0: _payload()})
        MUTATIONS[i](doc)
        try:
            outs.append(("ok", pr.validate_profile(doc)))
        except Exception as e:  # the type is what is compared
            outs.append(("raise", type(e)))
    assert outs[0] == outs[1] and outs[1][0] == "raise"


def test_device_counters_on_a_box_without_a_card():
    assert not torch.cuda.is_initialized()
    tdops.reset_counters()
    try:
        with tdops._LOCK:
            tdops._NS["segment_reduce"] = 11
        tpr._TELEMETRY_CACHE[0] = float("-inf")
        out = tpr.device_counters()
        assert "memory" not in out
        assert out["kernel_ns"]["device_ops.segment_reduce"] == 11
        assert not torch.cuda.is_initialized()
        snap = tm.REGISTRY.snapshot()
        assert "pathway_device_memory_bytes" not in snap
        assert not torch.cuda.is_initialized()
    finally:
        tdops.reset_counters()
    # no gauge of the JAX package's compile cache or live arrays
    assert not any(n.startswith("pathway_jax_") for n in tm.REGISTRY.snapshot())


def test_live_sampler_collects_and_both_validators_accept():
    p = tpr.SampleProfiler(enabled=True, hz=500.0)
    assert p.maybe_start() and p.running
    assert p.maybe_start()  # one thread
    end = time.monotonic() + 0.3
    while time.monotonic() < end:
        sum(i * i for i in range(2000))
    p.stop()
    assert not p.running
    doc = tpr.profile_document(p.mesh_payloads())
    assert doc["workers"]["0"]["sample_count"] > 0
    tpr.validate_profile(doc)
    jpr.validate_profile(json.loads(json.dumps(doc)))
    off = tpr.SampleProfiler(enabled=False)
    assert off.maybe_start() is False and not off.running


def _busy(seconds: float) -> None:
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        sum(i * i for i in range(2000))


@pytest.mark.parametrize("pkg", sorted(BOTH))
def test_the_sampler_thread_samples_the_busy_main_thread(pkg):
    """Each package's daemon thread catches the main thread in its busy frame, leaves
    its own stack out, and is gone after stop."""
    p = BOTH[pkg].SampleProfiler(enabled=True, hz=500.0)
    assert p.maybe_start() and p.running
    _busy(0.5)
    p.stop()
    assert not p.running
    assert not any(t.name == "pathway-profiler" for t in threading.enumerate())
    stacks = [stack for (_phase, stack) in p._folded]
    # the period adapts to the ticks' cost, so a loaded box takes fewer of them
    assert p._samples >= 5
    assert any("test_torch_profiling:_busy" in st for st in stacks)
    assert not any("profiling:_run" in st for st in stacks)


def test_a_raising_export_still_tears_the_run_down(monkeypatch):
    """A profiled run whose export raises (a card error read by ``device_counters``)
    raises it, and still reaps the completion thread and clears the sinks, so the next
    run does not run this one's."""
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")
    tpr.PROFILER.configure(enabled=True, hz=500.0, clear=True)

    def card_error():
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    reaped = []
    monkeypatch.setattr(tpr, "device_counters", card_error)
    monkeypatch.setattr(tdp, "stop_worker", lambda: reaped.append(True))
    seen: list = []

    def on_change(key, row, time, is_addition):
        _busy(0.05)  # the sampler takes ticks, so the export reads the counters
        seen.append(row["v"])

    t = tpw.debug.table_from_markdown("v\n1\n2")
    tpw.io.subscribe(t, on_change=on_change)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tpw.run()
    assert reaped == [True] and not TG.sinks and not tpr.PROFILER.running
    assert sorted(seen) == [1, 2]


def test_profiled_run_exports_a_document(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")  # no card here: the host kernels
    tpr.PROFILER.configure(enabled=True, hz=500.0, clear=True)

    class Feed(tpw.io.python.ConnectorSubject):
        def run(self):
            for c in range(3):
                for i in range(500):
                    self.next(k=i % 7, v=c * 1000 + i)
                time.sleep(0.05)

    t = tpw.io.python.read(Feed(), schema=tpw.schema_from_types(k=int, v=int),
                           autocommit_duration_ms=20)
    g = t.groupby(tpw.this.k).reduce(tpw.this.k, s=tpw.reducers.sum(tpw.this.v))
    tpw.io.subscribe(g, on_change=lambda **kw: None)
    tpw.run()
    assert not tpr.PROFILER.running
    (name,) = [f for f in os.listdir(tmp_path) if f.startswith("pathway_profile_p")]
    with open(tmp_path / name) as fh:
        doc = json.load(fh)
    tpr.validate_profile(doc)
    jpr.validate_profile(doc)
    assert doc["workers"]["0"]["sample_count"] > 0
    assert set(doc["phases"]) <= set(tpr.PHASES)
