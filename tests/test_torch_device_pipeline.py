"""The port's async device pipeline (``pathway_tpu_torch/engine/device_pipeline.py``)
on the CPU: the staging and completion queues, backpressure, errors, barriers, the
completion thread's lifecycle, the adaptive controller and the executor's sizer, each
case as ``tests/test_device_pipeline.py`` holds the JAX package's; then the port against
the JAX package on the same seeded inputs, and the handles' thread safety.

A handle's copy is held open by a gated stand-in for its CUDA event (the completion
thread waits on ``synchronize``, as it waits on the card's event). Timing decides no
case: controller cases call ``observe()`` directly.

Tolerances: controller stats exactly; sink keys bit for bit and vectors to 1e-6 (f32
rows made from the same inputs by numpy in one package and torch in the other).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

import pathway_tpu_torch as tpw
from pathway_tpu_torch.engine import device as tdev
from pathway_tpu_torch.engine import device_pipeline as dp
from pathway_tpu_torch.engine import expression as tex
from pathway_tpu_torch.engine.connectors import InputDriver, QueueReader
from pathway_tpu_torch.engine.graph import Scheduler, Scope
from pathway_tpu_torch.engine.value import ref_scalar
from pathway_tpu_torch.internals.udfs import batch_executor

WAIT_S = 30.0


def _pipeline_threads() -> list[str]:
    return [
        t.name
        for t in threading.enumerate()
        if t.is_alive() and t.name == "pw-device-pipeline"
    ]


@pytest.fixture(autouse=True)
def _fresh_pipeline():
    """The pipeline is a process-wide singleton: drain and reconfigure it around every
    test, and reap its completion thread after, so nothing leaks across tests."""
    tdev._LIVE_HANDLES.clear()
    dp.PIPELINE.configure()
    dp.PIPELINE.stop_worker()
    yield
    tdev._LIVE_HANDLES.clear()
    dp.PIPELINE.reset()
    dp.PIPELINE.configure()
    dp.PIPELINE.stop_worker()
    assert _pipeline_threads() == []


@pytest.fixture
def async_on(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_ASYNC_DEVICE", "1")


class _GatedEvent:
    """Stands in for the CUDA event behind a host twin's copy: ``synchronize`` waits
    for ``gate``, then raises ``fail`` or logs ``tag``."""

    def __init__(self, gate=None, log=None, tag=None, fail=None, delay_s=0.0):
        self._gate, self._log, self._tag, self._fail = gate, log, tag, fail
        self._delay_s = delay_s

    def synchronize(self) -> None:
        if self._gate is not None and not self._gate.wait(timeout=WAIT_S):
            raise TimeoutError("test gate never opened")
        if self._delay_s:
            time.sleep(self._delay_s)
        if self._fail is not None:
            raise self._fail
        if self._log is not None:
            self._log.append(self._tag)


def _handle(arr, **gate) -> tdev.DeviceBatchHandle:
    """A live batch whose host copy waits on a gated event."""
    t = torch.from_numpy(np.array(arr, np.float32))
    handle = tdev.DeviceBatchHandle(t)
    handle._pinned = t.clone()
    handle._copied = _GatedEvent(**gate)
    return handle


def _wait_for(pred, timeout=10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


# -- staging and completion -----------------------------------------------------


def test_sync_mode_decays_inline(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_ASYNC_DEVICE", "0")
    handle = tdev.DeviceBatchHandle(torch.ones(4, 2))
    dp.commit_boundary(1)
    assert handle.dev is None  # decayed before the boundary returned
    assert handle.host().shape == (4, 2)
    assert dp.PIPELINE.inflight() == 0 and dp.PIPELINE._worker is None
    assert dp.suggested_batch_size() is None


def test_async_defers_completion_until_drain(async_on):
    gate = threading.Event()
    handle = _handle(np.full((3, 2), 7.0), gate=gate)
    dp.commit_boundary(1)
    assert handle.dev is not None  # the boundary returned with the copy held open
    assert dp.PIPELINE.inflight() == 1
    gate.set()
    dp.drain()
    assert handle.dev is None and handle.host()[0, 0] == 7.0
    assert dp.PIPELINE.inflight() == 0


def test_completion_is_fifo_across_commits(async_on):
    log: list = []
    first, opened = threading.Event(), threading.Event()
    opened.set()
    h1 = _handle(np.zeros((1, 1)), gate=first, log=log, tag="a")
    dp.commit_boundary(1)
    h2 = _handle(np.zeros((1, 1)), gate=opened, log=log, tag="b")
    dp.commit_boundary(2)
    assert log == []  # commit 2 may not complete before commit 1
    first.set()
    dp.drain()
    assert log == ["a", "b"]
    assert dp.PIPELINE.completed_time() == 2
    assert h1.dev is None and h2.dev is None


def test_backpressure_bounds_inflight_to_depth(async_on):
    gate = threading.Event()
    handles = []
    for t in (1, 2):
        handles.append(_handle(np.zeros((1, 1)), gate=gate))
        dp.commit_boundary(t)
    assert dp.PIPELINE.inflight() == 2  # the default depth: double buffering
    handles.append(_handle(np.zeros((1, 1)), gate=gate))
    third = threading.Thread(target=dp.commit_boundary, args=(3,))
    third.start()
    time.sleep(0.25)
    assert third.is_alive()  # staging commit 3 waits on the bound
    assert dp.PIPELINE.inflight() == 2
    gate.set()
    third.join(timeout=WAIT_S)
    assert not third.is_alive()
    dp.drain()
    assert all(h.dev is None for h in handles)
    assert dp.PIPELINE.controller.grows >= 1  # the blocked staging fed the grow rule


@pytest.mark.parametrize("surfaces_at", ["drain", "drain_until", "next staging"])
def test_worker_error_surfaces_on_the_scheduler_thread(async_on, surfaces_at):
    bad = _handle(np.zeros((1, 1)), fail=RuntimeError("copy failed"))
    dp.commit_boundary(1)
    assert _wait_for(lambda: dp.PIPELINE.inflight() == 0)
    with pytest.raises(RuntimeError, match="copy failed"):
        if surfaces_at == "drain":
            dp.drain()
        elif surfaces_at == "drain_until":
            dp.drain_until(1)
        else:
            nxt = _handle(np.zeros((1, 1)))  # held: the live set is weak
            dp.commit_boundary(2)
    # the error is consumed: the pipeline takes commits again
    ok = _handle(np.zeros((2, 2)))
    dp.commit_boundary(3)
    dp.drain()
    assert bad.dev is not None and ok.dev is None


def test_reset_clears_a_pending_error(async_on):
    doomed = _handle(np.zeros((1, 1)), fail=RuntimeError("rolled back"))
    dp.commit_boundary(1)
    assert doomed.dev is not None
    assert _wait_for(lambda: dp.PIPELINE.inflight() == 0)
    dp.reset()  # recovery: a rolled-back timeline must not raise
    dp.drain()
    assert dp.PIPELINE.completed_time() == -1


def test_drain_until_is_a_partial_barrier(async_on):
    early, late = threading.Event(), threading.Event()
    h4 = _handle(np.zeros((1, 1)), gate=early)
    dp.commit_boundary(4)
    h5 = _handle(np.zeros((1, 1)), gate=late)
    dp.commit_boundary(5)
    t0 = time.monotonic()
    dp.drain_until(3)  # nothing at or before 3: returns at once
    assert time.monotonic() - t0 < 5.0 and dp.PIPELINE.inflight() == 2
    early.set()
    dp.drain_until(4)  # commit 4 done, commit 5 still held
    assert h4.dev is None and h5.dev is not None
    assert dp.PIPELINE.completed_time() == 4 and dp.PIPELINE.inflight() == 1
    late.set()
    dp.drain_until(5)
    assert dp.PIPELINE.inflight() == 0 and h5.dev is None


def test_metrics_and_stats_populate(async_on):
    commits_before = dp.PIPELINE._c_commits.value
    hist_before = dp.PIPELINE._h_latency.count
    held = []
    for t in (1, 2):
        held.append(_handle(np.zeros((8, 4))))
        dp.commit_boundary(t)
    dp.drain()
    assert dp.PIPELINE._c_commits.value == commits_before + 2
    assert dp.PIPELINE._h_latency.count == hist_before + 2
    assert dp.PIPELINE._g_depth.value == 0.0
    stats = dp.PIPELINE.stats()
    assert stats["enabled"] and stats["inflight"] == 0
    assert stats["completed_commits"] == int(commits_before) + 2
    assert stats["dispatch_complete_p99_ms"] >= stats["dispatch_complete_p50_ms"] >= 0.0
    assert stats["controller"]["ticks"] == 2
    assert set(stats["controller"]) == {
        "batch_size", "depth", "window_scale", "ticks", "grows", "shrinks"
    }


def test_host_only_commit_is_free(async_on):
    commits_before = dp.PIPELINE._c_commits.value
    dp.commit_boundary(1)  # no live batch: no staging, no thread
    assert dp.PIPELINE.inflight() == 0 and dp.PIPELINE._worker is None
    assert dp.PIPELINE._c_commits.value == commits_before
    assert dp.PIPELINE.controller.ticks == 0


def test_window_scale_is_unity_when_idle(async_on):
    dp.PIPELINE.controller.window_scale = 3.0
    assert dp.ingest_window_scale() == 1.0  # nothing in flight


@pytest.mark.parametrize(
    "mode, window_ms, expected_s",
    [("1", 100, 0.25), ("1", 0, 0.0), ("0", 100, 0.1)],
)
def test_autocommit_window_widens_only_under_async_pressure(
    monkeypatch, mode, window_ms, expected_s
):
    """A connector's window scales by the controller's window while commits are in
    flight; a 0-window connector stays immediate, and the sync boundary never
    scales."""
    monkeypatch.setenv("PATHWAY_TPU_ASYNC_DEVICE", "1")
    gate = threading.Event()
    held = _handle(np.zeros((1, 1)), gate=gate)  # the live set is weak
    dp.commit_boundary(1)
    assert dp.PIPELINE.inflight() == 1 and held.dev is not None
    dp.PIPELINE.controller.window_scale = 2.5
    monkeypatch.setenv("PATHWAY_TPU_ASYNC_DEVICE", mode)
    driver = InputDriver(
        Scope().input_session(1), QueueReader(), None, autocommit_duration_ms=window_ms
    )
    try:
        assert driver.effective_autocommit_s() == pytest.approx(expected_s)
    finally:
        gate.set()
        dp.drain()
    assert driver.effective_autocommit_s() == pytest.approx(window_ms / 1000.0)


# -- the completion thread ------------------------------------------------------


def test_stop_worker_reaps_the_thread():
    dp.PIPELINE._ensure_worker()
    w = dp.PIPELINE._worker
    assert w is not None and w.is_alive()
    dp.PIPELINE.stop_worker()
    assert not w.is_alive() and dp.PIPELINE._worker is None
    dp.PIPELINE._ensure_worker()  # the next use starts a fresh one
    assert dp.PIPELINE._worker.is_alive()
    dp.PIPELINE.stop_worker()
    assert _pipeline_threads() == []


def test_raising_run_leaks_no_thread(async_on):
    class Feed(tpw.io.python.ConnectorSubject):
        def run(self) -> None:
            self.next(x=1)
            self.next(x=2)

    t = tpw.io.python.read(Feed(), schema=tpw.schema_from_types(x=int))

    def boom(*_args, **_kwargs):
        raise RuntimeError("sink boom")

    tpw.io.subscribe(t, on_change=boom)
    dp.PIPELINE._ensure_worker()  # a live completion thread going into the run
    with pytest.raises(RuntimeError, match="sink boom"):
        tpw.run()
    assert _wait_for(lambda: _pipeline_threads() == [], timeout=5.0), _pipeline_threads()


# -- the adaptive controller ----------------------------------------------------


def test_controller_grows_and_clamps_on_saturation():
    c = dp.AdaptiveBatchController()
    start = c.batch_size
    c.observe(staged_depth=0, blocked=True, occupancy=1.0)
    assert c.batch_size == start * 2 and c.grows == 1
    assert c.window_scale == pytest.approx(1.25)
    for _ in range(30):
        c.observe(staged_depth=c.depth, blocked=False, occupancy=1.0)
    assert c.batch_size == c.max_batch and c.window_scale == 4.0


def test_controller_shrinks_when_the_device_starves():
    c = dp.AdaptiveBatchController()
    start = c.batch_size
    c.observe(staged_depth=0, blocked=False, occupancy=0.0)
    assert c.batch_size == start // 2 and c.shrinks == 1
    for _ in range(30):
        c.observe(staged_depth=0, blocked=False, occupancy=0.0)
    assert c.batch_size == c.min_batch and c.window_scale == 1.0


def test_controller_holds_steady_in_the_mid_band():
    c = dp.AdaptiveBatchController()
    start = c.batch_size
    c.observe(staged_depth=0, blocked=False, occupancy=0.6)
    assert c.batch_size == start and c.grows == 0 and c.shrinks == 0 and c.ticks == 1


def test_controller_reads_its_env_knobs(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_BATCH", "64")
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_BATCH_MIN", "16")
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_BATCH_MAX", "128")
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_INFLIGHT", "3")
    c = dp.AdaptiveBatchController()
    assert (c.batch_size, c.min_batch, c.max_batch, c.depth) == (64, 16, 128, 3)
    c.observe(staged_depth=3, blocked=False, occupancy=1.0)
    assert c.batch_size == 128  # clamped at the env max
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_INFLIGHT", "many")
    assert dp.AdaptiveBatchController().depth == 2  # a bad value keeps the default


# -- the executor's sizer -------------------------------------------------------


@pytest.mark.parametrize(
    "cap, suggested, sizes",
    [(8, 2, [2, 2, 2, 2]), (4, 100, [4, 4]), (None, None, [8]), (8, 0, [8])],
    ids=["narrows the cap", "never exceeds the cap", "None is ignored", "0 is ignored"],
)
def test_sizer(cap, suggested, sizes):
    seen = []

    def fn(xs):
        seen.append(len(xs))
        return xs

    out = batch_executor(max_batch_size=cap, sizer=lambda: suggested).run(
        fn, [(i,) for i in range(8)]
    )
    assert [v for ok, v in out] == list(range(8)) and all(ok for ok, _v in out)
    assert seen == sizes


def test_suggested_batch_size_tracks_the_mode(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_ASYNC_DEVICE", "1")
    assert dp.suggested_batch_size() == dp.PIPELINE.controller.batch_size
    monkeypatch.setenv("PATHWAY_TPU_ASYNC_DEVICE", "0")
    assert dp.suggested_batch_size() is None


def test_embedder_chunks_follow_the_controller(async_on):
    """``EncoderEmbedder``'s executor reads the controller: a batch of 32 splits five
    texts into the chunks 2 + 2 + 1 (the cap is 4), and its rows equal one embed call
    over all five."""
    from pathway_tpu_torch.models import EncoderConfig
    from pathway_tpu_torch.xpacks.llm import EncoderEmbedder

    cfg = EncoderConfig(
        vocab_size=64, hidden=16, layers=1, heads=2, intermediate=32, max_len=16
    )
    emb = EncoderEmbedder(cfg, max_len=8, max_batch_size=4, device="cpu")
    calls = []
    embed_batch = emb.embed_batch
    emb.embed_batch = lambda texts: calls.append(len(texts)) or embed_batch(texts)
    texts = [f"doc {i} stream" for i in range(5)]
    dp.PIPELINE.controller.batch_size = 2
    rows = emb.execute_rows([(t,) for t in texts], n_pos=1)
    assert calls == [2, 2, 1]
    ref = embed_batch(texts).numpy()
    assert np.array_equal(np.stack([np.asarray(v) for _ok, v in rows]), ref)


# -- the scheduler's boundary: async against sync -------------------------------


def _embed_rows(arg_rows):
    """A batch UDF that makes lazy rows, as the embedder does: ``[n, 2]`` rows from
    the arguments."""
    mat = torch.tensor([[float(a), float(b) * 2.0] for a, b in arg_rows])
    return [(True, c) for c in tdev.lazy_rows(mat, len(arg_rows))]


def _host_row(row) -> tuple:
    return tuple(
        tuple(float(x) for x in np.asarray(c)) if isinstance(c, tdev.LazyDeviceVector) else c
        for c in row
    )


def _run_device_chain(n_commits=3, per=40):
    events: list = []
    sc = Scope()
    sess = sc.input_session(2)
    ba = sc.batch_apply_table(sess, lambda rows: _embed_rows(rows), [0, 1])
    scaled = sc.expression_table(ba, [tex.ColumnRef(0)])
    sc.subscribe_table(
        ba, on_change=lambda k, row, t, d: events.append((int(k), _host_row(row), t, d))
    )
    sc.subscribe_table(
        scaled, on_change=lambda k, row, t, d: events.append((int(k), _host_row(row), t, d))
    )
    sched = Scheduler(sc)
    for commit in range(n_commits):
        for i in range(per):
            key = commit * per + i
            sess.insert(ref_scalar(key), (key, float(i) * 0.5))
        sched.commit()
    # a retraction and replacement commit
    for i in range(10):
        sess.remove(ref_scalar(i), (i, float(i) * 0.5))
        sess.insert(ref_scalar(i), (i, float(i) * 0.5 + 9.0))
    sched.commit()
    dp.drain()
    state = {int(k): _host_row(row) for k, row in ba.current.items()}
    return sorted(events, key=repr), state


def test_scheduler_parity_async_on_off(monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_ASYNC_DEVICE", "0")
    dp.PIPELINE.configure()
    ev_off, state_off = _run_device_chain()
    monkeypatch.setenv("PATHWAY_TPU_ASYNC_DEVICE", "1")
    dp.PIPELINE.configure()
    before = dp.PIPELINE._c_commits.value
    ev_on, state_on = _run_device_chain()
    assert dp.PIPELINE._c_commits.value == before + 4  # every commit went through it
    assert ev_off == ev_on and state_off == state_on
    assert ev_on and len(state_on) == 120


# -- the port against the JAX package ----------------------------------------------


@pytest.fixture
def jax_pipeline():
    from pathway_tpu.engine import device as jdev
    from pathway_tpu.engine import device_pipeline as jdp
    from pathway_tpu.internals import tracing

    assert not tracing.TRACER.enabled  # no critical-path sample on either side
    jdev._LIVE_HANDLES.clear()
    jdp.PIPELINE.configure()
    yield jdp
    jdev._LIVE_HANDLES.clear()
    jdp.PIPELINE.configure()
    jdp.PIPELINE.stop_worker()


@pytest.mark.parametrize(
    "seed, env",
    [
        (0, {}),
        (1, {}),
        (2, {"PATHWAY_TPU_DEVICE_BATCH": "96", "PATHWAY_TPU_DEVICE_BATCH_MIN": "8",
             "PATHWAY_TPU_DEVICE_BATCH_MAX": "512", "PATHWAY_TPU_DEVICE_INFLIGHT": "3"}),
        (3, {"PATHWAY_TPU_DEVICE_BATCH": "7", "PATHWAY_TPU_DEVICE_INFLIGHT": "1"}),
    ],
)
def test_controller_matches_jax_tick_for_tick(monkeypatch, jax_pipeline, seed, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    ours, theirs = dp.AdaptiveBatchController(), jax_pipeline.AdaptiveBatchController()
    assert ours.stats() == theirs.stats()
    rng = np.random.default_rng(seed)
    for _ in range(400):
        tick = dict(
            staged_depth=int(rng.integers(0, 4)),
            blocked=bool(rng.random() < 0.15),
            occupancy=float(rng.choice([0.0, rng.random(), 0.25, 1.0])),
        )
        ours.observe(**tick)
        theirs.observe(**tick)
        assert ours.stats() == theirs.stats(), tick
    assert ours.grows and ours.shrinks  # both rules were exercised


def _streaming_program(pw, lazy_rows, to_device, n_batches=4, per=24):
    """A python connector fed in ``n_batches`` paced batches (each waits until the
    previous one reached the sink, so each is its own commit) -> a batch UDF making
    lazy rows -> a projection -> two subscribe sinks. Returns the sink events."""
    seen = threading.Event()
    events: dict = {"vec": {}, "x": {}}
    failures: list = []

    class Feed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for b in range(n_batches):
                seen.clear()
                for i in range(per):
                    self.next(x=b * per + i, y=float(i) * 0.25)
                if not seen.wait(WAIT_S):
                    failures.append(f"batch {b} never reached the sink")
                    return

    def rows_fn(xs, ys):
        mat = np.asarray([[float(x), y * 2.0, x * y] for x, y in zip(xs, ys)], np.float32)
        return lazy_rows(to_device(mat), len(xs))

    pw.internals.parse_graph.G.clear()
    vec_udf = pw.UDF(rows_fn, executor=batch_executor_of(pw)(max_batch_size=10))
    t = pw.io.python.read(
        Feed(), schema=pw.schema_from_types(x=int, y=float), autocommit_duration_ms=20
    )
    t = t.select(x=pw.this.x, vec=vec_udf(pw.this.x, pw.this.y))
    proj = t.select(x=pw.this.x)

    def on_vec(key, row, time, is_addition):
        events["vec"][int(key)] = (row["x"], np.asarray(row["vec"], np.float32), is_addition)
        if len(events["vec"]) % per == 0:
            seen.set()

    def on_x(key, row, time, is_addition):
        events["x"][int(key)] = (row["x"], is_addition)

    pw.io.subscribe(t, on_change=on_vec)
    pw.io.subscribe(proj, on_change=on_x)
    runner = threading.Thread(target=pw.run, daemon=True)
    runner.start()
    runner.join(4 * WAIT_S)
    assert not runner.is_alive(), "pw.run did not end"
    assert not failures, failures
    return events


def batch_executor_of(pw):
    if pw.__name__ == "pathway_tpu":
        from pathway_tpu.internals.udfs import batch_executor as jbatch

        return jbatch
    return batch_executor


def test_streaming_sinks_match_jax_with_async_on(monkeypatch, jax_pipeline):
    import jax.numpy as jnp

    import pathway_tpu as jpw
    from pathway_tpu.engine import device as jdev

    monkeypatch.setenv("PATHWAY_TPU_ASYNC_DEVICE", "1")
    before = dp.PIPELINE._c_commits.value
    ours = _streaming_program(tpw, tdev.lazy_rows, lambda m: torch.from_numpy(m))
    assert dp.PIPELINE._c_commits.value >= before + 4  # the async boundary ran
    assert dp.PIPELINE.inflight() == 0 and _pipeline_threads() == []
    theirs = _streaming_program(jpw, jdev.lazy_rows, jnp.asarray)
    assert len(ours["vec"]) == len(theirs["vec"]) == 96
    assert set(ours["vec"]) == set(theirs["vec"])  # keys bit for bit
    assert ours["x"] == theirs["x"]
    for key, (x, vec, add) in ours["vec"].items():
        jx, jvec, jadd = theirs["vec"][key]
        assert (x, add) == (jx, jadd)
        np.testing.assert_allclose(vec, jvec, rtol=0, atol=1e-6)


# -- thread safety of the handles -----------------------------------------------------


def test_handles_read_while_the_worker_decays_them(async_on):
    """Four reader threads call ``host()``, read rows and partition them with
    ``device_runs`` while the completion thread decays the same handles: no
    exception, and the same bits every time."""
    rng = np.random.default_rng(7)
    mats = [rng.normal(size=(6, 3)).astype(np.float32) for _ in range(12)]
    gate = threading.Event()
    handles = []
    for t, mat in enumerate(mats):
        handles.append(_handle(mat, gate=gate, delay_s=0.002))
        dp.PIPELINE.controller.depth = len(mats)  # stage every commit at once
        dp.commit_boundary(t)
    rows = [tdev.LazyDeviceVector(h, i) for h in handles for i in range(6)]
    errors: list = []
    start = threading.Barrier(5)

    def reader(seed: int) -> None:
        r = np.random.default_rng(seed)
        try:
            start.wait(WAIT_S)
            for _ in range(300):
                j = int(r.integers(0, len(handles)))
                assert np.array_equal(handles[j].host(), mats[j])
                k = int(r.integers(0, len(rows)))
                assert np.array_equal(np.asarray(rows[k]), mats[k // 6][k % 6])
                sample = [rows[int(i)] for i in r.integers(0, len(rows), 8)]
                for s, _e, dev, idx in tdev.device_runs(sample):
                    if dev is not None:
                        mat = mat_of[id(sample[s].batch)]
                        assert torch.equal(dev[idx], torch.from_numpy(mat[idx]))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    mat_of = {id(h): mat for h, mat in zip(handles, mats)}
    threads = [threading.Thread(target=reader, args=(s,)) for s in range(4)]
    for th in threads:
        th.start()
    start.wait(WAIT_S)
    gate.set()
    for th in threads:
        th.join(WAIT_S)
    dp.drain()
    assert not errors, errors[:3]
    assert all(h.dev is None for h in handles)
    assert np.array_equal(np.stack([np.asarray(r) for r in rows]), np.concatenate(mats))
