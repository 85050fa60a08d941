"""The port's async UDF executor, result caches and retry strategies
(``pathway_tpu_torch/internals/udfs``) against the JAX package's on the same inputs:
per-row results and errors of the async executor (capacity, timeout), the cache keys
(``_digest``) and what each cache returns, the retry schedule with a fake sleep and a
seeded jitter, and async UDFs through ``pw.run``, whose results must land in the same
commits as the JAX engine's, with the device pipeline's async commit boundary on and
off. The event-loop thread of async UDFs must not outlive a run, whether it ends or
raises. Everything here is exact: no model math."""

from __future__ import annotations

import asyncio
import random
import threading
import time

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import udfs as judfs
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch.engine import device_pipeline as dp
from pathway_tpu_torch.internals import udfs as tudfs
from pathway_tpu_torch.internals.parse_graph import G as TG
from pathway_tpu_torch.internals.udfs import executors as texec

WAIT_S = 30.0  # every wait is bounded: a stalled run fails, never hangs


def _loop_threads() -> list[str]:
    """The port's live event-loop threads (the JAX package keeps its own for the
    process, under the same name)."""
    from pathway_tpu.internals.udfs.executors import _EventLoopThread as JaxLoop

    theirs = JaxLoop._instance.thread if JaxLoop._instance is not None else None
    return [
        t.name for t in threading.enumerate()
        if t.is_alive() and t.name == "pw-udf-loop" and t is not theirs
    ]


@pytest.fixture(autouse=True)
def _reap():
    yield
    texec.stop_event_loop()
    TG.clear()
    JG.clear()
    assert _loop_threads() == []


def _plain(results):
    return [(ok, v if ok else f"{type(v).__name__}: {v}") for ok, v in results]


async def _scaled(x, scale=2):
    await asyncio.sleep(0.001 * (x % 3))  # finish out of order
    if x < 0:
        raise ValueError("negative")
    return x * scale


@pytest.mark.parametrize("capacity", [None, 1, 3])
def test_async_executor_matches_jax(capacity):
    rows = [(x,) for x in (4, -1, 7, 0, 3, 11, -5)]
    got = [
        _plain(mod.AsyncExecutor(capacity=capacity).run(_scaled, rows))
        for mod in (texec, judfs)
    ]
    assert got[0] == got[1]
    assert got[0][:3] == [(True, 8), (False, "ValueError: negative"), (True, 14)]


def test_async_executor_timeout_matches_jax():
    async def slow(x):
        await asyncio.sleep(0.5 if x == 2 else 0.0)
        return x

    rows = [(1,), (2,), (3,)]
    got = [
        [(ok, v if ok else type(v).__name__) for ok, v in mod.async_executor(timeout=0.05).run(slow, rows)]
        for mod in (texec, judfs)
    ]
    assert got[0] == got[1] == [(True, 1), (False, "TimeoutError"), (True, 3)]


def test_async_executor_bounds_concurrency():
    running, peak = [0], [0]

    async def track(x):
        running[0] += 1
        peak[0] = max(peak[0], running[0])
        await asyncio.sleep(0.002)
        running[0] -= 1
        return x

    out = texec.AsyncExecutor(capacity=2).run(track, [(i,) for i in range(8)])
    assert [v for _ok, v in out] == list(range(8))
    assert peak[0] == 2


def test_auto_executor_picks_by_function_kind():
    async def coro(x):
        return x

    assert isinstance(texec.auto_executor(coro), texec.AsyncExecutor)
    assert isinstance(texec.auto_executor(lambda x: x), texec.SyncExecutor)
    assert tudfs.UDF(coro)._executor.kind == judfs.UDF(coro)._executor.kind == "async"


def test_event_loop_thread_stops_and_starts_again():
    texec.AsyncExecutor().run(_scaled, [(1,)])
    assert _loop_threads() == ["pw-udf-loop"]
    first = texec._EventLoopThread._instance
    texec.stop_event_loop()
    assert _loop_threads() == [] and first.loop.is_closed()
    assert texec.AsyncExecutor().run(_scaled, [(2,)]) == [(True, 4)]
    assert texec._EventLoopThread._instance is not first
    texec.stop_event_loop()
    texec.stop_event_loop()  # stopping twice is a no-op
    assert _loop_threads() == []


def test_to_thread_workers_are_reaped_with_the_loop():
    async def off_loop(x):
        return await asyncio.to_thread(lambda: x + 1)

    before = {t for t in threading.enumerate() if t.name.startswith("asyncio_")}
    assert texec.AsyncExecutor().run(off_loop, [(1,), (2,)]) == [(True, 2), (True, 3)]
    workers = {t for t in threading.enumerate() if t.name.startswith("asyncio_")} - before
    assert workers
    texec.stop_event_loop()
    assert not [t for t in workers if t.is_alive()]


# -- caches -----------------------------------------------------------------------


@pytest.mark.parametrize("args", [
    (1, 2.5, "x"),
    ("text",),
    ((1, 2), None, True),
    (np.arange(3, dtype=np.float32),),
    (lambda: 0,),  # does not pickle: the key hashes the repr's type-free part below
])
def test_cache_digest_matches_jax(args):
    from pathway_tpu.internals.udfs.caches import _digest as jdigest
    from pathway_tpu_torch.internals.udfs.caches import _digest as tdigest

    if callable(args[0]):
        # a repr carries the object's address, so only its shape can be compared
        assert len(tdigest("n", args)) == len(jdigest("n", args)) == 64
        return
    assert tdigest("udf-name", args) == jdigest("udf-name", args)
    assert tdigest("udf-name", args) != tdigest("other-name", args)


def test_in_memory_cache_evicts_like_jax():
    caches = [tudfs.InMemoryCache(max_size=2), judfs.InMemoryCache(max_size=2)]
    for c in caches:
        for i in range(3):
            c.put(f"k{i}", i)
    got = [
        [None if type(c).missing(c.get(f"k{i}")) else c.get(f"k{i}") for i in range(3)]
        for c in caches
    ]
    assert got[0] == got[1] == [None, 1, 2]


def test_disk_cache_round_trip_and_root(tmp_path, monkeypatch):
    from pathway_tpu_torch.internals.udfs import caches as tcaches

    explicit = tudfs.DiskCache(str(tmp_path / "explicit"))
    explicit.put("ab" + "0" * 62, {"v": [1, 2]})
    assert explicit.get("ab" + "0" * 62) == {"v": [1, 2]}
    assert (tmp_path / "explicit" / "ab" / ("ab" + "0" * 62)).exists()
    assert tudfs.CacheStrategy.missing(explicit.get("cd" + "0" * 62))
    explicit.put("ef" + "0" * 62, lambda: 0)  # an unpicklable result is not cached
    assert tudfs.CacheStrategy.missing(explicit.get("ef" + "0" * 62))

    monkeypatch.setenv("PATHWAY_TPU_UDF_CACHE", str(tmp_path / "env"))
    lazy = tudfs.DefaultCache()
    lazy.put("aa" + "1" * 62, 5)
    assert (tmp_path / "env" / "aa").is_dir()
    tudfs.set_udf_cache_root(str(tmp_path / "root"))
    try:
        lazy.put("bb" + "1" * 62, 6)  # resolved again at use: the root wins over the env
        assert (tmp_path / "root" / "bb").is_dir()
    finally:
        tudfs.set_udf_cache_root(None)
    assert tcaches._udf_cache_root is None


@pytest.mark.parametrize("kind", ["memory", "disk"])
def test_cached_udf_computes_each_distinct_call_once(kind, tmp_path):
    """The same rows through a cached UDF in both packages: the same results, and the
    function runs once per distinct argument tuple, across batches too."""
    rows = [(3,), (1,), (3,), (-2,), (1,), (5,)]
    out = []
    for mod in (tudfs, judfs):
        calls = []

        def square(x):
            calls.append(x)
            if x < 0:
                raise ValueError("negative")
            return x * x

        cache = mod.InMemoryCache() if kind == "memory" else mod.DiskCache(str(tmp_path / mod.__name__))
        udf = mod.UDF(square, cache_strategy=cache, cache_name="square")
        first = _plain(udf.execute_rows(rows, n_pos=1))
        second = _plain(udf.execute_rows([(5,), (7,), (-2,)], n_pos=1))
        out.append((first, second, calls))
    assert out[0] == out[1]
    first, second, calls = out[0]
    assert first[0] == (True, 9) and first[3] == (False, "ValueError: negative")
    assert calls == [3, 1, -2, 5, 7, -2]  # errors are not cached


def test_cached_async_udf_matches_jax():
    async def add_one(x):
        return x + 1

    got = []
    for mod in (tudfs, judfs):
        udf = mod.UDF(add_one, cache_strategy=mod.InMemoryCache(), cache_name="add_one")
        got.append(udf.execute_rows([(1,), (2,), (1,)], n_pos=1))
        got.append(udf.execute_rows([(2,), (3,)], n_pos=1))
    assert got[0] == got[2] == [(True, 2), (True, 3), (True, 2)]
    assert got[1] == got[3] == [(True, 3), (True, 4)]


# -- retries ----------------------------------------------------------------------


def _flaky(fails: int):
    state = {"n": 0}

    def fn():
        state["n"] += 1
        if state["n"] <= fails:
            raise RuntimeError(f"try {state['n']}")
        return state["n"]

    return fn, state


@pytest.mark.parametrize("make", [
    lambda m: m.ExponentialBackoffRetryStrategy(max_retries=3, initial_delay=100, backoff_factor=3.0, jitter_ms=50),
    lambda m: m.ExponentialBackoffRetryStrategy(),
    lambda m: m.FixedDelayRetryStrategy(max_retries=2, delay_ms=250),
    lambda m: m.NoRetryStrategy(),
])
@pytest.mark.parametrize("fails", [0, 2, 5])
def test_retry_schedule_matches_jax(monkeypatch, make, fails):
    """The delays each strategy sleeps (a fake sleep, the jitter drawn from a seeded
    ``random``), the value it returns and the error it gives up with, blocking and as
    a coroutine."""
    slept: list[float] = []
    me = threading.current_thread()

    def fake_sleep(delay):  # any other thread still waits, and is not recorded
        if threading.current_thread() is me:
            slept.append(delay)
        else:
            real_sleep(delay)

    async def fake_async_sleep(delay):
        slept.append(delay)

    real_sleep = time.sleep
    monkeypatch.setattr(time, "sleep", fake_sleep)
    monkeypatch.setattr(asyncio, "sleep", fake_async_sleep)
    outcomes = []
    for mod in (tudfs, judfs):
        for mode in ("sync", "async"):
            random.seed(11)
            slept.clear()
            fn, state = _flaky(fails)
            strategy = make(mod)
            try:
                if mode == "sync":
                    value = strategy.invoke_sync(fn)
                else:
                    async def call():
                        return fn()

                    value = asyncio.run(strategy.invoke(call))
                result = ("ok", value)
            except RuntimeError as e:
                result = ("error", str(e))
            outcomes.append((mode, result, list(slept), state["n"]))
    assert outcomes[:2] == outcomes[2:]
    assert outcomes[0][2] == outcomes[1][2]  # the same schedule either way


def test_retry_strategy_wraps_every_executor():
    attempts = {"sync": 0, "batch": 0}

    def once_flaky(x):
        attempts["sync"] += 1
        if attempts["sync"] == 1:
            raise RuntimeError("first try")
        return x

    def batch_flaky(xs):
        attempts["batch"] += 1
        if attempts["batch"] == 1:
            raise RuntimeError("first try")
        return [x * 10 for x in xs]

    retry = tudfs.FixedDelayRetryStrategy(max_retries=1, delay_ms=0)
    assert tudfs.UDF(once_flaky, retry_strategy=retry).execute_rows([(4,)], n_pos=1) == [(True, 4)]
    batch = tudfs.UDF(batch_flaky, executor=tudfs.batch_executor(), retry_strategy=retry)
    assert batch.execute_rows([(1,), (2,)], n_pos=1) == [(True, 10), (True, 20)]


# -- through pw.run ----------------------------------------------------------------


def _async_program(pw, udfs_mod, vector_udf, n_batches: int = 3, batch: int = 4):
    """Rows fed in batches, each sent once the subscriber has seen the last one, so
    every batch is one commit; an async UDF (with an error row), a sync one and a
    vector UDF (``vector_udf``) on them. -> the subscriber's log of (time, x, y, z,
    is_addition)."""
    seen = threading.Semaphore(0)
    log: list = []
    failures: list = []

    class Feed(pw.io.python.ConnectorSubject):
        def run(self) -> None:
            for b in range(n_batches):
                for i in range(batch):
                    self.next(x=b * batch + i)
                self.commit()
                # the row whose call raises never reaches the subscriber
                expected = sum(1 for i in range(batch) if b * batch + i != 5)
                for _ in range(expected):
                    if not seen.acquire(timeout=WAIT_S):
                        failures.append(f"batch {b} not seen")
                        return

    async def slow_square(x):
        await asyncio.sleep(0.001 * (x % 4))
        if x == 5:
            raise ValueError("five")
        return x * x

    square = udfs_mod.udf(slow_square)
    negate = udfs_mod.udf(lambda x: -x)
    t = pw.io.python.read(Feed(), schema=pw.schema_from_types(x=int), autocommit_duration_ms=None)
    out = t.select(x=pw.this.x, y=square(pw.this.x), z=negate(pw.this.x),
                   v=vector_udf(pw.apply(str, pw.this.x)))

    def on_change(key, row, time, is_addition):
        log.append((time, row["x"], row["y"], row["z"], is_addition))
        if is_addition:
            seen.release()

    pw.io.subscribe(out, on_change=on_change)
    runner = threading.Thread(target=pw.run, daemon=True)
    runner.start()
    runner.join(4 * WAIT_S)
    assert not runner.is_alive(), "pw.run did not end"
    assert not failures, failures
    return sorted(log, key=lambda e: (e[0], e[1]))


@pytest.mark.parametrize("async_device", ["0", "1"])
def test_async_udf_commits_like_the_jax_engine(monkeypatch, async_device):
    """An async UDF's results land in the commit of their input rows, at the same
    commit times as in the JAX engine, with the device pipeline's synchronous or
    async commit boundary. The port's program also carries an embedder's lazy device
    rows (a hidden-16 ``EncoderEmbedder`` on the CPU), so its commits go through the
    pipeline's staging and completion when the boundary is async; the JAX program
    a host vector UDF. The row whose call raised is left out in both."""
    from pathway_tpu_torch.engine import device as tdev
    from pathway_tpu_torch.models import EncoderConfig
    from pathway_tpu_torch.xpacks.llm import EncoderEmbedder

    monkeypatch.setenv("PATHWAY_TPU_ASYNC_DEVICE", async_device)
    cfg = EncoderConfig(vocab_size=64, hidden=16, layers=1, heads=2, intermediate=32, max_len=16)
    embedder = EncoderEmbedder(cfg, max_len=8, max_batch_size=4, device="cpu")
    dp.PIPELINE.configure()
    before = dp.PIPELINE.stats()["completed_commits"]
    try:
        ours = _async_program(tpw, tudfs, embedder)
        completed = dp.PIPELINE.stats()["completed_commits"] - before
    finally:
        tdev._LIVE_HANDLES.clear()
        dp.PIPELINE.stop_worker()
    theirs = _async_program(jpw, judfs, judfs.udf(lambda s: (float(len(s)),)))
    assert ours == theirs
    assert (completed > 0) == (async_device == "1")
    assert len(ours) == 11 and {x for _t, x, *_ in ours} == set(range(12)) - {5}
    assert len({t for t, *_ in ours}) == 3  # one commit per batch
    assert _loop_threads() == []  # the run stopped the event loop


def test_raising_run_leaks_no_loop_thread():
    class Feed(tpw.io.python.ConnectorSubject):
        def run(self) -> None:
            self.next(x=1)

    async def ident(x):
        return x

    t = tpw.io.python.read(Feed(), schema=tpw.schema_from_types(x=int))
    out = t.select(y=tpw.udf(ident)(tpw.this.x))

    def boom(*_args, **_kwargs):
        raise RuntimeError("sink boom")

    tpw.io.subscribe(out, on_change=boom)
    with pytest.raises(RuntimeError, match="sink boom"):
        tpw.run()
    assert _loop_threads() == []
