"""UDF executors: how a batch of pending rows is driven through user code.

Counterpart of ``pathway_tpu/internals/udfs/executors.py``. The engine hands executors
whole commit-batches of rows (``engine.graph.BatchApplyNode``) and takes every row's
result before the commit goes on, so a UDF's results land in the commit of its input
rows whichever executor runs it. A :class:`BatchExecutor` receives the rows at once, in
chunks of at most ``max_batch_size`` in row order, which is the micro-batching seam of
device UDFs such as the embedder, whose ``sizer`` lets the device pipeline's adaptive
controller narrow the chunks. An :class:`AsyncExecutor` runs a coroutine function on
all of a batch's rows concurrently on one event-loop thread (``pw-udf-loop``), which
``GraphRunner.run`` stops when the run ends or raises (:func:`stop_event_loop`). Each
executor takes an optional retry strategy (``retries.py``) around every call.
"""

from __future__ import annotations

import asyncio
import inspect
import threading
from typing import Any, Awaitable, Callable, Sequence

from pathway_tpu_torch.internals.udfs.retries import AsyncRetryStrategy

RowResult = tuple[bool, Any]  # (ok, value-or-exception)


def make_kw_fn(fn: Callable, n_pos: int, kw_names: list[str]) -> Callable:
    """Rebind a flat positional arg tuple to ``fn(*pos, **kw)``."""
    if not kw_names:
        return fn

    def wrapped(*vals: Any) -> Any:
        pos = vals[:n_pos]
        kws = dict(zip(kw_names, vals[n_pos:]))
        return fn(*pos, **kws)

    return wrapped


class Executor:
    kind = "sync"

    def run(
        self,
        fn: Callable[..., Any],
        rows: Sequence[tuple],
        retry: AsyncRetryStrategy | None = None,
    ) -> list[RowResult]:
        raise NotImplementedError


class SyncExecutor(Executor):
    """One call per row."""

    def run(self, fn, rows, retry=None):
        out: list[RowResult] = []
        for args in rows:
            try:
                if retry is not None:
                    out.append((True, retry.invoke_sync(lambda: fn(*args))))
                else:
                    out.append((True, fn(*args)))
            except Exception as e:  # noqa: BLE001
                out.append((False, e))
        return out


class _EventLoopThread:
    """The event loop of async UDFs, on a thread of its own.

    One loop serves every async UDF of a run, so async clients keep their loop across
    commits, and it works whether or not the caller itself runs inside an event loop
    (notebooks). :meth:`stop` ends it: pending tasks are cancelled, the loop's default
    executor (``asyncio.to_thread``'s workers) is shut down and the thread joined."""

    _lock = threading.Lock()
    _instance: "_EventLoopThread | None" = None

    def __init__(self) -> None:
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._main, name="pw-udf-loop", daemon=True)
        self.thread.start()

    def _main(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()
        pending = asyncio.all_tasks(self.loop)
        for task in pending:
            task.cancel()
        if pending:
            self.loop.run_until_complete(asyncio.gather(*pending, return_exceptions=True))
        self.loop.run_until_complete(self.loop.shutdown_default_executor())
        self.loop.close()

    @classmethod
    def get(cls) -> "_EventLoopThread":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def stop(cls) -> None:
        with cls._lock:
            inst, cls._instance = cls._instance, None
        if inst is None:
            return
        inst.loop.call_soon_threadsafe(inst.loop.stop)
        if threading.current_thread() is not inst.thread:
            inst.thread.join()

    def run(self, coro: Awaitable[Any]) -> Any:
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result()


def stop_event_loop() -> None:
    """Stop the async UDFs' event-loop thread, if one runs; the next async batch
    starts a fresh one."""
    _EventLoopThread.stop()


class AsyncExecutor(Executor):
    """Concurrent execution on the event-loop thread: every row of a batch is a
    coroutine, at most ``capacity`` of them running at once; ``timeout`` (seconds)
    applies per call, inside the retry loop. The batch's results come back in row
    order once all of them are done."""

    kind = "async"

    def __init__(self, capacity: int | None = None, timeout: float | None = None) -> None:
        self.capacity = capacity
        self.timeout = timeout

    def run(self, fn, rows, retry=None):
        async def one(args: tuple, sem: asyncio.Semaphore | None):
            async def call():
                coro = fn(*args)
                if self.timeout is not None:
                    return await asyncio.wait_for(coro, self.timeout)
                return await coro

            try:
                if sem is not None:
                    async with sem:
                        if retry is not None:
                            return (True, await retry.invoke(call))
                        return (True, await call())
                if retry is not None:
                    return (True, await retry.invoke(call))
                return (True, await call())
            except Exception as e:  # noqa: BLE001
                return (False, e)

        async def gather():
            sem = asyncio.Semaphore(self.capacity) if self.capacity is not None else None
            return await asyncio.gather(*(one(args, sem) for args in rows))

        return _EventLoopThread.get().run(gather())


class BatchExecutor(Executor):
    """Whole-batch execution: ``fn`` receives parallel lists (one per argument) and
    returns a list of results. ``max_batch_size`` splits oversized commits into
    chunks, in row order, so padded device buffers stay bounded; a chunk that fails
    or returns the wrong number of results fails each of its rows. ``sizer`` (a
    callable -> int or None, read once per run) narrows the chunk below the cap, never
    above it; a falsy value leaves the cap."""

    kind = "batch"

    def __init__(
        self,
        max_batch_size: int | None = None,
        sizer: Callable[[], int | None] | None = None,
    ) -> None:
        self.max_batch_size = max_batch_size
        self.sizer = sizer

    def run(self, fn, rows, retry=None):
        out: list[RowResult] = []
        step = self.max_batch_size or len(rows) or 1
        if self.sizer is not None:
            suggested = self.sizer()
            if suggested:
                step = max(1, min(step, int(suggested)))
        for start in range(0, len(rows), step):
            chunk = rows[start : start + step]
            cols = tuple(list(c) for c in zip(*chunk))
            try:
                if retry is not None:
                    results = list(retry.invoke_sync(lambda: fn(*cols)))
                else:
                    results = list(fn(*cols))
                if len(results) != len(chunk):
                    raise ValueError(
                        f"batch UDF returned {len(results)} results "
                        f"for {len(chunk)} rows"
                    )
                out.extend((True, r) for r in results)
            except Exception as e:  # noqa: BLE001
                out.extend((False, e) for _ in chunk)
        return out


def sync_executor() -> SyncExecutor:
    return SyncExecutor()


def auto_executor(fn: Callable[..., Any]) -> Executor:
    if inspect.iscoroutinefunction(fn):
        return AsyncExecutor()
    return SyncExecutor()


def async_executor(capacity: int | None = None, timeout: float | None = None) -> AsyncExecutor:
    return AsyncExecutor(capacity=capacity, timeout=timeout)


def batch_executor(
    max_batch_size: int | None = None,
    sizer: Callable[[], int | None] | None = None,
) -> BatchExecutor:
    return BatchExecutor(max_batch_size=max_batch_size, sizer=sizer)
