"""UDF executors: how a batch of pending rows is driven through user code.

Counterpart of ``SyncExecutor`` and ``BatchExecutor`` in
``pathway_tpu/internals/udfs/executors.py``. The engine hands executors whole
commit-batches of rows (``engine.graph.BatchApplyNode``); a :class:`BatchExecutor`
receives them at once, in chunks of at most ``max_batch_size`` in row order, which is
the micro-batching seam of device UDFs such as the embedder, whose ``sizer`` lets the
device pipeline's adaptive controller narrow the chunks. The async executor, its
event-loop thread and the retry strategies are not ported yet.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Sequence

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

    def run(self, fn: Callable[..., Any], rows: Sequence[tuple]) -> list[RowResult]:
        raise NotImplementedError


class SyncExecutor(Executor):
    """One call per row."""

    def run(self, fn, rows):
        out: list[RowResult] = []
        for args in rows:
            try:
                out.append((True, fn(*args)))
            except Exception as e:  # noqa: BLE001
                out.append((False, e))
        return out


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

    def run(self, fn, rows):
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
        raise NotImplementedError(
            "async UDFs need the async executor, which is not ported yet "
            "(ROADMAP queue 1 item 11)"
        )
    return SyncExecutor()


def batch_executor(
    max_batch_size: int | None = None,
    sizer: Callable[[], int | None] | None = None,
) -> BatchExecutor:
    return BatchExecutor(max_batch_size=max_batch_size, sizer=sizer)
