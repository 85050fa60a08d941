"""UDFs: ``pw.udf`` and the ``UDF`` class, run by the engine in commit batches.

Counterpart of ``pathway_tpu/internals/udfs/__init__.py``. A UDF call inside ``select``
lowers to the engine's BatchApplyNode, which hands whole commit batches of rows to the
UDF's executor: device UDFs (the embedder) get micro-batches instead of rows, async
UDFs (remote chats) run concurrently on the event-loop thread. A ``cache_strategy``
is consulted before the executor runs, a ``retry_strategy`` wraps every call.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

from pathway_tpu_torch.internals.expression import (
    BatchApplyExpression,
    ColumnExpression,
)
from pathway_tpu_torch.internals.udfs.caches import (
    CacheStrategy,
    DefaultCache,
    DiskCache,
    InMemoryCache,
    _digest,
    fn_cache_name,
    set_udf_cache_root,
)
from pathway_tpu_torch.internals.udfs.executors import (
    AsyncExecutor,
    BatchExecutor,
    Executor,
    SyncExecutor,
    async_executor,
    auto_executor,
    batch_executor,
    make_kw_fn,
    sync_executor,
)
from pathway_tpu_torch.internals.udfs.retries import (
    AsyncRetryStrategy,
    ExponentialBackoffRetryStrategy,
    FixedDelayRetryStrategy,
    NoRetryStrategy,
)


class UDF:
    """A callable lowered to engine batch execution when used in ``select``.

    Subclass with ``__wrapped__`` or pass ``fn``; calling it with column expressions
    builds the expression node. ``cache_name`` names the function for result caches:
    two instances wrapping the same closure code with different captured configuration
    must pass distinct names, or they share cached results.
    """

    def __init__(
        self,
        fn: Callable[..., Any] | None = None,
        *,
        return_type: Any = None,
        deterministic: bool = False,
        propagate_none: bool = False,
        executor: Executor | None = None,
        cache_strategy: CacheStrategy | None = None,
        retry_strategy: AsyncRetryStrategy | None = None,
        max_batch_size: int | None = None,
        cache_name: str | None = None,
    ) -> None:
        if fn is None:
            fn = getattr(self, "__wrapped__", None)
        if fn is None:
            raise TypeError("UDF needs a function")
        self._fn = fn
        self._name = getattr(fn, "__name__", "udf")
        self._return_type = return_type
        self._deterministic = deterministic
        self._propagate_none = propagate_none
        if executor is None:
            executor = auto_executor(fn)
        if max_batch_size is not None:
            if not isinstance(executor, BatchExecutor):
                raise ValueError(
                    "max_batch_size requires a batch executor "
                    "(pw.udfs.batch_executor())"
                )
            # fresh instance: never mutate a caller-shared executor
            executor = BatchExecutor(max_batch_size=max_batch_size)
        self._executor = executor
        self._cache = cache_strategy
        self._retry = retry_strategy
        self._cache_name = cache_name or fn_cache_name(fn)

    def __call__(self, *args: Any, **kwargs: Any) -> ColumnExpression:
        rows_fn = functools.partial(
            self.execute_rows, n_pos=len(args), kw_names=tuple(kwargs)
        )
        return BatchApplyExpression(
            rows_fn,
            self._return_type,
            args,
            kwargs,
            propagate_none=self._propagate_none,
            deterministic=self._deterministic,
            name=self._name,
        )

    def execute_rows(
        self,
        rows: list[tuple],
        n_pos: int | None = None,
        kw_names: tuple = (),
    ) -> list[tuple[bool, Any]]:
        """(ok, value) per row, in row order. With a cache, hits are taken from it and
        each distinct missing argument tuple is computed once; successes are stored."""
        fn = make_kw_fn(
            self._fn, n_pos if n_pos is not None else len(rows[0]), list(kw_names)
        )
        if self._cache is None:
            return self._executor.run(fn, rows, self._retry)
        results: list[tuple[bool, Any] | None] = [None] * len(rows)
        keys = [_digest(self._cache_name, args) for args in rows]
        unique: dict[str, list[int]] = {}
        for i, key in enumerate(keys):
            hit = self._cache.get(key)
            if CacheStrategy.missing(hit):
                unique.setdefault(key, []).append(i)
            else:
                results[i] = (True, hit)
        if unique:
            reps = [idxs[0] for idxs in unique.values()]
            computed = self._executor.run(fn, [rows[i] for i in reps], self._retry)
            for rep, res in zip(reps, computed):
                for i in unique[keys[rep]]:
                    results[i] = res
                if res[0]:
                    self._cache.put(keys[rep], res[1])
        return results


def udf(
    fn: Callable[..., Any] | None = None,
    /,
    *,
    return_type: Any = None,
    deterministic: bool = False,
    propagate_none: bool = False,
    executor: Executor | None = None,
    cache_strategy: CacheStrategy | None = None,
    retry_strategy: AsyncRetryStrategy | None = None,
    max_batch_size: int | None = None,
) -> Any:
    """``@pw.udf`` decorator."""

    def make(f: Callable[..., Any]) -> UDF:
        u = UDF(
            f,
            return_type=return_type,
            deterministic=deterministic,
            propagate_none=propagate_none,
            executor=executor,
            cache_strategy=cache_strategy,
            retry_strategy=retry_strategy,
            max_batch_size=max_batch_size,
        )
        functools.update_wrapper(u, f, updated=())
        return u

    if fn is not None:
        return make(fn)
    return make


__all__ = [
    "AsyncExecutor",
    "AsyncRetryStrategy",
    "BatchExecutor",
    "CacheStrategy",
    "DefaultCache",
    "DiskCache",
    "ExponentialBackoffRetryStrategy",
    "Executor",
    "FixedDelayRetryStrategy",
    "InMemoryCache",
    "NoRetryStrategy",
    "SyncExecutor",
    "UDF",
    "async_executor",
    "auto_executor",
    "batch_executor",
    "set_udf_cache_root",
    "sync_executor",
    "udf",
]
