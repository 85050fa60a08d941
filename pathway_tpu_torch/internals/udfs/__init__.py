"""UDFs: ``pw.udf`` and the ``UDF`` class, run by the engine in commit batches.

Counterpart of ``pathway_tpu/internals/udfs/__init__.py``. A UDF call inside ``select``
lowers to the engine's BatchApplyNode, which hands whole commit batches of rows to the
UDF's executor: device UDFs (the embedder) get micro-batches instead of rows. The UDF
caches, retries and the async executor are not ported yet (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import functools
import hashlib
from typing import Any, Callable

from pathway_tpu_torch.internals.expression import (
    BatchApplyExpression,
    ColumnExpression,
)
from pathway_tpu_torch.internals.udfs.executors import (
    BatchExecutor,
    Executor,
    SyncExecutor,
    auto_executor,
    batch_executor,
    make_kw_fn,
    sync_executor,
)


def fn_cache_name(fn: Callable) -> str:
    """Stable-across-runs identifier for a function: module + qualname + bytecode
    digest (the JAX package's cache-key name for a UDF)."""
    module = getattr(fn, "__module__", "?")
    qualname = getattr(fn, "__qualname__", getattr(fn, "__name__", "udf"))
    code = getattr(fn, "__code__", None)
    code_hash = (
        hashlib.sha256(code.co_code).hexdigest()[:16] if code is not None else ""
    )
    return f"{module}.{qualname}#{code_hash}"


class UDF:
    """A callable lowered to engine batch execution when used in ``select``.

    Subclass with ``__wrapped__`` or pass ``fn``; calling it with column expressions
    builds the expression node. ``cache_name`` names the function for result caches
    (closure-configured UDFs pass one that includes their configuration).
    """

    def __init__(
        self,
        fn: Callable[..., Any] | None = None,
        *,
        return_type: Any = None,
        deterministic: bool = False,
        propagate_none: bool = False,
        executor: Executor | None = None,
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
        """(ok, value) per row, in row order."""
        fn = make_kw_fn(
            self._fn, n_pos if n_pos is not None else len(rows[0]), list(kw_names)
        )
        return self._executor.run(fn, rows)


def udf(
    fn: Callable[..., Any] | None = None,
    /,
    *,
    return_type: Any = None,
    deterministic: bool = False,
    propagate_none: bool = False,
    executor: Executor | None = None,
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
            max_batch_size=max_batch_size,
        )
        functools.update_wrapper(u, f, updated=())
        return u

    if fn is not None:
        return make(fn)
    return make


__all__ = [
    "BatchExecutor",
    "Executor",
    "SyncExecutor",
    "UDF",
    "batch_executor",
    "sync_executor",
    "udf",
]
