"""Retry strategies for UDF execution.

Counterpart of ``pathway_tpu/internals/udfs/retries.py``: the same schedule (the first
try, then ``max_retries`` more, each after a delay that grows by ``backoff_factor`` from
``initial_delay`` milliseconds, plus a uniform jitter of up to ``jitter_ms``), run as a
coroutine for the async executor (``invoke``) or blocking for the others
(``invoke_sync``). The last error is raised when every try failed.
"""

from __future__ import annotations

import asyncio
import random
import time
from typing import Any, Awaitable, Callable


class AsyncRetryStrategy:
    """Base: no retries."""

    async def invoke(self, fn: Callable[[], Awaitable[Any]]) -> Any:
        return await fn()

    def invoke_sync(self, fn: Callable[[], Any]) -> Any:
        return fn()


class NoRetryStrategy(AsyncRetryStrategy):
    pass


class ExponentialBackoffRetryStrategy(AsyncRetryStrategy):
    """Retry with exponentially growing delay + uniform jitter."""

    def __init__(
        self,
        max_retries: int = 3,
        initial_delay: int = 1_000,  # milliseconds, matching the reference
        backoff_factor: float = 2.0,
        jitter_ms: int = 300,
    ) -> None:
        self.max_retries = max_retries
        self.initial_delay = initial_delay / 1000.0
        self.backoff_factor = backoff_factor
        self.jitter = jitter_ms / 1000.0

    def _delays(self):
        delay = self.initial_delay
        for _ in range(self.max_retries):
            yield delay + random.uniform(0, self.jitter)
            delay *= self.backoff_factor

    async def invoke(self, fn: Callable[[], Awaitable[Any]]) -> Any:
        last: Exception | None = None
        try:
            return await fn()
        except Exception as e:  # noqa: BLE001
            last = e
        for delay in self._delays():
            await asyncio.sleep(delay)
            try:
                return await fn()
            except Exception as e:  # noqa: BLE001
                last = e
        assert last is not None
        raise last

    def invoke_sync(self, fn: Callable[[], Any]) -> Any:
        last: Exception | None = None
        try:
            return fn()
        except Exception as e:  # noqa: BLE001
            last = e
        for delay in self._delays():
            time.sleep(delay)
            try:
                return fn()
            except Exception as e:  # noqa: BLE001
                last = e
        assert last is not None
        raise last


class FixedDelayRetryStrategy(ExponentialBackoffRetryStrategy):
    """Retry with a constant delay between attempts."""

    def __init__(self, max_retries: int = 3, delay_ms: int = 1_000) -> None:
        super().__init__(
            max_retries=max_retries,
            initial_delay=delay_ms,
            backoff_factor=1.0,
            jitter_ms=0,
        )
