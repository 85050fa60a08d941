"""``pw.io.logstash``: stream a table's updates into Logstash's HTTP input plugin.

Counterpart of ``pathway_tpu/io/logstash.py``: a thin wrapper over ``pw.io.http.write``
(one JSON object a change, with ``time`` and ``diff``)."""

from __future__ import annotations

from typing import Any, Callable

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.io.http import RetryPolicy
from pathway_tpu_torch.io.http import write as _http_write


def write(
    table: Table,
    endpoint: str,
    n_retries: int = 0,
    retry_policy: RetryPolicy | None = None,
    *,
    request_fn: Callable[[str, dict], Any] | None = None,
    **kwargs: Any,
) -> None:
    _http_write(
        table, endpoint, n_retries=n_retries, retry_policy=retry_policy, request_fn=request_fn
    )
