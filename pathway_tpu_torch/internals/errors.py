"""Error-log tables: ``pw.global_error_log()`` / ``pw.local_error_log()``.

A copy of ``pathway_tpu/internals/errors.py``: rows that fail evaluation poison to
``ERROR`` and the message lands in an error-log table, the global one by default, or a
local one for operators built inside a ``with pw.local_error_log() as log:`` block.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Iterator

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.table import Table, TableSpec

_log_ids = itertools.count(1)
_active_log_ids: list[int] = []


def current_log_id() -> int | None:
    """The local error log in scope at Table-construction time (None =
    global). Consulted by Table.__init__."""
    return _active_log_ids[-1] if _active_log_ids else None


def _log_table(log_id: int | None) -> Table:
    return Table(
        TableSpec("error_log", [], {"log_id": log_id}),
        ["message"],
        {"message": dt.STR},
    )


def global_error_log() -> Table:
    """All error messages of the run (reference pw.global_error_log)."""
    return _log_table(None)


@contextlib.contextmanager
def local_error_log() -> Iterator[Table]:
    """Errors of operators built inside the block route to the yielded
    table instead of the global log."""
    log_id = next(_log_ids)
    _active_log_ids.append(log_id)
    try:
        yield _log_table(log_id)
    finally:
        _active_log_ids.pop()
