"""User-code trace attribution (a copy of ``pathway_tpu/internals/trace.py``).

Each operator/table records the first user-code frame that created it, so
engine errors point at user code, not framework internals.
"""

from __future__ import annotations

import os
import traceback
from dataclasses import dataclass

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass(frozen=True)
class Trace:
    file: str
    line: int
    function: str
    line_text: str

    def __str__(self) -> str:
        return f"{self.file}:{self.line} in {self.function}"


def current_trace() -> Trace | None:
    """First stack frame outside the pathway_tpu_torch package."""
    for frame in reversed(traceback.extract_stack()[:-1]):
        filename = os.path.abspath(frame.filename)
        if not filename.startswith(_PKG_ROOT):
            return Trace(
                file=frame.filename,
                line=frame.lineno or 0,
                function=frame.name,
                line_text=frame.line or "",
            )
    return None
