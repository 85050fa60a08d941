"""Analyze-only execution mode: the gate the graph optimizer reads.

Counterpart of ``pathway_tpu/analysis/runtime.py``. Under ``PATHWAY_TPU_ANALYZE=1`` the
JAX package's schedulers analyze each scope instead of running it, and the optimizer
skips itself so the report describes the graph the user wrote. The port has the gate;
the analyzer that ``record_scope`` and ``intercept`` drive is not ported yet (ROADMAP
queue 1 item 8), so those names raise ``NotImplementedError``.
"""

from __future__ import annotations

import os

from pathway_tpu_torch.internals.unported import module_getattr


def enabled() -> bool:
    """True when the process runs in analyze mode."""
    return os.environ.get("PATHWAY_TPU_ANALYZE") == "1"


# the schedulers' "should I skip execution?", named for the call site
analyze_only = enabled

__getattr__ = module_getattr(__name__, dict.fromkeys(
    ("record_scope", "intercept"), "8: the rest of the package (the static analyzer)"
))
