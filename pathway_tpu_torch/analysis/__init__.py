"""Pre-execution static analysis over the engine graph.

Counterpart of ``pathway_tpu/analysis/``. Ported so far are the parts the graph
optimizer reads: the analyze-mode gate (:func:`runtime.enabled`, which turns the
optimizer off), the expression reference walk (:func:`usage.expr_refs`, projection
pushdown's consumer model) and the shard-preservation model (:func:`shards.out_specs`,
:func:`shards.redundant_edges`, the exchange-elision oracle). The analyzer itself (its
passes, findings and reports, ``analyze_scope``, ``check_strict`` and ``cli analyze``)
is not ported yet (ROADMAP queue 1 item 8): those names raise ``NotImplementedError``.
"""

from pathway_tpu_torch.analysis.runtime import analyze_only, enabled
from pathway_tpu_torch.internals.unported import module_getattr

__all__ = ["analyze_only", "enabled"]

__getattr__ = module_getattr(__name__, dict.fromkeys(
    (
        "FINDING_CODES",
        "AnalysisError",
        "Finding",
        "Report",
        "Severity",
        "analyze_scope",
        "check_strict",
        "intercept",
        "record_scope",
    ),
    "8: the rest of the package (the static analyzer)",
))
