"""Which input columns an expression reads.

Counterpart of ``pathway_tpu/analysis/usage.py``'s :func:`expr_refs`, the consumer model
of the optimizer's projection pushdown. The dead-column pass itself (``input_needs``,
``run_pass``) belongs to the analyzer, which is not ported yet (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

from pathway_tpu_torch.engine import expression as ex
from pathway_tpu_torch.internals.unported import module_getattr


def expr_refs(expr: ex.EngineExpression, out: set[int] | None = None) -> set[int]:
    """All input column indices an expression tree reads."""
    if out is None:
        out = set()
    if isinstance(expr, ex.ColumnRef):
        out.add(expr.index)
        return out
    children: list[ex.EngineExpression] = []
    if isinstance(expr, ex.Binary):
        children = [expr.left, expr.right]
    elif isinstance(expr, ex.Unary):
        children = [expr.arg]
    elif isinstance(expr, (ex.BooleanChain, ex.MakeTuple, ex.Coalesce)):
        children = list(expr.args)
    elif isinstance(expr, ex.IfElse):
        children = [expr.cond, expr.then, expr.otherwise]
    elif isinstance(expr, (ex.IsNone, ex.Unwrap)):
        children = [expr.arg]
    elif isinstance(expr, ex.Require):
        children = [expr.value, *expr.deps]
    elif isinstance(expr, (ex.SequenceGet, ex.JsonGet)):
        children = [expr.arg, expr.index]
        if expr.default is not None:
            children.append(expr.default)
    elif isinstance(expr, (ex.Cast, ex.Convert)):
        children = [expr.arg]
    elif isinstance(expr, ex.FillError):
        children = [expr.arg, expr.fallback]
    elif isinstance(expr, ex.Apply):
        children = list(expr.args)
    elif isinstance(expr, ex.PointerFrom):
        children = list(expr.args)
        if expr.instance is not None:
            children.append(expr.instance)
    for child in children:
        expr_refs(child, out)
    return out


__getattr__ = module_getattr(__name__, dict.fromkeys(
    ("input_needs", "run_pass"), "8: the rest of the package (the static analyzer)"
))
