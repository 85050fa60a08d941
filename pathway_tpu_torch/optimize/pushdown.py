"""Projection pushdown: narrow producers to the columns their consumers read.

Counterpart of ``pathway_tpu/optimize/pushdown.py``. One backward sweep over the primary
scope (highest index first, so a narrowed downstream Expression shrinks the reference
set its own producer sees in the same pass). A producer is narrowed when

- it is an exact-type :class:`StaticSource` or :class:`ExpressionNode` inside the shared
  region, with at least one consumer;
- it is neither observed (``_pw_observed``, capture targets) nor protected, so the full
  consumer set is known and nobody reads its state directly;
- *every* consumer is a kind whose column references can be remapped in place:
  Expression (ColumnRef rewrite on a private copy of its expressions), BatchApply
  (``arg_cols``), Ix port 0 (``key_col``).

The pass only runs on graphs with sinks (a SubscribeNode, or protected consumers): in a
sink-less engine graph terminal and intermediate state is read directly, and a narrowed
row tuple would be visible there.

Narrowing is decided once on the primary scope and replayed on every other scope by
node index. Consumer expression trees are copied before the ColumnRef rewrite, since
compilers may share subtrees across nodes; leaf values are shared, never deep-copied,
so evaluated outputs stay the same objects.
"""

from __future__ import annotations

from pathway_tpu_torch.analysis.usage import expr_refs
from pathway_tpu_torch.engine import expression as ex
from pathway_tpu_torch.engine import graph as g


def _consumer_refs(consumer: g.Node, port: int) -> set[int] | None:
    """Producer columns ``consumer`` reads through ``port``; None when the consumer
    kind cannot be remapped (which vetoes narrowing)."""
    if type(consumer) is g.ExpressionNode and port == 0:
        refs: set[int] = set()
        for e in consumer.expressions:
            expr_refs(e, refs)
        return refs
    if type(consumer) is g.BatchApplyNode and port == 0:
        return set(consumer.arg_cols)
    if type(consumer) is g.IxNode and port == 0:
        return {consumer.key_col}
    return None


def _copy_expr(expr: ex.EngineExpression, memo: dict) -> ex.EngineExpression:
    """Copy an expression tree, sharing leaf values and keeping interior sharing
    (``memo``): only EngineExpression nodes are duplicated."""
    got = memo.get(id(expr))
    if got is not None:
        return got
    cls = type(expr)
    new = cls.__new__(cls)
    memo[id(expr)] = new
    for klass in cls.__mro__:
        for slot in getattr(klass, "__slots__", ()):
            try:
                v = getattr(expr, slot)
            except AttributeError:
                continue
            if isinstance(v, ex.EngineExpression):
                v = _copy_expr(v, memo)
            elif isinstance(v, list):
                v = [_copy_expr(i, memo) if isinstance(i, ex.EngineExpression) else i for i in v]
            elif isinstance(v, tuple):
                v = tuple(
                    _copy_expr(i, memo) if isinstance(i, ex.EngineExpression) else i for i in v
                )
            setattr(new, slot, v)
    return new


def _remap_refs(expr: ex.EngineExpression, mapping: dict, seen: set) -> None:
    """Rewrite every ColumnRef.index through ``mapping`` (on a copy, so mutation is
    safe; ``seen`` guards shared subtrees)."""
    if id(expr) in seen:
        return
    seen.add(id(expr))
    if isinstance(expr, ex.ColumnRef):
        expr.index = mapping[expr.index]
        return
    for klass in type(expr).__mro__:
        for slot in getattr(klass, "__slots__", ()):
            try:
                v = getattr(expr, slot)
            except AttributeError:
                continue
            if isinstance(v, ex.EngineExpression):
                _remap_refs(v, mapping, seen)
            elif isinstance(v, (list, tuple)):
                for item in v:
                    if isinstance(item, ex.EngineExpression):
                        _remap_refs(item, mapping, seen)


def _remap_consumer(consumer: g.Node, port: int, mapping: dict) -> None:
    if type(consumer) is g.ExpressionNode:
        memo: dict = {}
        seen: set = set()
        copied = [_copy_expr(e, memo) for e in consumer.expressions]
        for e in copied:
            _remap_refs(e, mapping, seen)
        consumer.expressions = copied
    elif type(consumer) is g.BatchApplyNode:
        consumer.arg_cols = [mapping[c] for c in consumer.arg_cols]
    elif type(consumer) is g.IxNode and port == 0:
        consumer.key_col = mapping[consumer.key_col]


def _apply_narrow(scope: g.Scope, index: int, keep: tuple, mapping: dict) -> None:
    node = scope.nodes[index]
    if type(node) is g.StaticSource:
        node._rows = [(k, tuple(r[c] for c in keep)) for k, r in node._rows]
    else:
        node.expressions = [node.expressions[c] for c in keep]
    node.arity = len(keep)
    for consumer, port in node.consumers:
        _remap_consumer(consumer, port, mapping)


def run(scopes: list, n_shared: int, protected: set) -> tuple[int, list[str]]:
    """Narrow dead producer columns across every scope of ``scopes``.

    Returns ``(columns_dropped, fingerprint_entries)``.
    """
    primary = scopes[0]
    has_sinks = any(isinstance(n, g.SubscribeNode) for n in primary.nodes)
    if not (has_sinks or protected):
        return 0, []
    dropped = 0
    fingerprint: list[str] = []
    for node in reversed(primary.nodes):
        if node.index >= n_shared:
            continue
        if type(node) not in (g.StaticSource, g.ExpressionNode):
            continue
        if node.index in protected or getattr(node, "_pw_observed", False):
            continue
        if not node.consumers:
            continue
        refs: set[int] = set()
        ok = True
        for consumer, port in node.consumers:
            if consumer.index >= n_shared:
                ok = False
                break
            r = _consumer_refs(consumer, port)
            if r is None:
                ok = False
                break
            refs |= r
        if not ok or any(c >= node.arity for c in refs):
            continue
        keep = tuple(sorted(refs)) or (0,)  # keep at least one column
        if len(keep) >= node.arity:
            continue
        old_arity = node.arity
        mapping = {c: i for i, c in enumerate(keep)}
        for scope in scopes:
            _apply_narrow(scope, node.index, keep, mapping)
        dropped += old_arity - len(keep)
        fingerprint.append(
            "narrow:%d:%s:%d:%s"
            % (node.index, type(node).__name__, old_arity, ",".join(map(str, keep)))
        )
    return dropped, fingerprint
