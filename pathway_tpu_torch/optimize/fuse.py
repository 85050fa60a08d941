"""Stateless-chain fusion: collapse Expression/Filter runs into one node.

Counterpart of ``pathway_tpu/optimize/fuse.py``. A *chain* is a maximal linear run
``n1 -> n2 -> ... -> nk`` (k >= 2) of exact-type :class:`ExpressionNode` /
:class:`FilterNode` operators where every non-tail member has exactly one consumer (the
next member, on port 0) and is neither observed (``_pw_observed``, capture targets) nor
protected. The tail is mutated in place into a :class:`FusedChainNode` that evaluates
the whole chain in one columnar sweep per :class:`DeltaBatch`; interior members become
inert placeholders, so every ``node.index`` keeps matching its position in
``scope.nodes``.

Correctness rests on two properties of the member kinds:

- insert processing is *stateless* (Expression evaluates, Filter drops), so composing
  the per-row transforms is function composition and interior nodes keep no state;
- deletions are retracted from a node's *own* output state, and both kinds preserve
  keys, so retracting once from the tail's state equals the unfused cascade: a key
  survives the tail's state iff it passed every interior filter, even for
  nondeterministic UDFs (the argument ``ExpressionNode.process`` makes for itself).

Errors are reported through the *original* stage nodes (kept inside ``_stages``), so
error-log names match the unfused graph exactly. In a commit the tracer samples, a
columnar sweep records a ``fused-sweep:<name or index>`` span.
"""

from __future__ import annotations

import time as _walltime

import numpy as np

from pathway_tpu_torch.engine import device
from pathway_tpu_torch.engine import graph as g
from pathway_tpu_torch.engine.batch import Columns, DeltaBatch, entry_keys_bytes
from pathway_tpu_torch.engine.expression import EvalContext
from pathway_tpu_torch.engine.value import is_error
from pathway_tpu_torch.internals import tracing as _tracing

#: exact types (not subclasses) eligible for chain membership
_MEMBER_TYPES = (g.ExpressionNode, g.FilterNode)


class _ArrayView:
    """Columnar view over already-evaluated stage arrays (mid-chain rows)."""

    __slots__ = ("arrays", "n")

    def __init__(self, arrays: list, n: int) -> None:
        self.arrays = arrays
        self.n = n

    def column(self, i: int):
        a = self.arrays[i]
        return a if a.dtype.kind in "bifU" else None


class _SelView:
    """Row subset of an input view (filters applied before the first expression
    stage); gathered columns are cached per index."""

    __slots__ = ("_base", "_sel", "_cache", "n")

    def __init__(self, base, sel: np.ndarray) -> None:
        self._base = base
        self._sel = sel
        self._cache: dict = {}
        self.n = int(len(sel))

    def column(self, i: int):
        got = self._cache.get(i, False)
        if got is not False:
            return got
        col = self._base.column(i)
        if col is not None:
            col = col[self._sel]
        self._cache[i] = col
        return col


class FusedChainNode(g.Node):
    """A fused Expression/Filter chain.

    Never constructed directly: :func:`apply_chain` mutates the chain tail's
    ``__class__``, so the node keeps its index, arity, name and state. ``_stages``
    holds ``("expr", node, expressions)`` / ``("filter", node, condition_col)``
    descriptors built from the original member nodes.
    """

    def process(self, time: int) -> DeltaBatch:
        batch = self.take_raw(0)
        if not (batch._insert_only or batch._raw_insert_only):
            batch = batch.consolidate()
        insert_only = batch._insert_only or batch._raw_insert_only
        if insert_only and len(batch) >= device.VECTOR_THRESHOLD:
            trace = _tracing.current()
            t0 = _walltime.perf_counter() if trace is not None else 0.0
            fast = self._columnar_sweep(batch)
            if fast is not None:
                if trace is not None:
                    trace.span(
                        f"fused-sweep:{getattr(self, 'name', '') or self.index}",
                        "op",
                        t0,
                        _walltime.perf_counter(),
                        mode="columnar",
                        rows=len(batch),
                        stages=len(self._stages),
                    )
                return fast
        out = DeltaBatch()
        if not insert_only:
            state = self.current  # the tail's output state: retract once, up front
            for key, row, diff in batch:
                if diff < 0:
                    prev = state.get(key)
                    if prev is not None:
                        out.append(key, prev, diff)
        inserts = batch.entries if insert_only else [e for e in batch if e[2] > 0]
        for key, row, diff in self._staged_rows(inserts):
            out.append(key, row, diff)
        return out

    # -- row path ---------------------------------------------------------------

    def _staged_rows(self, rows: list) -> list:
        """Run the insert list through every stage in order; errors report through
        the stage's original node, so names match the unfused run."""
        for kind, stage, spec in self._stages:
            if not rows:
                break
            if kind == "expr":
                ctx = EvalContext()
                rows = [
                    (key, tuple(e.evaluate(key, row, ctx) for e in spec), diff)
                    for key, row, diff in rows
                ]
                for key, message in ctx.errors:
                    stage.report(key, message)
            else:
                kept = []
                for key, row, diff in rows:
                    cond = row[spec]
                    if is_error(cond):
                        stage.report(key, "error value in filter condition")
                        continue
                    if cond:
                        kept.append((key, row, diff))
                rows = kept
        return rows

    # -- columnar sweep -----------------------------------------------------------

    def _columnar_sweep(self, batch: DeltaBatch) -> DeltaBatch | None:
        """An insert-only batch through the whole chain with no intermediate batch;
        None falls back to the row path."""
        payload = batch.columns
        entries = None
        if payload is not None:
            view = device.PayloadView(payload)
        else:
            entries = batch.entries
            view = device.ColumnarView(entries, from_entries=True)
        arrays: list | None = None  # None: rows still have the input layout
        sel: np.ndarray | None = None  # surviving original-row indices
        n_cur = view.n
        for kind, _stage, spec in self._stages:
            if n_cur == 0:
                break
            if kind == "expr":
                if arrays is None:
                    cur = view if sel is None else _SelView(view, sel)
                else:
                    cur = _ArrayView(arrays, n_cur)
                nxt = []
                for expr in spec:
                    try:
                        nxt.append(device.eval_columnar(expr, cur))
                    except device.NotVectorizable:
                        return None
                arrays = nxt
            else:
                if arrays is None:
                    cur = view if sel is None else _SelView(view, sel)
                    cond = cur.column(spec)
                else:
                    cond = arrays[spec]
                if cond is None or cond.dtype.kind != "b":
                    return None
                if cond.all():
                    continue
                if arrays is not None:
                    arrays = [a[cond] for a in arrays]
                sel = np.flatnonzero(cond) if sel is None else sel[cond]
                n_cur = int(len(sel))
        if n_cur == 0:
            return DeltaBatch()
        hint = batch._insert_only
        if arrays is None:
            # a chain of filters only: the original rows survive at ``sel``
            if payload is not None:
                cols = payload if sel is None else payload.gather(sel)
                out = DeltaBatch.from_columns(cols, consolidated=hint, insert_only=hint)
                out._raw_insert_only = batch._raw_insert_only or out._insert_only
                return out
            out = DeltaBatch()
            out.entries = list(entries) if sel is None else [entries[i] for i in sel]
            out._consolidated = hint
            out._insert_only = hint
            out._raw_insert_only = True
            return out
        if sel is None:
            if payload is not None:
                out_payload = Columns.with_keys_of(payload, arrays)
            else:
                kb = entry_keys_bytes(entries)
                if kb is None:
                    return None  # non-Pointer keys: row path
                out_payload = Columns(n_cur, arrays, kbytes=kb)
        else:
            kobjs = None
            if payload is not None:
                kb, kobjs = payload.keys_gather(sel)
            else:
                kb = entry_keys_bytes(entries)
                if kb is None:
                    return None
                kb = kb[sel]
            out_payload = Columns(n_cur, arrays, kbytes=kb, kobjs=kobjs)
        out = DeltaBatch.from_columns(out_payload, consolidated=hint, insert_only=hint)
        out._raw_insert_only = batch._raw_insert_only or out._insert_only
        return out


# -- chain discovery and application ------------------------------------------------


def _observed(node: g.Node) -> bool:
    return bool(getattr(node, "_pw_observed", False))


def _link(node: g.Node, n_shared: int, protected: set) -> g.Node | None:
    """The unique next chain member after ``node``, or None. ``node`` must be fusable
    as a non-tail member: exact member type, inside the shared region, neither observed
    nor protected, and consumed by exactly one node that is itself a candidate."""
    if type(node) not in _MEMBER_TYPES or node.index >= n_shared:
        return None
    if node.index in protected or _observed(node):
        return None
    if len(node.consumers) != 1:
        return None
    nxt, port = node.consumers[0]
    if port != 0 or type(nxt) not in _MEMBER_TYPES or nxt.index >= n_shared:
        return None
    return nxt


def find_chains(scope: g.Scope, n_shared: int, protected: set) -> list[list[int]]:
    """Maximal fusable chains on the primary scope, as index lists (length >= 2)."""
    link: dict[int, int] = {}
    for node in scope.nodes:
        nxt = _link(node, n_shared, protected)
        if nxt is not None:
            link[node.index] = nxt.index
    linked_to = set(link.values())
    chains = []
    for node in scope.nodes:
        idx = node.index
        if idx not in link or idx in linked_to:
            continue
        chain = [idx]
        while idx in link:
            idx = link[idx]
            chain.append(idx)
        chains.append(chain)
    return chains


def apply_chain(scope: g.Scope, chain: list[int]) -> g.Node:
    """Mutate one scope in place: the tail becomes the FusedChainNode, the interiors
    inert placeholders (indices kept)."""
    nodes = scope.nodes
    members = [nodes[i] for i in chain]
    head, tail = members[0], members[-1]
    stages = []
    for m in members:
        if type(m) is g.ExpressionNode:
            stages.append(("expr", m, list(m.expressions)))
        else:
            stages.append(("filter", m, m.condition_col))
    producer = head.inputs[0]
    producer.consumers = [
        (tail, p) if (c is head and p == 0) else (c, p) for c, p in producer.consumers
    ]
    tail.__class__ = FusedChainNode
    tail._stages = stages
    tail.inputs = [producer]
    for m in members[:-1]:
        m.inputs = []
        m.consumers = []
        m.pending = {}
        m._pw_fused_into = tail.index
    return tail
