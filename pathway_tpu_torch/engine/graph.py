"""Engine graph: operator nodes, the Scope API that builds them, and the commit
scheduler.

Counterpart of ``pathway_tpu/engine/graph.py``. Tables are keyed update streams
processed per commit: every operator consumes consolidated delta batches at time ``t``
and emits output deltas at ``t``. Ported here: static tables and input sessions,
per-row expressions (with the columnar NumPy evaluator for large insert-only batches),
batched UDF application, filter, concat, reindex, key filters (intersect, subtract,
restrict), universe overrides, zips of same-universe tables, the equality join (inner,
left, right, outer; columnar while insert-only and inner), the groupby with every
reducer (columnar array state for count and sum), deduplicate, flatten, sort (prev/next
pointers per instance), ix, update rows and cells, subscribe sinks, error logs and error
removal.

The device work happens inside the operators: UDF micro-batches and vector search, and
under the columnar groupby and join the device operators of ``engine/device_ops.py``
(the groupby's segment reductions in the ordered segment-sum kernel, the join's pair
matcher in torch ops), held bit for bit to the host kernels. Where the JAX code
branches on its C++ host kernels (``pathway_tpu.native``), this module takes the
NumPy/Python branch. The scheduler ends each commit in the device pipeline's commit
boundary (``engine.device_pipeline.commit_boundary``), which stages the commit's device
batches for completion on its own thread, or completes them inline under
``PATHWAY_TPU_ASYNC_DEVICE=0``. ``Scheduler(probe=True)`` keeps per-operator counts and
times (:class:`OperatorStats`).

The temporal operators live in ``engine/temporal.py`` and ``pw.iterate``'s node in
``engine/iterate.py``; both share this module's Node and :func:`emit_local_group_diffs`.
The row transformers' recompute node is not ported yet (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import hashlib
import itertools
import time as _walltime
from typing import Any, Callable, Iterable, Sequence

import numpy as np

from pathway_tpu_torch.engine import device as _device
from pathway_tpu_torch.engine import device_ops as _device_ops
from pathway_tpu_torch.engine import device_pipeline
from pathway_tpu_torch.engine.batch import (
    Columns,
    DeltaBatch,
    apply_batch_to_state,
    entry_keys_bytes,
)
from pathway_tpu_torch.engine.device import VECTOR_THRESHOLD
from pathway_tpu_torch.engine.expression import EngineExpression, EvalContext
from pathway_tpu_torch.engine.reducers import Reducer, ReducerKind
from pathway_tpu_torch.engine.value import (
    ERROR,
    Pointer,
    hash_values,
    is_error,
    rows_differ,
)
from pathway_tpu_torch.internals import metrics as _metrics


class Node:
    """An operator in the engine graph."""

    def __init__(self, scope: "Scope", inputs: Sequence["Node"], arity: int) -> None:
        self.scope = scope
        self.inputs = list(inputs)
        self.arity = arity
        self.index = len(scope.nodes)
        scope.nodes.append(self)
        self.consumers: list[tuple[Node, int]] = []
        self.pending: dict[int, list[DeltaBatch]] = {}
        self._state: dict[Pointer, tuple] = {}
        self._state_lag: list[DeltaBatch] = []
        self._state_lag_rows = 0
        self.name: str = type(self).__name__
        self.trace: Any = None
        for port, inp in enumerate(self.inputs):
            inp.consumers.append((self, port))

    # A node's ``current`` (key -> row) is needed only when something reads it (a
    # retraction arriving here, a consumer that peeks at its input's state, a test):
    # output batches are kept and applied on first read. The rows cap bounds memory
    # for long streams whose state nobody reads.

    _STATE_LAG_MAX_ROWS = 1 << 21

    @property
    def current(self) -> dict[Pointer, tuple]:
        if self._state_lag:
            lag, self._state_lag = self._state_lag, []
            self._state_lag_rows = 0
            for batch in lag:
                apply_batch_to_state(self._state, batch.consolidate())
        return self._state

    @current.setter
    def current(self, value: dict[Pointer, tuple]) -> None:
        self._state = value
        self._state_lag = []
        self._state_lag_rows = 0

    def _defer_state(self, batch: DeltaBatch) -> None:
        """Queue an output batch for application to ``current`` on its next read."""
        if batch:
            self._state_lag.append(batch)
            self._state_lag_rows += len(batch)
            if self._state_lag_rows > self._STATE_LAG_MAX_ROWS:
                self.current  # noqa: B018 — drain via the property

    # -- scheduler interface ------------------------------------------------

    def has_pending(self) -> bool:
        return bool(self.pending)

    def take(self, port: int) -> DeltaBatch:
        return self.take_raw(port).consolidate()

    def take_raw(self, port: int) -> DeltaBatch:
        batches = self.pending.pop(port, None)
        if not batches:
            return DeltaBatch()
        if len(batches) == 1:
            return batches[0]
        if all(b._entries is None for b in batches):
            # stay columnar: stacking arrays keeps the downstream segment consumer
            # free of per-row objects
            stacked = Columns.concat([b.columns for b in batches])
            if stacked is not None:
                out = DeltaBatch.from_columns(stacked, consolidated=False)
                # all-+1 parts stay all-+1 stacked (keys may repeat across parts, so
                # the insert_only flag, which asserts uniqueness, does not carry over)
                out._raw_insert_only = all(b._raw_insert_only for b in batches)
                return out
        merged = DeltaBatch()
        for b in batches:
            merged.extend(b)
        return merged

    def push(self, port: int, batch: DeltaBatch) -> None:
        if batch:
            self.pending.setdefault(port, []).append(batch)

    def process(self, time: int) -> DeltaBatch:
        raise NotImplementedError

    def on_time_end(self, time: int) -> None:
        pass

    def on_end(self) -> None:
        pass

    def close(self) -> None:
        """Final teardown, after the settlement commit that follows ``on_end``."""

    def report(self, key: Pointer | None, message: str) -> None:
        self.scope.report_error(self, key, message)

    def snapshot(self) -> dict[Pointer, tuple]:
        return dict(self.current)


class StaticSource(Node):
    """A table fully known when the graph is built."""

    def __init__(self, scope: "Scope", rows: Iterable[tuple[Pointer, tuple]], arity: int):
        super().__init__(scope, [], arity)
        self._rows = list(rows)
        self._emitted = False

    def initial_batch(self) -> DeltaBatch | None:
        if self._emitted:
            return None
        self._emitted = True
        out = DeltaBatch((k, r, 1) for k, r in self._rows)
        out._raw_insert_only = True  # every diff is +1 by construction
        return out

    def process(self, time: int) -> DeltaBatch:
        return self.take_raw(0)  # pass-through: consumers consolidate


class InputSession(Node):
    """Mutable input: connectors push inserts, removes and upserts, then commit. In
    upsert mode an insert for an existing key retracts the previous row first."""

    def __init__(self, scope: "Scope", arity: int, upsert: bool = False):
        super().__init__(scope, [], arity)
        self.upsert = upsert
        self._buffer: list[tuple[Pointer, tuple | None, int]] = []
        self._has_removals = False
        self._has_rowless_removals = False

    def insert(self, key: Pointer, row: tuple) -> None:
        self._buffer.append((key, row, 1))

    def remove(self, key: Pointer, row: tuple | None = None) -> None:
        self._buffer.append((key, row, -1))
        self._has_removals = True
        if row is None:
            self._has_rowless_removals = True

    def flush(self) -> DeltaBatch | None:
        if not self._buffer:
            return None
        if not self.upsert and not self._has_rowless_removals:
            # plain inserts, or removals that carry their row: no overlay needed
            out = DeltaBatch(self._buffer)
            self._buffer = []
            if not self._has_removals:
                # every diff is +1: multiset-correct consumers (the columnar join and
                # groupby) take the hint, dict-state consumers consolidate in take()
                out._raw_insert_only = True
            self._has_removals = False
            return out
        state = self.current
        out = DeltaBatch()
        # overlay of keys touched this commit: key -> row | None (absent row)
        overlay: dict[Pointer, tuple | None] = {}

        def effective(key: Pointer) -> tuple | None:
            if key in overlay:
                return overlay[key]
            return state.get(key)

        if self.upsert:
            for key, row, diff in self._buffer:
                prev = effective(key)
                if diff > 0:
                    if prev is not None:
                        out.append(key, prev, -1)
                    out.append(key, row, 1)
                    overlay[key] = row
                elif prev is not None:
                    out.append(key, prev, -1)
                    overlay[key] = None
        else:
            for key, row, diff in self._buffer:
                if diff < 0 and row is None:
                    row = effective(key)
                    if row is None:
                        continue
                if diff > 0:
                    overlay[key] = row
                elif effective(key) == row:
                    overlay[key] = None
                out.append(key, row, diff)  # type: ignore[arg-type]
        self._buffer.clear()
        self._has_removals = False
        self._has_rowless_removals = False
        return out.consolidate()

    def process(self, time: int) -> DeltaBatch:
        # pass-through, raw: diff-linear consumers (the columnar groupby) skip the
        # consolidation
        return self.take_raw(0)


class ExpressionNode(Node):
    """Per-row expression evaluation (select). Deletions are retracted from
    ``current`` rather than evaluated again, which keeps nondeterministic outputs
    consistent between insert and delete. Insert-only batches of at least
    ``VECTOR_THRESHOLD`` rows run through the columnar evaluator
    (``device.eval_columnar``) where every expression vectorizes."""

    def __init__(
        self,
        scope: "Scope",
        source: Node,
        expressions: Sequence[EngineExpression],
    ) -> None:
        super().__init__(scope, [source], len(expressions))
        self.expressions = list(expressions)

    def _columnar_inserts(self, batch: DeltaBatch) -> DeltaBatch | None:
        """A pure-insert batch as a columnar output sharing the input's keys; None
        falls back to the row paths."""
        payload = batch.columns
        if payload is not None:
            view: Any = _device.PayloadView(payload)
        else:
            view = _device.ColumnarView(batch.entries, from_entries=True)
        arrays = []
        for expr in self.expressions:
            try:
                arrays.append(_device.eval_columnar(expr, view))
            except _device.NotVectorizable:
                return None
        if payload is not None:
            out_payload = Columns.with_keys_of(payload, arrays)
        else:
            entries = batch.entries
            kb = entry_keys_bytes(entries)
            if kb is None:
                return None  # non-Pointer keys: row path
            out_payload = Columns(len(entries), arrays, kbytes=kb)
        out = DeltaBatch.from_columns(
            out_payload, consolidated=batch._insert_only, insert_only=batch._insert_only
        )
        # the keys are the input's: its all-+1 hint carries over
        out._raw_insert_only = batch._raw_insert_only or out._insert_only
        return out

    def process(self, time: int) -> DeltaBatch:
        batch = self.take_raw(0)
        if not (batch._insert_only or batch._raw_insert_only):
            batch = batch.consolidate()
        insert_only = batch._insert_only or batch._raw_insert_only
        if insert_only and len(batch) >= VECTOR_THRESHOLD:
            fast = self._columnar_inserts(batch)
            if fast is not None:
                return fast
        out = DeltaBatch()
        ctx = EvalContext()
        if not insert_only:
            state = self.current
            for key, _row, diff in batch:
                if diff < 0:
                    prev = state.get(key)
                    if prev is not None:
                        out.append(key, prev, diff)
        inserts = batch.entries if insert_only else [e for e in batch if e[2] > 0]
        if len(inserts) >= VECTOR_THRESHOLD:
            # columnar eval with row output (the retraction case, or non-Pointer
            # keys); None on mixed columns
            cols = _device.eval_expressions_columnar_cols(
                self.expressions, inserts, from_entries=True
            )
            if cols is not None:
                fresh = not out.entries
                if not cols:  # arity-0 select: one () row per key
                    out.entries.extend((key, (), diff) for key, _row, diff in inserts)
                else:
                    out.entries.extend(
                        (key, new_row, diff)
                        for (key, _row, diff), new_row in zip(inserts, zip(*cols))
                    )
                if fresh and batch._insert_only:
                    out._consolidated = True
                    out._insert_only = True
                return out
        for key, row, diff in inserts:
            new_row = tuple(expr.evaluate(key, row, ctx) for expr in self.expressions)
            out.append(key, new_row, diff)
        for key, message in ctx.errors:
            self.report(key, message)
        return out


class BatchApplyNode(Node):
    """Batched UDF execution over the argument table (arity 1 output): all rows
    inserted in a commit go to ``rows_fn`` at once, and the executor decides how to
    run them (device micro-batches for the embedder). Deletions retract the kept
    value, so nondeterministic UDF outputs always cancel."""

    def __init__(
        self,
        scope: "Scope",
        source: Node,
        rows_fn: Callable[[list], list],
        arg_cols: Sequence[int],
        propagate_none: bool = False,
    ) -> None:
        super().__init__(scope, [source], 1)
        self.rows_fn = rows_fn
        self.arg_cols = list(arg_cols)
        self.propagate_none = propagate_none

    def process(self, time: int) -> DeltaBatch:
        batch = self.take(0)
        out = DeltaBatch()
        state = self.current
        for key, _row, diff in batch:
            if diff < 0:
                prev = state.get(key)
                if prev is not None:
                    out.append(key, prev, diff)
        pending: list[tuple[Pointer, tuple, int]] = []
        for key, row, diff in batch:
            if diff <= 0:
                continue
            args = tuple(row[c] for c in self.arg_cols)
            if any(is_error(a) for a in args):
                self.report(key, "error value in UDF argument")
                out.append(key, (ERROR,), diff)
                continue
            if self.propagate_none and any(a is None for a in args):
                out.append(key, (None,), diff)
                continue
            pending.append((key, args, diff))
        if pending:
            try:
                results = self.rows_fn([args for _k, args, _d in pending])
            except Exception as e:  # noqa: BLE001 — whole-batch failure
                results = [(False, e)] * len(pending)
            for (key, _args, diff), (ok, value) in zip(pending, results):
                if ok:
                    out.append(key, (value,), diff)
                else:
                    self.report(key, f"UDF error: {value!r}")
                    out.append(key, (ERROR,), diff)
        return out


class FilterNode(Node):
    """Keep the rows whose condition column is true (filter)."""

    def __init__(self, scope: "Scope", source: Node, condition_col: int) -> None:
        super().__init__(scope, [source], source.arity)
        self.condition_col = condition_col

    def process(self, time: int) -> DeltaBatch:
        batch = self.take_raw(0)
        if not (batch._insert_only or batch._raw_insert_only):
            batch = batch.consolidate()
        c = self.condition_col
        if batch._insert_only or batch._raw_insert_only:
            payload = batch.columns
            if payload is not None and payload.cols[c].dtype.kind == "b":
                # columnar mask-compress: keys and columns stay arrays
                out = DeltaBatch.from_columns(
                    payload.compress(payload.cols[c]),
                    consolidated=batch._insert_only,
                    insert_only=batch._insert_only,
                )
                out._raw_insert_only = batch._raw_insert_only or out._insert_only
                return out
            if not any(is_error(e[1][c]) for e in batch.entries):
                # no retractions and no error conditions: one comprehension
                out = DeltaBatch()
                out.entries = [e for e in batch.entries if e[1][c]]
                out._consolidated = batch._insert_only
                out._insert_only = batch._insert_only
                out._raw_insert_only = True
                return out
            batch = batch.consolidate()  # ERROR rows: exact row semantics
        out = DeltaBatch()
        state = self.current
        for key, row, diff in batch:
            if diff < 0:
                if key in state:
                    out.append(key, state[key], diff)
                continue
            cond = row[c]
            if is_error(cond):
                self.report(key, "error value in filter condition")
                continue
            if cond:
                out.append(key, row, diff)
        return out


def _keys_unique(kb: np.ndarray, n: int) -> bool:
    """Vectorized uniqueness screen over (n, 16) key bytes. Keys are uniform 128-bit
    content hashes, so unique low 64 bits imply unique keys; only a low-64-bit
    collision pays the full check."""
    if n < 2:
        return True
    lo = np.sort(np.ascontiguousarray(kb[:, :8]).view(np.uint64).ravel())
    if not (lo[1:] == lo[:-1]).any():
        return True
    v = np.ascontiguousarray(kb).view(np.dtype((np.void, 16))).ravel()
    return len(np.unique(v)) == n


class ConcatNode(Node):
    """Disjoint union of universes (concat)."""

    def __init__(self, scope: "Scope", sources: Sequence[Node]) -> None:
        arity = sources[0].arity
        assert all(s.arity == arity for s in sources)
        super().__init__(scope, list(sources), arity)

    def _columnar_bulk(self, batches: list[DeltaBatch]) -> DeltaBatch | None:
        """Cold-state pure-insert concat: stack the columnar payloads and screen the
        keys' uniqueness across inputs vectorized. None falls back to the row loop."""
        if self._state or self._state_lag:
            return None  # membership checks against earlier keys: row path
        payloads = []
        for b in batches:
            if not b:
                continue
            if b.columns is None or not (b._insert_only or b._raw_insert_only):
                return None
            payloads.append(b.columns)
        if not payloads:
            return DeltaBatch()
        stacked = payloads[0] if len(payloads) == 1 else Columns.concat(payloads)
        if stacked is None or stacked.diffs is not None:
            return None
        try:
            kb = stacked.kbytes()
        except (OverflowError, TypeError):
            return None
        if not _keys_unique(np.ascontiguousarray(kb), stacked.n):
            return None  # duplicate keys need the reporting row path
        return DeltaBatch.from_columns(stacked, consolidated=True, insert_only=True)

    def process(self, time: int) -> DeltaBatch:
        batches = [self.take_raw(port) for port in range(len(self.inputs))]
        fast = self._columnar_bulk(batches)
        if fast is not None:
            return fast
        out = DeltaBatch()
        seen = set(self.current)
        for batch in batches:
            for key, row, diff in batch.consolidate():
                if diff > 0:
                    if key in seen:
                        self.report(key, "duplicate key in concat")
                        continue
                    seen.add(key)
                else:
                    seen.discard(key)
                out.append(key, row, diff)
        return out.consolidate()


class ReindexNode(Node):
    """Re-key a table by a pointer column (reindex, with_id, with_id_from)."""

    def __init__(self, scope: "Scope", source: Node, key_col: int) -> None:
        super().__init__(scope, [source], source.arity)
        self.key_col = key_col

    def process(self, time: int) -> DeltaBatch:
        batch = self.take(0)
        out = DeltaBatch()
        for key, row, diff in batch:
            new_key = row[self.key_col]
            if is_error(new_key) or not isinstance(new_key, Pointer):
                self.report(key, f"reindex id must be a pointer, got {new_key!r}")
                continue
            out.append(new_key, row, diff)
        return out.consolidate()


class KeyFilterNode(Node):
    """intersect / subtract / restrict: keep the rows whose keys are (or are not) in
    other tables' key sets."""

    def __init__(
        self, scope: "Scope", source: Node, others: Sequence[Node], mode: str
    ) -> None:
        super().__init__(scope, [source, *others], source.arity)
        assert mode in ("intersect", "subtract", "restrict")
        self.mode = mode

    def _member_in(self, key: Pointer, other_states: list[dict]) -> bool:
        if self.mode == "subtract":
            return not any(key in s for s in other_states)
        return all(key in s for s in other_states)

    def process(self, time: int) -> DeltaBatch:
        source = self.inputs[0]
        src_batch = self.take(0)
        # membership deltas from the other sides
        affected: set[Pointer] = set()
        for port in range(1, len(self.inputs)):
            for key, _row, _diff in self.take(port):
                affected.add(key)
        out = DeltaBatch()
        handled: set[Pointer] = set()
        for key, _row, _diff in src_batch:
            handled.add(key)
        state = self.current
        others = [o.current for o in self.inputs[1:]]
        src_state = source.current if affected else None
        # keys whose membership may flip (and are not already being updated)
        for key in affected - handled:
            row = src_state.get(key)
            was = key in state
            now = row is not None and self._member_in(key, others)
            if was and not now:
                out.append(key, state[key], -1)
            elif not was and now and row is not None:
                out.append(key, row, 1)
        for key, row, diff in src_batch:
            if diff < 0:
                if key in state:
                    out.append(key, state[key], -1)
            elif self._member_in(key, others):
                out.append(key, row, 1)
        return out.consolidate()


class OverrideUniverseNode(Node):
    """Pass-through after a universe promise (with_universe_of)."""

    def __init__(self, scope: "Scope", source: Node) -> None:
        super().__init__(scope, [source], source.arity)

    def process(self, time: int) -> DeltaBatch:
        return self.take(0)


class InputMirrors:
    """Input-state access for operators that peek at their inputs' state. A scope on
    one worker reads each input's complete ``current`` directly; the sharded scopes
    that need own mirrors are not ported yet."""

    def _input_state(self, port: int) -> dict:
        return self.inputs[port].current


class ZipNode(InputMirrors, Node):
    """Zip same-universe tables into one storage (column concatenation): a row is
    emitted once every input holds the key."""

    def __init__(self, scope: "Scope", sources: Sequence[Node]) -> None:
        super().__init__(scope, list(sources), sum(s.arity for s in sources))

    def _combined(self, key: Pointer) -> tuple | None:
        parts = []
        for port in range(len(self.inputs)):
            row = self._input_state(port).get(key)
            if row is None:
                return None
            parts.append(row)
        return tuple(v for part in parts for v in part)

    def process(self, time: int) -> DeltaBatch:
        affected: set[Pointer] = set()
        for port in range(len(self.inputs)):
            for key, _row, _diff in self.take(port):
                affected.add(key)
        out = DeltaBatch()
        state = self.current
        for key in affected:
            old = state.get(key)
            new = self._combined(key)
            if old is not None and rows_differ(old, new):
                out.append(key, old, -1)
            if new is not None and rows_differ(old, new):
                out.append(key, new, 1)
        return out


class JoinKind:
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    OUTER = "outer"


_JOIN_SALT = b"join"
_JOIN_LEFT_SALT = b"join-left"
_JOIN_RIGHT_SALT = b"join-right"
_JOIN_FLOAT_EXACT = 1 << 53


def join_result_key(lkey: Pointer | None, rkey: Pointer | None) -> Pointer:
    if lkey is not None and rkey is not None:
        return hash_values((lkey, rkey), salt=_JOIN_SALT)
    if lkey is not None:
        return hash_values((lkey,), salt=_JOIN_LEFT_SALT)
    assert rkey is not None
    return hash_values((rkey,), salt=_JOIN_RIGHT_SALT)


class _JoinSide:
    """One side's rows in columnar form: the join-key arrays (one per key column),
    the key bytes, and every column (object arrays where a column is not clean). The
    unified-dtype casts and the NaN screen are cached per side and key column, so
    probing a long-lived block pays them once."""

    __slots__ = ("n", "jks", "kb", "cols", "_jk_int", "_jk_f64", "_nan")

    def __init__(self, n, jks, kb, cols) -> None:
        self.n = n
        self.jks = jks
        self.kb = kb
        self.cols = cols
        self._jk_int: dict[int, np.ndarray] = {}
        self._jk_f64: dict[int, Any] = {}  # False = not representable
        self._nan: dict[int, bool] = {}

    def jk_has_nan(self, i: int = 0) -> bool:
        got = self._nan.get(i)
        if got is None:
            jk = self.jks[i]
            got = self._nan[i] = jk.dtype.kind == "f" and bool(np.isnan(jk).any())
        return got

    def jk_int(self, i: int = 0) -> np.ndarray:
        got = self._jk_int.get(i)
        if got is None:
            jk = self.jks[i]
            got = self._jk_int[i] = jk if jk.dtype == np.int64 else jk.astype(np.int64)
        return got

    def jk_f64(self, i: int = 0) -> np.ndarray | None:
        got = self._jk_f64.get(i)
        if got is None:
            jk = self.jks[i]
            if jk.dtype.kind == "i" and jk.size:
                amax = int(np.abs(jk).max())
                if amax < 0 or amax > _JOIN_FLOAT_EXACT:
                    self._jk_f64[i] = False  # would round in float64
                    return None
            cast = jk if jk.dtype == np.float64 else jk.astype(np.float64)
            got = self._jk_f64[i] = False if bool(np.isnan(cast).any()) else cast
        return None if got is False else got


def _device_ops_active():
    """The device_ops module when the device operators may engage
    (``PATHWAY_TPU_DEVICE_OPS`` is not 0), else None."""
    return _device_ops if _device_ops.enabled() else None


def _unify_join_col(a: "_JoinSide", b: "_JoinSide", i: int):
    """Key column ``i`` of two sides cast to one comparison dtype that matches Python
    dict-key equality (True == 1 == 1.0), or None when vectorized equality would
    diverge (NaN identity, huge ints in float64, str against int: the dict path)."""
    ajk, bjk = a.jks[i], b.jks[i]
    ka, kb_ = ajk.dtype.kind, bjk.dtype.kind
    if ka == kb_:
        if ka == "f" and (a.jk_has_nan(i) or b.jk_has_nan(i)):
            return None
        return ajk, bjk
    kinds = {ka, kb_}
    if kinds <= {"b", "i"}:
        return a.jk_int(i), b.jk_int(i)
    if kinds <= {"b", "i", "f"}:
        a2, b2 = a.jk_f64(i), b.jk_f64(i)
        if a2 is None or b2 is None:
            return None
        return a2, b2
    return None


def _unify_join_keys(a: "_JoinSide", b: "_JoinSide"):
    """Per-key-column unification: (left arrays, right arrays) or None."""
    left: list[np.ndarray] = []
    right: list[np.ndarray] = []
    for i in range(len(a.jks)):
        uni = _unify_join_col(a, b, i)
        if uni is None:
            return None
        left.append(uni[0])
        right.append(uni[1])
    return left, right


def _match_join_pairs(la: np.ndarray, ra: np.ndarray):
    """Index pairs (l_idx, r_idx) of all equal-key matches, a sort-based hash-join
    core; the smaller side is the sorted haystack. Pairs come out by probe index
    ascending, then build index ascending."""
    empty = np.empty(0, np.int64)
    if len(la) == 0 or len(ra) == 0:
        return empty, empty
    if len(ra) > len(la):
        r_idx, l_idx = _match_join_pairs(ra, la)
        return l_idx, r_idx
    order = np.argsort(ra, kind="stable")
    rs = ra[order]
    lo = np.searchsorted(rs, la, "left")
    hi = np.searchsorted(rs, la, "right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return empty, empty
    l_idx = np.repeat(np.arange(len(la)), counts)
    starts = np.repeat(lo, counts)
    csum = np.cumsum(counts) - counts
    offs = np.arange(total) - np.repeat(csum, counts)
    return l_idx, order[starts + offs]


def _as_match_codes(arr: np.ndarray) -> np.ndarray | None:
    """A join-key column as int64 codes whose equality is exactly the column's value
    equality, or None when no such view exists. Integers widen losslessly; uint64
    reinterprets bitwise; floats widen to float64, normalise -0.0 to +0.0 (``+ 0.0``)
    and reinterpret their bits, which is sound only without NaN."""
    k = arr.dtype.kind
    if k in "bi":
        return np.ascontiguousarray(arr, np.int64)
    if k == "u":
        if arr.dtype.itemsize == 8:
            return np.ascontiguousarray(arr).view(np.int64)
        return np.ascontiguousarray(arr, np.int64)
    if k == "f":
        f = np.ascontiguousarray(arr, np.float64) + 0.0
        if np.isnan(f).any():
            return None
        return f.view(np.int64)
    return None


def _match_join_pairs_multi(l_arrays: "list[np.ndarray]", r_arrays: "list[np.ndarray]"):
    """Multi-column matching: key tuples reduce to joint integer codes (factorized
    over both sides together, so equal tuples get equal codes), then the single-array
    matcher runs. The columns arrive dtype-unified."""
    if len(l_arrays) == 1:
        return _match_join_pairs(l_arrays[0], r_arrays[0])
    nl = len(l_arrays[0])
    both = [np.concatenate([la, ra]) for la, ra in zip(l_arrays, r_arrays)]
    _first, inverse = _device.factorize_multi(both)
    return _match_join_pairs(inverse[:nl], inverse[nl:])


def _hash_join_pairs_py(lkb: np.ndarray, rkb: np.ndarray) -> np.ndarray:
    """``join_result_key`` of each (left key, right key) pair, from their bytes."""
    n = len(lkb)
    out = np.empty((n, 16), np.uint8)
    lmem, rmem = lkb.tobytes(), rkb.tobytes()
    base = hashlib.blake2b(digest_size=16, person=b"pw-tpu-key")
    for i in range(n):
        h = base.copy()
        h.update(b"join\x04" + lmem[i * 16 : i * 16 + 16] + b"\x04" + rmem[i * 16 : i * 16 + 16])
        out[i] = np.frombuffer(h.digest(), np.uint8)
    return out


class JoinNode(Node):
    """Equality join with incremental per-group recomputation.

    Output rows are ``left_row + right_row``, with ``None`` padding on the unmatched
    side for the outer kinds; result ids derive from the source ids (``id_spec`` names
    another source). Inner joins run columnar while their inputs stay insert-only:
    the arrangements are columnar blocks, each commit is one sort-based match (on the
    card through ``device_ops.match_pairs`` where the keys have an int64 code view,
    else the host matcher) plus a lazy pair-key hash, and the output is a columnar
    batch. The first batch that needs exact row semantics (a retraction, an exotic
    key) hands the blocks to the dict arrangements once, and the incremental row path
    takes over. ``routes`` counts the matcher calls that took the card (``device``)
    and the host (``host``), and the batches of the row path (``rows``).
    """

    def __init__(
        self,
        scope: "Scope",
        left: Node,
        right: Node,
        left_on: Sequence[int],
        right_on: Sequence[int],
        kind: str = JoinKind.INNER,
        id_from_left: bool = False,
        id_spec: tuple | None = None,
    ) -> None:
        super().__init__(scope, [left, right], left.arity + right.arity)
        self.left_on = list(left_on)
        self.right_on = list(right_on)
        self.kind = kind
        #: the result id's source: None -> pair hash; ("left"/"right", None) -> that
        #: side's row key; ("left"/"right", col) -> that side's pointer column
        if id_spec is None and id_from_left:
            id_spec = ("left", None)
        self.id_spec = id_spec
        self.id_from_left = id_spec == ("left", None)
        # join key -> {row key: row}
        self.left_arr: dict[Any, dict[Pointer, tuple]] = {}
        self.right_arr: dict[Any, dict[Pointer, tuple]] = {}
        # columnar arrangements, active until a batch forces the dict path
        self._blocks_left: list[_JoinSide] = []
        self._blocks_right: list[_JoinSide] = []
        #: custom-id joins: result id -> owning join-key group, so duplicate ids are
        #: caught across groups; suppressed contenders wait in _id_waiters and are
        #: examined again when the owner releases the id
        self._id_owners: dict[Pointer, Any] = {}
        self._id_waiters: dict[Pointer, set] = {}
        self._columnar_ok = (
            kind == JoinKind.INNER
            and id_spec is None
            and len(self.left_on) >= 1
            and len(self.left_on) == len(self.right_on)
        )
        self.routes = {"device": 0, "host": 0, "rows": 0}

    def _okey(
        self,
        lk: Pointer | None,
        rk: Pointer | None,
        lrow: tuple | None,
        rrow: tuple | None,
        report: bool = True,
    ) -> Pointer | None:
        """The result row id per id_spec; an id_spec naming an absent side (outer
        padding) falls back to the pair hash. ``report=False`` on the old-state pass,
        so one bad row is reported once per batch."""
        spec = self.id_spec
        if spec is not None:
            side, col = spec
            v: Any = None
            if side == "left" and lk is not None:
                v = lk if col is None else lrow[col]
            elif side == "right" and rk is not None:
                v = rk if col is None else rrow[col]
            if isinstance(v, Pointer):
                return v
            if v is not None or (side == "left" and lk is not None) or (
                side == "right" and rk is not None
            ):
                # None or a non-pointer id value: poison, never a non-Pointer row key
                if report:
                    self.report(
                        lk if lk is not None else rk,
                        f"join id= value is not a pointer: {v!r}",
                    )
                return None  # the caller drops the row
        return join_result_key(lk, rk)

    # -- columnar path ---------------------------------------------------------

    def _side_from_batch(
        self, batch: DeltaBatch, on_cols: Sequence[int], arity: int
    ) -> _JoinSide | None:
        n = len(batch)
        if n == 0:
            return _JoinSide(0, None, None, [])
        payload = batch.columns
        if payload is not None:
            if payload.diffs is not None and not (payload.diffs == 1).all():
                return None
            jks = [payload.cols[c] for c in on_cols]
            if any(jk.dtype.kind not in "bifU" for jk in jks):
                return None
            try:
                kb = payload.kbytes()
            except (OverflowError, TypeError):
                return None
            if not batch._insert_only and not _keys_unique(kb, n):
                return None
            return _JoinSide(n, jks, kb, list(payload.cols))
        entries = batch.entries
        view = _device.ColumnarView(entries, from_entries=True)
        jks = []
        for c in on_cols:
            jk = view.column(c)
            if jk is None or jk.dtype.kind not in "bifU":
                return None
            jks.append(jk)
        if any(e[2] != 1 for e in entries):
            return None
        kb = entry_keys_bytes(entries)
        if kb is None:
            return None
        if not batch._insert_only and not _keys_unique(kb, n):
            # _raw_insert_only skipped consolidate's uniqueness scan; duplicate
            # (key, row) pairs would collapse at the dict-arrangement handover
            return None
        return _JoinSide(n, jks, kb, _device.materialize_columns(view, arity))

    def _emit_part(self, lside: _JoinSide, rside: _JoinSide, l_idx, r_idx) -> Columns:
        lkb = np.ascontiguousarray(lside.kb[l_idx])
        rkb = np.ascontiguousarray(rside.kb[r_idx])

        def pair_keys() -> np.ndarray:
            # the pair-key hash is the join's largest fixed cost: it runs only when
            # the output keys are observed (a sink, a state read, downstream keying)
            return _hash_join_pairs_py(lkb, rkb)

        cols = [c[l_idx] for c in lside.cols] + [c[r_idx] for c in rside.cols]
        return Columns(len(l_idx), cols, kb_thunk=pair_keys)

    def _process_columnar_inner(
        self, left_batch: DeltaBatch, right_batch: DeltaBatch
    ) -> DeltaBatch | None:
        """Bilinear delta join over columnar blocks: ``dL*dR + dL*R + L*dR``. None:
        the caller falls back to the dict path (the state is untouched: every screen
        runs before any block is appended)."""
        ls = self._side_from_batch(left_batch, self.left_on, self.inputs[0].arity)
        rs = self._side_from_batch(right_batch, self.right_on, self.inputs[1].arity)
        if ls is None or rs is None:
            return None
        plan: list[tuple[_JoinSide, _JoinSide]] = []
        if rs.n:
            plan.extend((blk, rs) for blk in self._blocks_left)
        if ls.n:
            plan.extend((ls, blk) for blk in self._blocks_right)
        if ls.n and rs.n:
            plan.append((ls, rs))
        unified = []
        for l, r in plan:
            uni = _unify_join_keys(l, r)
            if uni is None:
                return None
            unified.append(uni)
        _dops = _device_ops_active() if plan else None
        matches = []
        for (l, r), uni in zip(plan, unified):
            got = _dops.match_pairs(*uni) if _dops is not None else None
            if got is None:  # the operators are off, or a key has no int64 code view
                self.routes["host"] += 1
                l_idx, r_idx = _match_join_pairs_multi(*uni)
            else:
                self.routes["device"] += 1
                l_idx, r_idx = got
            if len(l_idx):
                matches.append((l, r, l_idx, r_idx))
        # every screen passed: commit the block appends, then emit
        if ls.n:
            self._blocks_left.append(ls)
        if rs.n:
            self._blocks_right.append(rs)
        parts = [self._emit_part(l, r, l_idx, r_idx) for l, r, l_idx, r_idx in matches]
        if not parts:
            return DeltaBatch()
        payload = parts[0] if len(parts) == 1 else Columns.concat(parts)
        if payload is not None:
            return DeltaBatch.from_columns(payload, consolidated=True, insert_only=True)
        # dtypes drift across parts: materialise rows
        out = DeltaBatch()
        for p in parts:
            out.entries.extend(DeltaBatch.from_columns(p, consolidated=True).entries)
        out._consolidated = True
        out._insert_only = True
        return out

    def _ensure_dict_arrangements(self) -> None:
        """Materialise the columnar blocks into the dict arrangements (once), handing
        over to the incremental row path."""
        if not self._columnar_ok:
            return
        self._columnar_ok = False
        for blocks, arr in (
            (self._blocks_left, self.left_arr),
            (self._blocks_right, self.right_arr),
        ):
            for side in blocks:
                entries = Columns(side.n, side.cols, kbytes=side.kb).to_entries()
                jk_lists = zip(*(a.tolist() for a in side.jks))
                for (key, row, _d), jkv in zip(entries, jk_lists):
                    arr.setdefault(jkv, {})[key] = row
            blocks.clear()

    # -- row path ----------------------------------------------------------------

    def _jk(self, row: tuple, cols: Sequence[int], key: Pointer) -> Any:
        vals = tuple(row[c] for c in cols)
        if any(is_error(v) for v in vals):
            self.report(key, "error value in join key")
            return ERROR
        try:
            hash(vals)
        except TypeError:
            vals = tuple(repr(v) for v in vals)
        return vals

    def _local_output(self, jk: Any, report: bool = True) -> dict[Pointer, tuple]:
        lrows = self.left_arr.get(jk, {})
        rrows = self.right_arr.get(jk, {})
        out: dict[Pointer, tuple] = {}
        l_pad = (None,) * self.inputs[0].arity
        r_pad = (None,) * self.inputs[1].arity
        custom = self.id_spec is not None

        def put(okey: Pointer | None, row: tuple) -> None:
            if okey is None:
                return  # a poisoned id value, reported in _okey
            if custom:
                owner = self._id_owners.get(okey, jk)
                if okey in out or owner != jk:
                    # a duplicate result id poisons through the error log, within and
                    # across join-key groups; the first row wins
                    if report:
                        self.report(okey, "duplicate join result id")
                        if owner != jk:
                            # remember the contender: if the owner releases the id,
                            # this group emits again
                            self._id_waiters.setdefault(okey, set()).add(jk)
                    return
            out[okey] = row

        if lrows and rrows:
            for lk, lrow in lrows.items():
                for rk, rrow in rrows.items():
                    put(self._okey(lk, rk, lrow, rrow, report), lrow + rrow)
        if self.kind in (JoinKind.LEFT, JoinKind.OUTER) or (
            self.id_from_left and self.kind != JoinKind.INNER
        ):
            if not rrows:
                for lk, lrow in lrows.items():
                    put(self._okey(lk, None, lrow, None, report), lrow + r_pad)
        if self.kind in (JoinKind.RIGHT, JoinKind.OUTER) and not self.id_from_left:
            if not lrows:
                for rk, rrow in rrows.items():
                    put(self._okey(None, rk, None, rrow, report), l_pad + rrow)
        return out

    def _process_insert_only_inner(
        self, left_batch: DeltaBatch, right_batch: DeltaBatch
    ) -> DeltaBatch | None:
        """Incremental inner join of insert-only deltas, ``dL*R + L*(R+dR)``: no
        per-group recompute, no old/new diffing, no consolidation (result keys are
        unique pair hashes). None (state untouched) for multiplicities above 1."""
        if any(e[2] != 1 for e in left_batch.entries) or any(
            e[2] != 1 for e in right_batch.entries
        ):
            return None
        out = DeltaBatch()
        append = out.entries.append
        # dR pairs with the left arrangement before the delta...
        for rkey, rrow, _diff in right_batch:
            jk = self._jk(rrow, self.right_on, rkey)
            if jk is ERROR:
                continue
            lrows = self.left_arr.get(jk)
            if lrows:
                for lk, lrow in lrows.items():
                    append((join_result_key(lk, rkey), lrow + rrow, 1))
            self.right_arr.setdefault(jk, {})[rkey] = rrow
        # ...then dL with the right arrangement after it, so dL*dR pairs appear once
        for lkey, lrow, _diff in left_batch:
            jk = self._jk(lrow, self.left_on, lkey)
            if jk is ERROR:
                continue
            rrows = self.right_arr.get(jk)
            if rrows:
                for rk, rrow in rrows.items():
                    append((join_result_key(lkey, rk), lrow + rrow, 1))
            self.left_arr.setdefault(jk, {})[lkey] = lrow
        out._consolidated = True
        out._insert_only = True
        return out

    def process(self, time: int) -> DeltaBatch:
        # raw takes: the columnar path is multiset-correct, so consolidation is
        # skipped while it holds
        left_batch = self.take_raw(0)
        right_batch = self.take_raw(1)
        if self._columnar_ok:

            def insertish(b: DeltaBatch) -> bool:
                return b._raw_insert_only or b._insert_only or not b

            if not (insertish(left_batch) and insertish(right_batch)):
                # no hint is not the same as retractions: consolidation may prove the
                # batch insert-only and keep the columnar join
                left_batch = left_batch.consolidate()
                right_batch = right_batch.consolidate()
            if insertish(left_batch) and insertish(right_batch):
                out = self._process_columnar_inner(left_batch, right_batch)
                if out is not None:
                    return out
            # this batch needs exact row semantics: hand the blocks to the dict
            # arrangements (once) and fall through
            self._ensure_dict_arrangements()
        self.routes["rows"] += 1
        left_batch = left_batch.consolidate()
        right_batch = right_batch.consolidate()
        fast = (
            self.kind == JoinKind.INNER
            and self.id_spec is None
            and (left_batch._insert_only or not left_batch)
            and (right_batch._insert_only or not right_batch)
        )
        if fast:
            out = self._process_insert_only_inner(left_batch, right_batch)
            if out is not None:
                return out
        affected: set[Any] = set()
        old_local: dict[Any, dict[Pointer, tuple]] = {}

        def note(jk: Any) -> None:
            if jk is not ERROR and jk not in old_local:
                # the old-state pass reports nothing (the new-state pass reports
                # each problem once per batch)
                old_local[jk] = self._local_output(jk, report=False)
                affected.add(jk)

        staged: list[tuple[int, Any, Pointer, tuple, int]] = []
        for key, row, diff in left_batch:
            jk = self._jk(row, self.left_on, key)
            note(jk)
            staged.append((0, jk, key, row, diff))
        for key, row, diff in right_batch:
            jk = self._jk(row, self.right_on, key)
            note(jk)
            staged.append((1, jk, key, row, diff))

        for side, jk, key, row, diff in staged:
            if jk is ERROR:
                continue
            arr = self.left_arr if side == 0 else self.right_arr
            group = arr.setdefault(jk, {})
            if diff > 0:
                group[key] = row
            else:
                group.pop(key, None)
                if not group:
                    arr.pop(jk, None)

        out = DeltaBatch()
        freed: list[Pointer] = []
        # custom-id joins visit groups in a fixed order: with duplicate result ids
        # the winner is the first group processed, and set order follows the
        # per-process string hash
        if self.id_spec is not None:
            affected = sorted(affected, key=repr)
        for jk in affected:
            old = old_local[jk]
            new = self._local_output(jk)
            if self.id_spec is not None:
                for okey in old:
                    if okey not in new and self._id_owners.get(okey) == jk:
                        del self._id_owners[okey]
                        if okey in self._id_waiters:
                            freed.append(okey)
                for okey in new:
                    self._id_owners[okey] = jk
            for okey, orow in old.items():
                if okey not in new or rows_differ(new[okey], orow):
                    out.append(okey, orow, -1)
            for okey, orow in new.items():
                if okey not in old or rows_differ(old[okey], orow):
                    out.append(okey, orow, 1)
        # a released custom id goes to a suppressed contender, whose row would
        # otherwise stay missing until an unrelated update touched its group
        for okey in freed:
            if self._id_owners.get(okey) is not None:
                continue  # claimed again within this batch
            for jk in sorted(self._id_waiters.pop(okey, ()), key=repr):
                if jk in affected:
                    continue  # its recompute already saw the free id
                row = self._local_output(jk, report=False).get(okey)
                if row is not None:
                    self._id_owners[okey] = jk
                    out.append(okey, row, 1)
                    break
        return out.consolidate()


def _groupby_batch_arrays(
    batch: DeltaBatch, by_cols: Sequence[int], sum_cols: Sequence[int]
):
    """``(by arrays, diffs, sum value arrays)`` for a vectorized groupby pass, or None
    when the batch is not cleanly columnar: mixed or object dtypes, NaN group values
    (``np.unique`` collapses NaNs where the row path groups them by bits), non-numeric
    sum columns. Shared by the columnar state and the degraded vectorized path, so
    their screens cannot diverge."""
    cols = batch.columns
    if cols is not None:
        bys = [cols.cols[c] for c in by_cols]
        if any(by.dtype.kind not in "bifU" for by in bys):
            return None
        diffs = cols.diffs
        getcol = lambda c: cols.cols[c]  # noqa: E731
    else:
        entries = batch.entries
        view = _device.ColumnarView(entries, from_entries=True)
        bys = []
        for c in by_cols:
            by = view.column(c)
            if by is None or by.dtype.kind not in "bifU":
                return None
            bys.append(by)
        diffs = np.fromiter((d for _k, _r, d in entries), np.int64, len(entries))
        getcol = view.column
    if any(by.dtype.kind == "f" and np.isnan(by).any() for by in bys):
        return None
    vals = []
    for c in sum_cols:
        if c < 0:
            vals.append(None)
            continue
        col = getcol(c)
        if col is None or col.dtype.kind not in "bif":
            return None
        vals.append(col)
    if diffs is None:
        diffs = np.ones(len(bys[0]), np.int64)
    return bys, diffs, vals


def _factorize_bys(bys: "list[np.ndarray]"):
    """``(raw tuples, inverse)`` of the distinct by-value tuples in a batch."""
    if len(bys) == 1:
        uniq, inverse = _device.factorize(bys[0])
        return [(v,) for v in uniq], inverse.reshape(-1)
    first, inverse = _device.factorize_multi(bys)
    return list(zip(*(by[first].tolist() for by in bys))), inverse


class _ColumnarGroups:
    """Columnar group state for count and sum groupbys over clean by columns.

    Flat arrays replace the per-group Python objects: ``member`` (signed
    multiplicity) and one accumulator per sum reducer, indexed by a dense group id. A
    commit costs one factorization, the segment reductions (on the card through
    ``device_ops.segment_reduce_dispatch``, else the host kernels) and array math over
    the touched groups. A batch the arrays cannot represent exactly (mixed or object
    dtypes, NaN group values, ERROR cells, int64 overflow risk) makes the owner degrade
    to the dict-of-states row path before any mutation, via :meth:`materialize`.
    """

    __slots__ = (
        "by_cols", "_single", "gkey_salt", "kinds", "sum_cols", "index", "by_raw",
        "gkeys", "member", "accs", "size",
    )

    _CAP0 = 1024

    def __init__(
        self,
        by_cols: Sequence[int],
        reducers: Sequence[tuple[Reducer, Sequence[int]]],
        gkey_salt: bytes = b"",
    ) -> None:
        self.by_cols = list(by_cols)
        self.gkey_salt = gkey_salt
        # single-by state keeps bare scalars in index and by_raw (tuple wrapping and
        # hashing per touched group drags the incremental path); multi-by keeps tuples
        self._single = len(self.by_cols) == 1
        self.kinds = [r.kind for r, _c in reducers]
        self.sum_cols = [cols[0] if r.kind == ReducerKind.SUM else -1 for r, cols in reducers]
        self.index: dict[Any, int] = {}  # normalised by-value(s) -> group id
        self.by_raw: list[Any] = []  # first-seen raw by-value(s) per group
        self.gkeys: list[Pointer] = []
        self.member = np.zeros(self._CAP0, np.int64)
        self.accs: list[np.ndarray | None] = [
            np.zeros(self._CAP0, np.int64) if c >= 0 else None for c in self.sum_cols
        ]
        self.size = 0

    @staticmethod
    def _norm_one(v: Any) -> Any:
        """Group identity as ``hash_values`` sees it: bools apart from ints,
        int-valued floats onto ints."""
        if isinstance(v, bool):
            return ("\x01b", v)
        if isinstance(v, float) and -(2**63) < v < 2**63 and v == int(v):
            return int(v)
        return v

    def _norm(self, raw: Any) -> Any:
        if self._single:
            return self._norm_one(raw)
        return tuple(map(self._norm_one, raw))

    def _grow(self, need: int) -> None:
        cap = len(self.member)
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        member = np.zeros(cap, np.int64)
        member[: self.size] = self.member[: self.size]
        self.member = member
        for i, acc in enumerate(self.accs):
            if acc is not None:
                grown = np.zeros(cap, acc.dtype)
                grown[: self.size] = acc[: self.size]
                self.accs[i] = grown

    def process_batch(self, batch: DeltaBatch, node: "GroupbyNode"):
        """Apply one delta batch: the output batch, or None to degrade (state
        untouched)."""
        got = _groupby_batch_arrays(batch, self.by_cols, self.sum_cols)
        if got is None:
            return None
        bys, diffs, vals = got
        n = len(bys[0])
        if n == 0:
            return DeltaBatch()
        dmax = int(np.abs(diffs).max())
        if dmax < 0:  # abs(INT64_MIN) wraps
            return None
        for col in vals:
            if col is not None and _device.int_sum_overflow_risk(col, n, dmax):
                return None
        if self._single:
            raws, inverse = _device.factorize(bys[0])
            inverse = inverse.reshape(-1)
        else:
            raws, inverse = _factorize_bys(bys)
        nu = len(raws)
        # on the card: the reductions are enqueued now and fetched after the group-id
        # resolution below, so the kernels run while the host walks the dict
        job = None
        deltas: list[np.ndarray | None] = []
        _dops = _device_ops_active()
        if _dops is not None:
            job = _dops.segment_reduce_dispatch(inverse, diffs, vals, nu)
            node.routes["device"] += 1
        else:
            node.routes["host"] += 1
            gdiffs = _device.segment_count(inverse, diffs, nu)
            for col in vals:
                deltas.append(
                    None if col is None else _device.segment_sum(inverse, col, diffs, nu)
                )
        # resolve group ids (creating new groups), all before mutation
        index = self.index
        gis = np.empty(nu, np.int64)
        created: list[int] = []
        for i, raw in enumerate(raws):
            k = self._norm(raw)
            gi = index.get(k)
            if gi is None:
                gi = self.size
                self._grow(gi + 1)
                index[k] = gi
                self.by_raw.append(raw)
                # group id = ref_scalar(*by values), addressable from pointer_from
                self.gkeys.append(
                    hash_values((raw,) if self._single else raw, salt=self.gkey_salt)
                )
                self.size = gi + 1
                created.append(i)
            gis[i] = gi
        if job is not None:
            gdiffs, deltas = job.fetch()
        # int64 accumulator headroom: degrade before any mutation
        for ri, delta in enumerate(deltas):
            if delta is None:
                continue
            acc = self.accs[ri]
            if acc.dtype.kind == "i" and delta.dtype.kind != "f":
                amax_acc = int(np.abs(acc[gis]).max(initial=0))
                amax_d = int(np.abs(delta).max(initial=0))
                if amax_acc < 0 or amax_acc + amax_d > (1 << 62):
                    for i in created:  # roll back the group creation
                        del index[self._norm(raws[i])]
                    del self.by_raw[self.size - len(created) :]
                    del self.gkeys[self.size - len(created) :]
                    self.size -= len(created)
                    return None
        for ri, delta in enumerate(deltas):
            if delta is not None and delta.dtype.kind == "f" and self.accs[ri].dtype.kind == "i":
                # float contributions arrive: upcast, like Python's int + float
                self.accs[ri] = self.accs[ri].astype(np.float64)
        old_member = self.member[gis].copy()
        old_accs = [
            self.accs[ri][gis].copy() if d is not None else None for ri, d in enumerate(deltas)
        ]
        self.member[gis] = old_member + gdiffs
        for ri, delta in enumerate(deltas):
            if delta is None:
                continue
            acc = self.accs[ri]
            acc[gis] = acc[gis] + delta.astype(acc.dtype, copy=False)
        new_member = self.member[gis]
        for i in np.flatnonzero(new_member <= 0).tolist():
            index.pop(self._norm(raws[i]), None)
        # a group emits only when its visible row changes (the row path's old_row !=
        # new_row guard): membership flips always count; count columns change with
        # member, sum columns with the stored accumulator (after rounding: a float
        # delta swallowed by rounding emits nothing)
        changed = (old_member > 0) != (new_member > 0)
        for ri, kind in enumerate(self.kinds):
            if kind == ReducerKind.COUNT:
                changed |= old_member != new_member
            else:
                changed |= old_accs[ri] != self.accs[ri][gis]
        m_old = (old_member > 0) & changed
        m_new = (new_member > 0) & changed
        if not m_old.any() and not m_new.any():
            self._maybe_compact()
            return DeltaBatch()
        gkeys = self.gkeys
        by_raw = self.by_raw
        n_by = len(self.by_cols)
        single = self._single

        def block(mask, member_vals, acc_vals):
            sel = np.flatnonzero(mask)
            sel_g = gis[sel].tolist()
            kobjs = list(map(gkeys.__getitem__, sel_g))
            by_vals = list(map(by_raw.__getitem__, sel_g))
            # dense by-value columns where the values are cleanly typed, so columnar
            # consumers downstream stay columnar; others keep exact objects
            cols = []
            for j in range(n_by):
                col_vals = by_vals if single else [t[j] for t in by_vals]
                byv = _device._extract(col_vals)
                if byv is None:
                    byv = np.empty(len(col_vals), object)
                    byv[:] = col_vals
                cols.append(byv)
            for ri, kind in enumerate(self.kinds):
                cols.append(member_vals[sel] if kind == ReducerKind.COUNT else acc_vals[ri][sel])
            return kobjs, cols

        ko_old, cols_old = block(m_old, old_member, old_accs)
        new_accs = [self.accs[ri][gis] if d is not None else None for ri, d in enumerate(deltas)]
        ko_new, cols_new = block(m_new, new_member, new_accs)
        kobjs = ko_old + ko_new

        def cat(a, b):
            # an empty side must not promote the other's dtype, and mismatched dense
            # dtypes (int by-values in one commit, str in the next) must not promote
            # values: exact objects instead
            if len(a) == 0:
                return b
            if len(b) == 0:
                return a
            if a.dtype == b.dtype:
                return np.concatenate([a, b])
            arr = np.empty(len(a) + len(b), object)
            arr[: len(a)] = a.tolist()
            arr[len(a) :] = b.tolist()
            return arr

        out_cols = [cat(a, b) for a, b in zip(cols_old, cols_new)]
        if ko_old:
            out_diffs = np.concatenate(
                [np.full(len(ko_old), -1, np.int64), np.ones(len(ko_new), np.int64)]
            )
        else:
            # a pure-insert commit (bulk load, fresh groups): diffs=None marks the
            # batch insert-only, so the hash join downstream takes it unconsolidated
            out_diffs = None
        payload = Columns(len(kobjs), out_cols, kobjs=kobjs, diffs=out_diffs)
        self._maybe_compact()
        return DeltaBatch.from_columns(
            payload, consolidated=True, insert_only=out_diffs is None
        )

    def _maybe_compact(self) -> None:
        """Reclaim the array slots of dead groups; group-key churn otherwise grows the
        state without bound."""
        live = len(self.index)
        if self.size <= 4096 or self.size <= 2 * live:
            return
        order = sorted(self.index.items(), key=lambda kv: kv[1])
        old_gis = np.fromiter((gi for _k, gi in order), np.int64, live)
        self.by_raw = [self.by_raw[gi] for gi in old_gis]
        self.gkeys = [self.gkeys[gi] for gi in old_gis]
        member = np.zeros(max(self._CAP0, len(self.member) // 2), np.int64)
        while len(member) < live:
            member = np.zeros(len(member) * 2, np.int64)
        member[:live] = self.member[old_gis]
        self.member = member
        for ri, acc in enumerate(self.accs):
            if acc is None:
                continue
            grown = np.zeros(len(member), acc.dtype)
            grown[:live] = acc[old_gis]
            self.accs[ri] = grown
        self.index = {k: i for i, (k, _gi) in enumerate(order)}
        self.size = live

    def materialize(self, node: "GroupbyNode") -> dict[Pointer, list[Any]]:
        """The row path's dict-of-states form (degradation)."""
        groups: dict[Pointer, list[Any]] = {}
        for _k, gi in self.index.items():
            raw = self.by_raw[gi]
            by_vals = (raw,) if self._single else raw
            states = []
            for ri, (reducer, _cols) in enumerate(node.reducers):
                state = reducer.make_state()
                state.count = int(self.member[gi])
                if reducer.kind == ReducerKind.SUM:
                    acc = self.accs[ri][gi]
                    state.acc = int(acc) if acc.dtype.kind == "i" else float(acc)
                states.append(state)
            gkey = self.gkeys[gi]
            groups[gkey] = [by_vals, states, int(self.member[gi])]
            node._gkey_cache[(tuple(map(type, by_vals)), by_vals)] = gkey
        return groups


class GroupbyNode(Node):
    """Group-by with engine reducers.

    Output rows: the grouping values, then one value per reducer; the group id is
    ``ref_scalar(*grouping values)`` unless ``set_id`` names a pointer column to use
    directly. Count and sum groupbys keep their state in :class:`_ColumnarGroups`
    arrays until a batch needs exact row-wise semantics; then the state degrades
    (once) to the dict-of-states form. ``routes`` counts the batches whose reductions
    ran on the card (``device``) or in the host kernels (``host``), and the batches of
    the row path (``rows``).
    """

    def __init__(
        self,
        scope: "Scope",
        source: Node,
        by_cols: Sequence[int],
        reducers: Sequence[tuple[Reducer, Sequence[int]]],
        set_id: bool = False,
        instance_last: bool = False,
    ) -> None:
        super().__init__(scope, [source], len(by_cols) + len(reducers))
        self.by_cols = list(by_cols)
        self.reducers = list(reducers)
        self.set_id = set_id
        # instance groupbys derive ids as ref_scalar(*vals, instance=i) does, so
        # pointer_from with instance= addresses the groups
        self._gkey_salt = b"inst" if instance_last else b""
        # gkey -> [by_vals, [reducer states], membership count]
        self._groups: dict[Pointer, list[Any]] = {}
        self._cg: _ColumnarGroups | None = None
        if (
            not set_id
            and len(by_cols) >= 1
            and all(r.kind in (ReducerKind.COUNT, ReducerKind.SUM) for r, _c in reducers)
        ):
            self._cg = _ColumnarGroups(by_cols, reducers, gkey_salt=self._gkey_salt)
        # (types, by_vals) -> gkey: a stream touches the same groups commit after
        # commit, and the key derivation is a hash; the types are part of the cache
        # key because dict equality is coarser than the digest (True == 1)
        self._gkey_cache: dict[tuple, Pointer] = {}
        self.routes = {"device": 0, "host": 0, "rows": 0}

    @property
    def groups(self) -> dict[Pointer, list[Any]]:
        if self._cg is not None:
            self._groups = self._cg.materialize(self)
            self._cg = None
        return self._groups

    def _group_key(self, by_vals: tuple) -> Pointer:
        if self.set_id:
            assert len(by_vals) == 1 and isinstance(by_vals[0], Pointer)
            return by_vals[0]
        ck = (tuple(map(type, by_vals)), by_vals)
        try:
            gkey = self._gkey_cache.get(ck)
        except TypeError:  # unhashable by-values: derive directly
            return hash_values(by_vals, salt=self._gkey_salt)
        if gkey is None:
            gkey = hash_values(by_vals, salt=self._gkey_salt)
            self._gkey_cache[ck] = gkey
        return gkey

    def _group_row(self, entry: list[Any]) -> tuple:
        by_vals, states, _count = entry
        vals = [reducer.compute(state) for (reducer, _cols), state in zip(self.reducers, states)]
        return tuple(by_vals) + tuple(vals)

    def _process_columnar(self, batch: DeltaBatch) -> DeltaBatch | None:
        """Vectorized path of the degraded state for count and sum groupbys over clean
        by columns: factorization and the host segment reductions, leaving per-group
        Python only. None whenever the semantics would differ from the row loop."""
        if self.set_id or len(self.by_cols) < 1:
            return None
        if any(r.kind not in (ReducerKind.COUNT, ReducerKind.SUM) for r, _c in self.reducers):
            return None
        sum_col_idx = [cols[0] if r.kind == ReducerKind.SUM else -1 for r, cols in self.reducers]
        got = _groupby_batch_arrays(batch, self.by_cols, sum_col_idx)
        if got is None:
            return None
        bys, diffs, vals = got
        n = len(bys[0])
        dmax = int(np.abs(diffs).max()) if n else 0
        if dmax < 0:  # abs(INT64_MIN) wraps
            return None
        for col in vals:
            if col is not None and _device.int_sum_overflow_risk(col, n, dmax):
                return None
        uniques, inverse = _factorize_bys(bys)
        n_groups = len(uniques)
        self.routes["host"] += 1
        gdiffs = _device.segment_count(inverse, diffs, n_groups)
        aggs = [
            None if col is None else _device.segment_sum(inverse, col, diffs, n_groups)
            for col in vals
        ]
        out = DeltaBatch()
        for gi, by_vals in enumerate(uniques):
            gkey = self._group_key(by_vals)
            entry = self.groups.get(gkey)
            old_row = self._group_row(entry) if entry is not None else None
            if entry is None:
                entry = [by_vals, [reducer.make_state() for reducer, _c in self.reducers], 0]
                self.groups[gkey] = entry
            gdiff = int(gdiffs[gi])
            entry[2] += gdiff
            for ri, ((reducer, _cols), state) in enumerate(zip(self.reducers, entry[1])):
                state.count += gdiff
                if reducer.kind == ReducerKind.SUM:
                    delta = aggs[ri][gi].item()
                    state.acc = delta if state.acc is None else state.acc + delta
            new_row: tuple | None = None
            if entry[2] <= 0:
                del self.groups[gkey]
                self._gkey_cache.pop((tuple(map(type, by_vals)), by_vals), None)
            else:
                new_row = self._group_row(entry)
            if old_row is not None and old_row != new_row:
                out.append(gkey, old_row, -1)
            if new_row is not None and old_row != new_row:
                out.append(gkey, new_row, 1)
        return out.consolidate()

    def process(self, time: int) -> DeltaBatch:
        if self._cg is not None:
            # segment sums are diff-linear: duplicate and net-zero entries contribute
            # exactly their diff, so consolidation is skipped
            batch = self.take_raw(0)
            out = self._cg.process_batch(batch, self)
            if out is not None:
                return out
            # this batch needs exact row semantics: degrade the columnar state (once)
            # and fall through
            self.groups  # noqa: B018 — the property materialises and clears _cg
            batch = batch.consolidate()
        else:
            batch = self.take(0)
        if len(batch) >= VECTOR_THRESHOLD:
            fast = self._process_columnar(batch)
            if fast is not None:
                return fast
        self.routes["rows"] += 1
        touched: dict[Pointer, tuple | None] = {}
        for key, row, diff in batch:
            by_vals = tuple(row[c] for c in self.by_cols)
            if any(is_error(v) for v in by_vals):
                self.report(key, "error value in groupby key")
                continue
            gkey = self._group_key(by_vals)
            entry = self.groups.get(gkey)
            if gkey not in touched:
                touched[gkey] = self._group_row(entry) if entry is not None else None
            if entry is None:
                entry = [by_vals, [reducer.make_state() for reducer, _c in self.reducers], 0]
                self.groups[gkey] = entry
            entry[2] += diff
            for (reducer, cols), state in zip(self.reducers, entry[1]):
                reducer.update(state, tuple(row[c] for c in cols), diff, time)
        out = DeltaBatch()
        for gkey, old_row in touched.items():
            entry = self.groups.get(gkey)
            new_row: tuple | None = None
            if entry is not None:
                if entry[2] <= 0:
                    del self.groups[gkey]
                    bv = tuple(entry[0])
                    self._gkey_cache.pop((tuple(map(type, bv)), bv), None)
                else:
                    new_row = self._group_row(entry)
            if old_row is not None and old_row != new_row:
                out.append(gkey, old_row, -1)
            if new_row is not None and old_row != new_row:
                out.append(gkey, new_row, 1)
        return out.consolidate()


class DeduplicateNode(Node):
    """Keeps one accepted row per instance: ``acceptor(new_value, old_value) -> bool``
    decides whether a newly arriving row replaces the current one. The output is keyed
    by the instance (``hash_values(instance, salt=b"dedup")``); an error value or a
    raising acceptor is reported and the row skipped; a retraction removes the
    instance's row only if it is that row."""

    def __init__(
        self,
        scope: "Scope",
        source: Node,
        value_col: int,
        instance_cols: Sequence[int],
        acceptor: Callable[[Any, Any], bool],
    ) -> None:
        super().__init__(scope, [source], source.arity)
        self.value_col = value_col
        self.instance_cols = list(instance_cols)
        self.acceptor = acceptor
        self.accepted: dict[Pointer, tuple] = {}  # instance key -> row

    def process(self, time: int) -> DeltaBatch:
        batch = self.take(0)
        out = DeltaBatch()
        for key, row, diff in batch:
            inst = tuple(row[c] for c in self.instance_cols)
            gkey = hash_values(inst, salt=b"dedup")
            prev = self.accepted.get(gkey)
            if diff > 0:
                new_val = row[self.value_col]
                if is_error(new_val):
                    self.report(key, "error value in deduplicate")
                    continue
                if prev is None:
                    accept = True
                else:
                    try:
                        accept = bool(self.acceptor(new_val, prev[self.value_col]))
                    except Exception as e:  # noqa: BLE001
                        self.report(key, f"error in deduplicate acceptor: {e}")
                        continue
                if accept:
                    if prev is not None:
                        out.append(gkey, prev, -1)
                    self.accepted[gkey] = row
                    out.append(gkey, row, 1)
            elif prev is not None and not rows_differ(prev, row):
                out.append(gkey, prev, -1)
                del self.accepted[gkey]
        return out.consolidate()


class FlattenNode(Node):
    """Explode a sequence column into one row per element; with ``with_origin`` the
    source row id is appended as a last column."""

    def __init__(
        self, scope: "Scope", source: Node, flat_col: int, with_origin: bool = False
    ) -> None:
        super().__init__(scope, [source], source.arity + (1 if with_origin else 0))
        self.flat_col = flat_col
        self.with_origin = with_origin

    def _explode(self, key: Pointer, row: tuple) -> list[tuple[Pointer, tuple]]:
        value = row[self.flat_col]
        if is_error(value):
            self.report(key, "error value in flatten column")
            return []
        if value is None:
            return []
        try:
            elements = list(value)
        except TypeError:
            self.report(key, f"cannot flatten non-sequence {value!r}")
            return []
        out = []
        for i, element in enumerate(elements):
            new_key = hash_values((key, i), salt=b"flatten")
            new_row = row[: self.flat_col] + (element,) + row[self.flat_col + 1 :]
            if self.with_origin:
                new_row = new_row + (key,)
            out.append((new_key, new_row))
        return out

    def process(self, time: int) -> DeltaBatch:
        batch = self.take(0)
        out = DeltaBatch()
        for key, row, diff in batch:
            for new_key, new_row in self._explode(key, row):
                out.append(new_key, new_row, diff)
        return out.consolidate()


class SortNode(Node):
    """Keeps prev/next pointers per instance, in the order of a key column: ``None``
    first, then the natural order, ties by row id; a mix of values that cannot be
    compared orders by type name and ``repr``. Output row ``(prev, next)`` keyed by the
    source row id. Each commit recomputes the order of every instance it touches."""

    def __init__(
        self, scope: "Scope", source: Node, key_col: int, instance_col: int | None
    ) -> None:
        super().__init__(scope, [source], 2)
        self.key_col = key_col
        self.instance_col = instance_col
        self.members: dict[Any, dict[Pointer, Any]] = {}  # instance -> {key: sort value}

    def _instance(self, row: tuple) -> Any:
        if self.instance_col is None:
            return None
        v = row[self.instance_col]
        try:
            hash(v)
        except TypeError:
            v = repr(v)
        return v

    def _ordered(self, inst: Any) -> list[Pointer]:
        items = list(self.members.get(inst, {}).items())
        try:
            items.sort(key=lambda kv: (True, kv[1], int(kv[0]))
                       if kv[1] is not None else (False, 0, int(kv[0])))
        except TypeError:
            items.sort(
                key=lambda kv: (kv[1] is not None, type(kv[1]).__name__, repr(kv[1]), int(kv[0]))
            )
        return [k for k, _v in items]

    def _local(self, inst: Any) -> dict[Pointer, tuple]:
        ordered = self._ordered(inst)
        last = len(ordered) - 1
        return {
            k: (ordered[i - 1] if i > 0 else None, ordered[i + 1] if i < last else None)
            for i, k in enumerate(ordered)
        }

    def process(self, time: int) -> DeltaBatch:
        batch = self.take(0)
        old: dict[Any, dict[Pointer, tuple]] = {}
        for key, row, diff in batch:
            inst = self._instance(row)
            if inst not in old:
                old[inst] = self._local(inst)
        for key, row, diff in batch:
            inst = self._instance(row)
            group = self.members.setdefault(inst, {})
            if diff > 0:
                group[key] = row[self.key_col]
            else:
                group.pop(key, None)
                if not group:
                    self.members.pop(inst, None)
        out = DeltaBatch()
        emit_local_group_diffs(out, old, self._local)
        return out.consolidate()


class IxNode(InputMirrors, Node):
    """Pointer-lookup join: for each input row, the source row its key column points
    to (ix)."""

    def __init__(
        self,
        scope: "Scope",
        keys_table: Node,
        source_table: Node,
        key_col: int,
        optional: bool = False,
        strict: bool = True,
    ) -> None:
        super().__init__(scope, [keys_table, source_table], source_table.arity)
        self.key_col = key_col
        self.optional = optional
        self.strict = strict
        self.forward: dict[Pointer, Pointer] = {}  # input key -> source key
        self.reverse: dict[Pointer, set[Pointer]] = {}  # source key -> input keys

    def _lookup(self, key: Pointer, skey: Pointer | None) -> tuple | None:
        if skey is None:
            if self.optional:
                return (None,) * self.arity
            self.report(key, "ix: key is None and optional=False")
            return None
        src = self._input_state(1).get(skey)
        if src is None:
            if self.strict:
                self.report(key, f"ix: missing key {skey!r}")
                return None
            return (None,) * self.arity
        return src

    def process(self, time: int) -> DeltaBatch:
        keys_batch = self.take(0)
        source_batch = self.take(1)
        out = DeltaBatch()
        # source-side changes: emit again the rows of the affected input keys
        affected_src: set[Pointer] = {key for key, _r, _d in source_batch}
        handled: set[Pointer] = {key for key, _r, _d in keys_batch}
        state = self.current
        for skey in affected_src:
            for ikey in self.reverse.get(skey, set()) - handled:
                old = state.get(ikey)
                new = self._lookup(ikey, self.forward.get(ikey))
                if old is not None and rows_differ(old, new):
                    out.append(ikey, old, -1)
                if new is not None and rows_differ(old, new):
                    out.append(ikey, new, 1)
        # input-side changes
        for key, row, diff in keys_batch:
            if diff < 0:
                if key in state:
                    out.append(key, state[key], -1)
                skey = self.forward.pop(key, None)
                if skey is not None:
                    self.reverse.get(skey, set()).discard(key)
                continue
            skey = row[self.key_col]
            if is_error(skey):
                self.report(key, "error value in ix key")
                continue
            if skey is not None and not isinstance(skey, Pointer):
                self.report(key, f"ix key must be a pointer, got {skey!r}")
                continue
            if key in state:
                out.append(key, state[key], -1)
            if skey is not None:
                self.forward[key] = skey
                self.reverse.setdefault(skey, set()).add(key)
            new = self._lookup(key, skey)
            if new is not None:
                out.append(key, new, 1)
        return out.consolidate()


class _KeyedMerge(InputMirrors, Node):
    """Two same-arity inputs merged per key; subclasses give the merged row."""

    def _effective(self, key: Pointer) -> tuple | None:
        raise NotImplementedError

    def process(self, time: int) -> DeltaBatch:
        affected: set[Pointer] = set()
        for port in (0, 1):
            for key, _row, _diff in self.take(port):
                affected.add(key)
        out = DeltaBatch()
        state = self.current
        for key in affected:
            old = state.get(key)
            new = self._effective(key)
            if old is not None and rows_differ(old, new):
                out.append(key, old, -1)
            if new is not None and rows_differ(old, new):
                out.append(key, new, 1)
        return out


class UpdateRowsNode(_KeyedMerge):
    """``orig.update_rows(updates)``: the update wins per key; the universes unite."""

    def __init__(self, scope: "Scope", orig: Node, updates: Node) -> None:
        assert orig.arity == updates.arity
        super().__init__(scope, [orig, updates], orig.arity)

    def _effective(self, key: Pointer) -> tuple | None:
        upd = self._input_state(1).get(key)
        if upd is not None:
            return upd
        return self._input_state(0).get(key)


class UpdateCellsNode(_KeyedMerge):
    """``orig.update_cells(updates)``: override some columns per key.
    ``update_cols[i]`` is, for output column ``i``, its column in the updates table,
    or -1 to keep the original value."""

    def __init__(
        self, scope: "Scope", orig: Node, updates: Node, update_cols: Sequence[int]
    ) -> None:
        super().__init__(scope, [orig, updates], orig.arity)
        self.update_cols = list(update_cols)

    def _effective(self, key: Pointer) -> tuple | None:
        orig = self._input_state(0).get(key)
        if orig is None:
            return None
        upd = self._input_state(1).get(key)
        if upd is None:
            return orig
        return tuple(upd[uc] if uc >= 0 else orig[i] for i, uc in enumerate(self.update_cols))


class SubscribeNode(Node):
    """Sink: per-row callbacks and time/end notifications (subscribe_table)."""

    def __init__(
        self,
        scope: "Scope",
        source: Node,
        on_change: Callable[[Pointer, tuple, int, int], None] | None = None,
        on_time_end: Callable[[int], None] | None = None,
        on_end: Callable[[], None] | None = None,
        skip_errors: bool = True,
    ) -> None:
        super().__init__(scope, [source], source.arity)
        self._on_change = on_change
        self._on_time_end = on_time_end
        self._on_end = on_end
        self.skip_errors = skip_errors

    def process(self, time: int) -> DeltaBatch:
        batch = self.take(0)
        for key, row, diff in batch:
            if self.skip_errors and any(is_error(v) for v in row):
                self.report(key, "error value in output row")
                continue
            if self._on_change is not None:
                self._on_change(key, row, time, diff)
        return batch

    def on_time_end(self, time: int) -> None:
        if self._on_time_end is not None:
            self._on_time_end(time)

    def close(self) -> None:
        # the user's on_end fires after the settlement commit, so rows injected by
        # upstream on_end hooks were already delivered through on_change
        if self._on_end is not None:
            self._on_end()


class ErrorLogNode(Node):
    """Error log as an engine table of ``(message,)`` rows."""

    def __init__(self, scope: "Scope") -> None:
        super().__init__(scope, [], 1)
        self._counter = itertools.count()
        self.buffered: list[tuple[Pointer, tuple, int]] = []

    def log(self, message: str) -> None:
        key = hash_values((next(self._counter), message), salt=b"errlog")
        self.buffered.append((key, (message,), 1))

    def flush_buffer(self) -> DeltaBatch | None:
        if not self.buffered:
            return None
        out = DeltaBatch(self.buffered)
        self.buffered = []
        return out

    def process(self, time: int) -> DeltaBatch:
        return self.take(0)


class _RemoveErrorsNode(Node):
    def __init__(self, scope: "Scope", source: Node) -> None:
        super().__init__(scope, [source], source.arity)

    def process(self, time: int) -> DeltaBatch:
        batch = self.take(0)
        out = DeltaBatch()
        state = self.current
        for key, row, diff in batch:
            if diff < 0:
                if key in state:
                    out.append(key, state[key], -1)
                continue
            if any(is_error(v) for v in row):
                continue
            out.append(key, row, diff)
        return out


def emit_local_group_diffs(
    out: DeltaBatch, old_groups: dict, local_fn: Callable[[Any], dict]
) -> None:
    """The tail of a group-local recompute: for each touched group, diff the output
    taken before the batch (``old_groups[group]``) against ``local_fn(group)`` after it,
    and append the retractions and insertions to ``out``. Used by sort, sessions and the
    temporal joins."""
    for inst, old_rows in old_groups.items():
        new_rows = local_fn(inst)
        for k, r in old_rows.items():
            if rows_differ(new_rows.get(k), r):
                out.append(k, r, -1)
        for k, r in new_rows.items():
            if rows_differ(old_rows.get(k), r):
                out.append(k, r, 1)


class Scope:
    """Makes the engine graph's nodes and owns them; tables are node handles and
    columns tuple positions."""

    def __init__(self) -> None:
        self.nodes: list[Node] = []
        self.error_log_default = ErrorLogNode(self)
        self._error_log_stack: list[ErrorLogNode] = [self.error_log_default]

    # -- error plumbing -----------------------------------------------------

    def report_error(self, node: Node, key: Pointer | None, message: str) -> None:
        trace = f" at {node.trace}" if node.trace else ""
        # nodes built inside `with pw.local_error_log()` carry their own log
        log = getattr(node, "error_log", None) or self._error_log_stack[-1]
        log.log(f"{node.name}{trace}: {message}")

    def error_log(self) -> ErrorLogNode:
        return ErrorLogNode(self)

    # -- tables and operators -----------------------------------------------

    def empty_table(self, arity: int) -> Node:
        return StaticSource(self, [], arity)

    def static_table(self, rows: Iterable[tuple[Pointer, tuple]], arity: int) -> Node:
        return StaticSource(self, rows, arity)

    def input_session(self, arity: int, upsert: bool = False) -> InputSession:
        return InputSession(self, arity, upsert=upsert)

    def expression_table(
        self, table: Node, expressions: Sequence[EngineExpression]
    ) -> Node:
        return ExpressionNode(self, table, expressions)

    def zip_tables(self, tables: Sequence[Node]) -> Node:
        if len(tables) == 1:
            return tables[0]
        return ZipNode(self, tables)

    def filter_table(self, table: Node, condition_col: int) -> Node:
        return FilterNode(self, table, condition_col)

    def batch_apply_table(
        self,
        table: Node,
        rows_fn: Callable[[list], list],
        arg_cols: Sequence[int],
        propagate_none: bool = False,
    ) -> Node:
        return BatchApplyNode(self, table, rows_fn, arg_cols, propagate_none)

    def concat_tables(self, tables: Sequence[Node]) -> Node:
        return ConcatNode(self, tables)

    def reindex_table(self, table: Node, key_col: int) -> Node:
        return ReindexNode(self, table, key_col)

    def intersect_tables(self, table: Node, others: Sequence[Node]) -> Node:
        return KeyFilterNode(self, table, others, "intersect")

    def subtract_table(self, table: Node, other: Node) -> Node:
        return KeyFilterNode(self, table, [other], "subtract")

    def restrict_table(self, table: Node, universe: Node) -> Node:
        return KeyFilterNode(self, table, [universe], "restrict")

    def override_table_universe(self, table: Node, universe: Node) -> Node:
        return OverrideUniverseNode(self, table)

    def join_tables(
        self,
        left: Node,
        right: Node,
        left_on: Sequence[int],
        right_on: Sequence[int],
        kind: str = JoinKind.INNER,
        id_from_left: bool = False,
        id_spec: tuple | None = None,
    ) -> JoinNode:
        return JoinNode(
            self, left, right, left_on, right_on,
            kind=kind, id_from_left=id_from_left, id_spec=id_spec,
        )

    def group_by_table(
        self,
        table: Node,
        by_cols: Sequence[int],
        reducers: Sequence[tuple[Reducer, Sequence[int]]],
        set_id: bool = False,
        instance_last: bool = False,
    ) -> GroupbyNode:
        return GroupbyNode(
            self, table, by_cols, reducers, set_id=set_id, instance_last=instance_last
        )

    def deduplicate(
        self,
        table: Node,
        value_col: int,
        instance_cols: Sequence[int],
        acceptor: Callable[[Any, Any], bool],
    ) -> Node:
        return DeduplicateNode(self, table, value_col, instance_cols, acceptor)

    def flatten_table(self, table: Node, flat_col: int, with_origin: bool = False) -> Node:
        return FlattenNode(self, table, flat_col, with_origin=with_origin)

    def sort_table(self, table: Node, key_col: int, instance_col: int | None) -> Node:
        return SortNode(self, table, key_col, instance_col)

    def ix_table(
        self,
        keys_table: Node,
        source_table: Node,
        key_col: int,
        optional: bool = False,
        strict: bool = True,
    ) -> Node:
        return IxNode(self, keys_table, source_table, key_col, optional, strict)

    def update_rows_table(self, orig: Node, updates: Node) -> Node:
        return UpdateRowsNode(self, orig, updates)

    def update_cells_table(self, orig: Node, updates: Node, update_cols: Sequence[int]) -> Node:
        return UpdateCellsNode(self, orig, updates, update_cols)

    def subscribe_table(
        self,
        table: Node,
        on_change: Callable[[Pointer, tuple, int, int], None] | None = None,
        on_time_end: Callable[[int], None] | None = None,
        on_end: Callable[[], None] | None = None,
        skip_errors: bool = True,
    ) -> SubscribeNode:
        return SubscribeNode(
            self, table, on_change, on_time_end, on_end, skip_errors=skip_errors
        )

    def remove_errors_from_table(self, table: Node) -> Node:
        return _RemoveErrorsNode(self, table)


class OperatorStats:
    """Per-operator probe counters: rows inserted and deleted by the operator's
    output, its batches, the seconds inside ``process()`` and the last commit that
    touched it."""

    __slots__ = ("insertions", "deletions", "batches", "time_spent", "last_time")

    def __init__(self) -> None:
        self.insertions = 0
        self.deletions = 0
        self.batches = 0
        self.time_spent = 0.0  # seconds inside process()
        self.last_time: int | None = None

    def snapshot(self) -> dict:
        return {
            "insertions": self.insertions,
            "deletions": self.deletions,
            "batches": self.batches,
            "time_spent": self.time_spent,
            "last_time": self.last_time,
        }


class Scheduler:
    """Topological commit-batch pump. All deltas at one logical time are processed as
    a unit; ``propagate`` loops until quiescent, so same-time feedback (error logs)
    settles within the commit, and then hands the commit's device batches to the
    device pipeline.

    ``probe=True`` collects per-operator stats into ``self.stats`` (node index ->
    :class:`OperatorStats`) and sets the ``pathway_queue_depth`` gauge to the number of
    operators with pending batches on each sweep.
    """

    def __init__(self, scope: Scope, probe: bool = False) -> None:
        self.scope = scope
        self.time = 0
        self.probe = probe
        self.stats: dict[int, OperatorStats] = {}
        if probe:
            self._queue_gauge = _metrics.REGISTRY.gauge(
                "pathway_queue_depth",
                "operators with pending delta batches (backpressure)",
            )

    def _stats_of(self, node: Node) -> OperatorStats:
        st = self.stats.get(node.index)
        if st is None:
            st = self.stats[node.index] = OperatorStats()
        return st

    def propagate(self, time: int) -> None:
        scope = self.scope
        probe = self.probe
        while True:
            dirty = [n for n in scope.nodes if n.has_pending()]
            if probe:
                self._queue_gauge.value = float(len(dirty))
            if not dirty:
                # flush error-log buffers; may create new pending work
                flushed = False
                for node in scope.nodes:
                    if isinstance(node, ErrorLogNode):
                        batch = node.flush_buffer()
                        if batch:
                            node.push(0, batch)
                            flushed = True
                if not flushed:
                    break
                continue
            for node in scope.nodes:
                if not node.has_pending():
                    continue
                if probe:
                    t0 = _walltime.perf_counter()
                out = node.process(time)
                if out is None:
                    out = DeltaBatch()
                # consumers consolidate in take(); state applies lazily
                node._defer_state(out)
                if probe:
                    st = self._stats_of(node)
                    st.time_spent += _walltime.perf_counter() - t0
                    st.batches += 1
                    st.last_time = time
                    cols = out.columns
                    if cols is not None:
                        # count from the diff vector: no rows materialise for it
                        if cols.diffs is None:
                            st.insertions += cols.n
                        else:
                            pos = int((cols.diffs > 0).sum())
                            st.insertions += pos
                            st.deletions += cols.n - pos
                    else:
                        # consolidate for counting: a raw batch may carry net-zero
                        # churn
                        for _k, _r, d in out.consolidate():
                            if d > 0:
                                st.insertions += 1
                            else:
                                st.deletions += 1
                if out:
                    for consumer, port in node.consumers:
                        consumer.push(port, out)
        for node in scope.nodes:
            node.on_time_end(time)
        device_pipeline.commit_boundary(time)

    def _end_nodes(self) -> None:
        """Run the on_end hooks; they may inject final batches, propagated as one more
        commit; then tear the sinks down."""
        for node in self.scope.nodes:
            node.on_end()
        if any(n.has_pending() for n in self.scope.nodes):
            self.propagate(self.time)
            self.time += 1
        device_pipeline.drain()
        for node in self.scope.nodes:
            node.close()

    def run_static(self) -> None:
        """Batch mode: every static source at time 0, one commit, then the end."""
        for node in self.scope.nodes:
            if isinstance(node, StaticSource):
                batch = node.initial_batch()
                if batch:
                    node.push(0, batch)
        self.propagate(0)
        self.time = 1
        self._end_nodes()

    def commit(self) -> int:
        """Streaming mode: the static sources' rows (in the first commit) and every
        input session's buffer, as one commit."""
        for node in self.scope.nodes:
            if isinstance(node, StaticSource):
                batch = node.initial_batch()
            elif isinstance(node, InputSession):
                batch = node.flush()
            else:
                continue
            if batch:
                node.push(0, batch)
        time = self.time
        self.propagate(time)
        self.time += 1
        return time

    def finish(self) -> None:
        self.commit()
        self._end_nodes()
