"""Temporal operators: event-time behaviors (buffer, forget, freeze), session windows,
the interval, asof and asof-now joins, and the gradual broadcast.

Counterpart of ``pathway_tpu/engine/temporal.py``. The event time's "now" is the
watermark, the largest value of the time column seen so far; commit times order
delivery and the time column orders the data. Every operator recomputes the groups
(instances) a batch touches and emits the difference against their output before the
batch (:func:`~pathway_tpu_torch.engine.graph.emit_local_group_diffs`), so the output
stays an incremental update stream without arrangements. These nodes run on the host:
the device work of a temporal program happens downstream, in the groupby and the join
that ``windowby`` and ``window_join`` lower to. Each node's ``STATE_ATTRS`` are what
an operator snapshot keeps of it (``engine/persistence.py``).
"""

from __future__ import annotations

import bisect
import heapq
from typing import Any, Sequence

from pathway_tpu_torch.engine.batch import DeltaBatch
from pathway_tpu_torch.engine.graph import Node, Scope, emit_local_group_diffs, join_result_key
from pathway_tpu_torch.engine.value import Pointer, is_error


def _watermark_update(current: Any, batch: DeltaBatch, time_col: int) -> Any:
    """The largest time among the batch's insertions and ``current``."""
    for _key, row, diff in batch:
        if diff <= 0:
            continue
        t = row[time_col]
        if t is None or is_error(t):
            continue
        if current is None or t > current:
            current = t
    return current


def _hashable(v: Any) -> Any:
    try:
        hash(v)
    except TypeError:
        v = repr(v)
    return v


class BufferNode(Node):
    """Holds rows back until the watermark reaches their threshold column (the delay of
    a behavior). ``flush_on_end`` releases everything still held when the stream ends."""

    STATE_ATTRS = ("watermark", "held", "_heap", "_seq", "_ended")

    def __init__(
        self,
        scope: Scope,
        source: Node,
        threshold_col: int,
        time_col: int,
        flush_on_end: bool = True,
    ) -> None:
        super().__init__(scope, [source], source.arity)
        self.threshold_col = threshold_col
        self.time_col = time_col
        self.flush_on_end = flush_on_end
        self.watermark: Any = None
        self.held: dict[Pointer, tuple] = {}
        # release heap of (threshold, seq, key), invalidated lazily: a commit costs
        # O(released log n), not O(held)
        self._heap: list[tuple[Any, int, Pointer]] = []
        self._seq = 0
        self._ended = False

    def process(self, time: int) -> DeltaBatch:
        batch = self.take(0)
        self.watermark = _watermark_update(self.watermark, batch, self.time_col)
        out = DeltaBatch()
        for key, row, diff in batch:
            if diff < 0:
                if key in self.held:
                    del self.held[key]
                else:
                    out.append(key, row, diff)
                continue
            threshold = row[self.threshold_col]
            if (
                self._ended
                or threshold is None
                or is_error(threshold)
                or (self.watermark is not None and threshold <= self.watermark)
            ):
                out.append(key, row, diff)
            else:
                self.held[key] = row
                self._seq += 1
                heapq.heappush(self._heap, (threshold, self._seq, key))
        if self.watermark is not None:
            while self._heap and self._heap[0][0] <= self.watermark:
                _thr, _seq, k = heapq.heappop(self._heap)
                row = self.held.pop(k, None)
                if row is not None:
                    out.append(k, row, 1)
        return out.consolidate()

    def on_end(self) -> None:
        self._ended = True
        if self.flush_on_end and self.held:
            out = DeltaBatch((k, r, 1) for k, r in self.held.items())
            self.held.clear()
            # pending on a port of its own, so the end's settlement commit takes it
            self.pending.setdefault(-1, []).append(out)

    def take(self, port: int) -> DeltaBatch:
        merged = super().take(port)
        extra = self.pending.pop(-1, None)
        if not extra:
            return merged
        # a new batch: the taken one may be the producer's own object, still shared
        # with its other consumers
        out = DeltaBatch(merged.entries)
        for b in extra:
            out.extend(b)
        return out


class ForgetNode(Node):
    """Retracts rows once the watermark passes their threshold column and drops rows
    that arrive after it (the cutoff of a behavior that keeps no results).
    ``mark_forgetting_records`` appends a bool column that marks the forgetting
    retractions."""

    STATE_ATTRS = ("watermark", "live", "_heap", "_seq")

    def __init__(
        self,
        scope: Scope,
        source: Node,
        threshold_col: int,
        time_col: int,
        mark_forgetting_records: bool = False,
    ) -> None:
        super().__init__(scope, [source], source.arity + (1 if mark_forgetting_records else 0))
        self.threshold_col = threshold_col
        self.time_col = time_col
        self.mark = mark_forgetting_records
        self.watermark: Any = None
        self.live: dict[Pointer, tuple] = {}
        self._heap: list[tuple[Any, int, Pointer]] = []
        self._seq = 0

    def _emit(self, out: DeltaBatch, key: Pointer, row: tuple, diff: int, forgetting: bool) -> None:
        if self.mark:
            row = row + (forgetting,)
        out.append(key, row, diff)

    def process(self, time: int) -> DeltaBatch:
        batch = self.take(0)
        # lateness is judged against the watermark of the previous commit: the rows
        # that arrive with the watermark-advancing row see the last recorded time; the
        # watermark advances after the row loop, before the expiry sweep
        out = DeltaBatch()
        for key, row, diff in batch:
            threshold = row[self.threshold_col]
            late = (
                self.watermark is not None
                and threshold is not None
                and not is_error(threshold)
                and threshold <= self.watermark
            )
            if diff < 0:
                if key in self.live:
                    del self.live[key]
                    self._emit(out, key, row, diff, False)
                continue
            if late:
                continue  # arrived after its cutoff
            self.live[key] = row
            if threshold is not None and not is_error(threshold):
                self._seq += 1
                heapq.heappush(self._heap, (threshold, self._seq, key))
            self._emit(out, key, row, diff, False)
        self.watermark = _watermark_update(self.watermark, batch, self.time_col)
        # forget every row whose threshold passed; heap entries of deleted or re-added
        # keys are skipped by the live-row check
        if self.watermark is not None:
            while self._heap and self._heap[0][0] <= self.watermark:
                _thr, _seq, k = heapq.heappop(self._heap)
                r = self.live.get(k)
                if r is not None and r[self.threshold_col] <= self.watermark:
                    del self.live[k]
                    self._emit(out, k, r, -1, True)
        return out.consolidate()


class FreezeNode(Node):
    """Drops the updates (insertions and retractions) of rows whose threshold the
    watermark has passed: that stretch of event time is immutable (the cutoff of a
    behavior that keeps its results)."""

    STATE_ATTRS = ("watermark",)

    def __init__(self, scope: Scope, source: Node, threshold_col: int, time_col: int) -> None:
        super().__init__(scope, [source], source.arity)
        self.threshold_col = threshold_col
        self.time_col = time_col
        self.watermark: Any = None

    def process(self, time: int) -> DeltaBatch:
        batch = self.take(0)
        out = DeltaBatch()
        for key, row, diff in batch:
            threshold = row[self.threshold_col]
            frozen = (
                self.watermark is not None
                and threshold is not None
                and not is_error(threshold)
                and threshold <= self.watermark
            )
            if not frozen:
                out.append(key, row, diff)
        self.watermark = _watermark_update(self.watermark, batch, self.time_col)
        return out.consolidate()


class SessionAssignNode(Node):
    """Appends ``(session_start, session_end)`` to each row: within an instance, a gap
    larger than ``max_gap`` between consecutive times starts a new session. Keyed by the
    source key; each commit recomputes the instances it touches."""

    STATE_ATTRS = ("members",)

    def __init__(
        self,
        scope: Scope,
        source: Node,
        time_col: int,
        instance_col: int | None,
        max_gap: Any,
    ) -> None:
        super().__init__(scope, [source], source.arity + 2)
        self.time_col = time_col
        self.instance_col = instance_col
        self.max_gap = max_gap
        self.members: dict[Any, dict[Pointer, tuple]] = {}

    def _inst(self, row: tuple) -> Any:
        return None if self.instance_col is None else _hashable(row[self.instance_col])

    def _local(self, inst: Any) -> dict[Pointer, tuple]:
        tc = self.time_col
        items = sorted(self.members.get(inst, {}).items(), key=lambda kv: (kv[1][tc], int(kv[0])))
        out: dict[Pointer, tuple] = {}
        session: list[tuple[Pointer, tuple]] = []

        def flush() -> None:
            if session:
                start, end = session[0][1][tc], session[-1][1][tc]
                for k, r in session:
                    out[k] = r + (start, end)
                session.clear()

        prev_t = None
        for k, r in items:
            t = r[tc]
            if prev_t is not None and t - prev_t > self.max_gap:
                flush()
            session.append((k, r))
            prev_t = t
        flush()
        return out

    def process(self, time: int) -> DeltaBatch:
        batch = self.take(0)
        old: dict[Any, dict[Pointer, tuple]] = {}
        for key, row, diff in batch:
            t = row[self.time_col]
            if t is None or is_error(t):
                self.report(key, "error/None time value in session window")
                continue
            inst = self._inst(row)
            if inst not in old:
                old[inst] = self._local(inst)
            group = self.members.setdefault(inst, {})
            if diff > 0:
                group[key] = row
            else:
                group.pop(key, None)
                if not group:
                    self.members.pop(inst, None)
        out = DeltaBatch()
        emit_local_group_diffs(out, old, self._local)
        return out.consolidate()


class _TimedJoin(Node):
    """Two sides held per instance value; each commit recomputes the instances it
    touches with ``_local``. The interval and asof joins differ only there."""

    STATE_ATTRS = ("left_rows", "right_rows")

    def __init__(
        self,
        scope: Scope,
        left: Node,
        right: Node,
        left_time_col: int,
        right_time_col: int,
        left_instance_col: int | None,
        right_instance_col: int | None,
        kind: str,
    ) -> None:
        super().__init__(scope, [left, right], left.arity + right.arity)
        self.lt = left_time_col
        self.rt = right_time_col
        self.li = left_instance_col
        self.ri = right_instance_col
        self.kind = kind
        self.left_rows: dict[Any, dict[Pointer, tuple]] = {}
        self.right_rows: dict[Any, dict[Pointer, tuple]] = {}

    def _local(self, inst: Any) -> dict[Pointer, tuple]:
        raise NotImplementedError

    def _right_sorted(self, inst: Any) -> tuple[list, list]:
        r_sorted = sorted(
            self.right_rows.get(inst, {}).items(), key=lambda kv: (kv[1][self.rt], int(kv[0]))
        )
        return r_sorted, [kv[1][self.rt] for kv in r_sorted]

    def process(self, time: int) -> DeltaBatch:
        old: dict[Any, dict[Pointer, tuple]] = {}
        staged = []
        for side, tcol, icol in ((0, self.lt, self.li), (1, self.rt, self.ri)):
            for key, row, diff in self.take(side):
                if row[tcol] is None or is_error(row[tcol]):
                    which = "left" if side == 0 else "right"
                    self.report(key, f"error/None time in {self._what} ({which})")
                    continue
                inst = None if icol is None else _hashable(row[icol])
                if inst not in old:
                    old[inst] = self._local(inst)
                staged.append((side, inst, key, row, diff))
        for side, inst, key, row, diff in staged:
            arr = self.left_rows if side == 0 else self.right_rows
            group = arr.setdefault(inst, {})
            if diff > 0:
                group[key] = row
            else:
                group.pop(key, None)
                if not group:
                    arr.pop(inst, None)
        out = DeltaBatch()
        emit_local_group_diffs(out, old, self._local)
        return out.consolidate()


class IntervalJoinNode(_TimedJoin):
    """Pairs a left row at time t with the right rows of its instance at times in
    ``[t + lower_bound, t + upper_bound]``. Output ``left_row + right_row`` (padded with
    ``None`` on the outer kinds), keyed as the equality join keys its pairs."""

    _what = "interval join"

    def __init__(
        self,
        scope: Scope,
        left: Node,
        right: Node,
        left_time_col: int,
        right_time_col: int,
        lower_bound: Any,
        upper_bound: Any,
        left_instance_col: int | None = None,
        right_instance_col: int | None = None,
        kind: str = "inner",
    ) -> None:
        super().__init__(scope, left, right, left_time_col, right_time_col,
                         left_instance_col, right_instance_col, kind)
        self.lo = lower_bound
        self.hi = upper_bound

    def _local(self, inst: Any) -> dict[Pointer, tuple]:
        r_sorted, r_times = self._right_sorted(inst)
        l_pad = (None,) * self.inputs[0].arity
        r_pad = (None,) * self.inputs[1].arity
        out: dict[Pointer, tuple] = {}
        matched_right: set[Pointer] = set()
        for lk, lrow in self.left_rows.get(inst, {}).items():
            t = lrow[self.lt]
            lo_i = bisect.bisect_left(r_times, t + self.lo)
            hi_i = bisect.bisect_right(r_times, t + self.hi)
            if lo_i == hi_i:
                if self.kind in ("left", "outer"):
                    out[join_result_key(lk, None)] = lrow + r_pad
                continue
            for rk, rrow in r_sorted[lo_i:hi_i]:
                matched_right.add(rk)
                out[join_result_key(lk, rk)] = lrow + rrow
        if self.kind in ("right", "outer"):
            for rk, rrow in self.right_rows.get(inst, {}).items():
                if rk not in matched_right:
                    out[join_result_key(None, rk)] = l_pad + rrow
        return out


class AsofJoinNode(_TimedJoin):
    """Pairs each left row with the right row of its instance closest in time:
    at or before it (``backward``), at or after it (``forward``) or the nearer of the
    two (``nearest``). Keyed by the left row's id."""

    _what = "interval join"  # as the JAX package words it, so the error logs agree

    def __init__(
        self,
        scope: Scope,
        left: Node,
        right: Node,
        left_time_col: int,
        right_time_col: int,
        left_instance_col: int | None = None,
        right_instance_col: int | None = None,
        direction: str = "backward",
        kind: str = "inner",
    ) -> None:
        if direction not in ("backward", "forward", "nearest"):
            raise ValueError(
                f"asof direction must be backward/forward/nearest, got {direction!r}"
            )
        super().__init__(scope, left, right, left_time_col, right_time_col,
                         left_instance_col, right_instance_col, kind)
        self.direction = direction

    def _match_index(self, t: Any, r_sorted: list, r_times: list) -> int | None:
        if not r_times:
            return None
        if self.direction == "backward":
            i = bisect.bisect_right(r_times, t) - 1
            return i if i >= 0 else None
        if self.direction == "forward":
            i = bisect.bisect_left(r_times, t)
            return i if i < len(r_sorted) else None
        i = bisect.bisect_right(r_times, t) - 1
        j = bisect.bisect_left(r_times, t)
        cands = [c for c in (i, j) if 0 <= c < len(r_sorted)]
        if not cands:
            return None
        return min(cands, key=lambda c: abs(r_sorted[c][1][self.rt] - t))

    def _local(self, inst: Any) -> dict[Pointer, tuple]:
        r_sorted, r_times = self._right_sorted(inst)
        l_pad = (None,) * self.inputs[0].arity
        r_pad = (None,) * self.inputs[1].arity
        out: dict[Pointer, tuple] = {}
        matched_right: set[int] = set()
        for lk, lrow in self.left_rows.get(inst, {}).items():
            idx = self._match_index(lrow[self.lt], r_sorted, r_times)
            if idx is not None:
                matched_right.add(idx)
                out[lk] = lrow + r_sorted[idx][1]
            elif self.kind in ("left", "outer"):
                out[lk] = lrow + r_pad
        if self.kind in ("right", "outer"):
            for i, (rk, rrow) in enumerate(r_sorted):
                if i not in matched_right:
                    out[join_result_key(None, rk)] = l_pad + rrow
        return out


class AsofNowJoinNode(Node):
    """Each left row joins the right side's state as of its arrival, and its result
    never changes when the right side does later; retracting the left row retracts its
    result."""

    STATE_ATTRS = ("right_index", "answered")

    def __init__(
        self,
        scope: Scope,
        left: Node,
        right: Node,
        left_on: Sequence[int],
        right_on: Sequence[int],
        kind: str = "inner",
    ) -> None:
        super().__init__(scope, [left, right], left.arity + right.arity)
        self.left_on = list(left_on)
        self.right_on = list(right_on)
        self.kind = kind
        self.right_index: dict[Any, dict[Pointer, tuple]] = {}
        self.answered: dict[Pointer, list[tuple[Pointer, tuple]]] = {}

    @staticmethod
    def _jk(row: tuple, cols: Sequence[int]) -> Any:
        vals = tuple(row[c] for c in cols)
        try:
            hash(vals)
        except TypeError:
            vals = tuple(repr(v) for v in vals)
        return vals

    def process(self, time: int) -> DeltaBatch:
        left_batch = self.take(0)
        for key, row, diff in self.take(1):  # the right side's state first
            jk = self._jk(row, self.right_on)
            group = self.right_index.setdefault(jk, {})
            if diff > 0:
                group[key] = row
            else:
                group.pop(key, None)
                if not group:
                    self.right_index.pop(jk, None)
        out = DeltaBatch()
        r_pad = (None,) * self.inputs[1].arity
        for key, row, diff in left_batch:
            if diff < 0:
                for okey, orow in self.answered.pop(key, ()):
                    out.append(okey, orow, -1)
                continue
            matches = self.right_index.get(self._jk(row, self.left_on), {})
            emitted: list[tuple[Pointer, tuple]] = []
            if matches:
                for rk, rrow in matches.items():
                    okey = join_result_key(key, rk)
                    orow = row + rrow
                    out.append(okey, orow, 1)
                    emitted.append((okey, orow))
            elif self.kind in ("left", "outer"):
                orow = row + r_pad
                out.append(key, orow, 1)
                emitted.append((key, orow))
            for okey, orow in self.answered.get(key) or ():
                out.append(okey, orow, -1)
            self.answered[key] = emitted
        return out.consolidate()


class GradualBroadcastNode(Node):
    """Appends an ``apx_value`` column that moves between ``lower`` and ``upper`` row by
    row as the broadcast value advances.

    The threshold stream's ``(lower, value, upper)`` sets a cutoff in key space at the
    fraction ``(value - lower) / (upper - lower)``: rows whose key falls below it see
    ``upper``, the rest ``lower``. When the value moves, only the rows that cross the
    cutoff are emitted again.
    """

    STATE_ATTRS = ("triplet",)

    _KEY_SPACE = float(2**64)

    def __init__(self, scope: Scope, source: Node, threshold: Node) -> None:
        super().__init__(scope, [source, threshold], source.arity + 1)
        self.triplet: tuple | None = None  # (lower, value, upper)

    def _apx(self, key: Pointer) -> Any:
        if self.triplet is None:
            return None
        lower, value, upper = self.triplet
        if upper == lower:
            return lower
        cutoff = (value - lower) / (upper - lower)
        return upper if (int(key) % 2**64) / self._KEY_SPACE <= cutoff else lower

    def process(self, time: int) -> DeltaBatch:
        src_batch = self.take(0)
        thr_batch = self.take(1)
        out = DeltaBatch()
        retracted: set[Pointer] = set()

        def retract(key: Pointer) -> None:
            # a key's previous output is retracted at most once a commit
            prev = self.current.get(key)
            if prev is not None and key not in retracted:
                out.append(key, prev, -1)
                retracted.add(key)

        old_triplet = self.triplet
        for _key, row, diff in thr_batch:
            if diff > 0:
                self.triplet = (row[0], row[1], row[2])
        handled = {key for key, _r, _d in src_batch}
        if self.triplet != old_triplet:
            # only the rows that cross the cutoff change; the keys of this commit's
            # batch are handled by the loop below
            for key, cur in list(self.current.items()):
                if key in handled:
                    continue
                new_apx = self._apx(key)
                if cur[-1] != new_apx:
                    retract(key)
                    out.append(key, cur[:-1] + (new_apx,), 1)
        for key, row, diff in src_batch:
            retract(key)
            if diff > 0:
                out.append(key, row + (self._apx(key),), 1)
        return out.consolidate()
