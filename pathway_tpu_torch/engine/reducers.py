"""Engine reducers with retraction support.

A copy of ``pathway_tpu/engine/reducers.py``: each reducer keeps per-group state that
takes both insertions and retractions (diff < 0). The semigroup reducers (count, sum)
keep a running value; the rest keep a counted multiset and recompute on demand.
"""

from __future__ import annotations

import enum
from typing import Any, Callable

import numpy as np

from pathway_tpu_torch.engine.value import ERROR, is_error


class ReducerKind(enum.Enum):
    COUNT = "count"
    SUM = "sum"
    MIN = "min"
    MAX = "max"
    ARG_MIN = "arg_min"
    ARG_MAX = "arg_max"
    UNIQUE = "unique"
    ANY = "any"
    SORTED_TUPLE = "sorted_tuple"
    TUPLE = "tuple"
    NDARRAY = "ndarray"
    EARLIEST = "earliest"
    LATEST = "latest"
    STATEFUL = "stateful"
    COUNT_DISTINCT = "count_distinct"


def _token(value: Any) -> Any:
    """Hashable token for multiset bookkeeping (ndarrays are unhashable)."""
    if isinstance(value, np.ndarray):
        return ("__nd__", str(value.dtype), value.shape, value.tobytes())
    if isinstance(value, (list, dict)):
        return ("__repr__", repr(value))
    try:
        hash(value)
    except TypeError:
        return ("__repr__", repr(value))
    return value


class ReducerState:
    """Base: counted multiset of argument tuples with (time, seq) order info."""

    __slots__ = ("counts", "values", "order", "total", "seq")

    def __init__(self) -> None:
        self.counts: dict[Any, int] = {}
        self.values: dict[Any, Any] = {}  # token -> actual args tuple
        self.order: dict[Any, tuple[int, int]] = {}  # token -> (time, seq) first seen
        self.total = 0
        self.seq = 0

    def update(self, args: tuple, diff: int, time: int) -> None:
        tok = _token(args)
        cnt = self.counts.get(tok, 0) + diff
        self.total += diff
        if cnt <= 0:
            self.counts.pop(tok, None)
            self.values.pop(tok, None)
            self.order.pop(tok, None)
        else:
            if tok not in self.counts:
                self.order[tok] = (time, self.seq)
                self.seq += 1
                self.values[tok] = args
            self.counts[tok] = cnt

    def is_empty(self) -> bool:
        return self.total <= 0 and not self.counts

    def iter_args(self):
        """Yield (args, count, order) for each distinct entry."""
        for tok, cnt in self.counts.items():
            yield self.values[tok], cnt, self.order[tok]


class Reducer:
    """A reducer over one or more argument columns."""

    kind: ReducerKind
    n_args = 1

    def __init__(self, **options: Any) -> None:
        self.options = options

    def make_state(self) -> Any:
        return ReducerState()

    def update(self, state: Any, args: tuple, diff: int, time: int) -> None:
        state.update(args, diff, time)

    def compute(self, state: Any) -> Any:
        raise NotImplementedError

    def is_empty(self, state: Any) -> bool:
        return state.is_empty()


class _RunningState:
    __slots__ = ("count", "acc", "error_count")

    def __init__(self) -> None:
        self.count = 0
        self.acc: Any = None
        self.error_count = 0


class CountReducer(Reducer):
    kind = ReducerKind.COUNT
    n_args = 0

    def make_state(self) -> _RunningState:
        return _RunningState()

    def update(self, state: _RunningState, args: tuple, diff: int, time: int) -> None:
        state.count += diff

    def compute(self, state: _RunningState) -> Any:
        return state.count

    def is_empty(self, state: _RunningState) -> bool:
        return state.count <= 0


class SumReducer(Reducer):
    """Running-total sum for int/float/ndarray (semigroup with inverse)."""

    kind = ReducerKind.SUM

    def make_state(self) -> _RunningState:
        return _RunningState()

    def update(self, state: _RunningState, args: tuple, diff: int, time: int) -> None:
        (value,) = args
        state.count += diff
        if is_error(value):
            state.error_count += diff
            return
        if value is None:
            return
        contribution = value * diff if not isinstance(value, bool) else int(value) * diff
        if state.acc is None:
            state.acc = contribution
        else:
            state.acc = state.acc + contribution

    def compute(self, state: _RunningState) -> Any:
        if state.error_count > 0:
            return ERROR
        if state.acc is None:
            return 0
        return state.acc

    def is_empty(self, state: _RunningState) -> bool:
        return state.count <= 0


class MinReducer(Reducer):
    kind = ReducerKind.MIN

    def compute(self, state: ReducerState) -> Any:
        best = None
        try:
            for args, _cnt, _ord in state.iter_args():
                v = args[0]
                if is_error(v):
                    return ERROR
                if v is None:
                    continue
                if best is None or v < best:
                    best = v
        except TypeError:
            return ERROR  # incomparable values poison the aggregate
        return best


class MaxReducer(Reducer):
    kind = ReducerKind.MAX

    def compute(self, state: ReducerState) -> Any:
        best = None
        try:
            for args, _cnt, _ord in state.iter_args():
                v = args[0]
                if is_error(v):
                    return ERROR
                if v is None:
                    continue
                if best is None or v > best:
                    best = v
        except TypeError:
            return ERROR
        return best


class ArgMinReducer(Reducer):
    kind = ReducerKind.ARG_MIN
    n_args = 2  # (value, arg)

    def compute(self, state: ReducerState) -> Any:
        best = None
        best_arg = None
        try:
            for args, _cnt, _ord in state.iter_args():
                v, a = args
                if is_error(v) or is_error(a):
                    return ERROR
                if v is None:
                    continue
                if best is None or (v, _token(a)) < best:
                    best = (v, _token(a))
                    best_arg = a
        except TypeError:
            return ERROR
        return best_arg


class ArgMaxReducer(Reducer):
    kind = ReducerKind.ARG_MAX
    n_args = 2

    def compute(self, state: ReducerState) -> Any:
        best = None
        best_arg = None
        try:
            for args, _cnt, _ord in state.iter_args():
                v, a = args
                if is_error(v) or is_error(a):
                    return ERROR
                if v is None:
                    continue
                if best is None or (v, _token(a)) > best:
                    best = (v, _token(a))
                    best_arg = a
        except TypeError:
            return ERROR
        return best_arg


class UniqueReducer(Reducer):
    kind = ReducerKind.UNIQUE

    def compute(self, state: ReducerState) -> Any:
        distinct = [args[0] for args, _cnt, _ord in state.iter_args()]
        non_none = [v for v in distinct if v is not None]
        if len({_token(v) for v in non_none}) > 1:
            return ERROR  # more than one distinct value
        return non_none[0] if non_none else None


class AnyReducer(Reducer):
    """Deterministic 'pick any': smallest by token order."""

    kind = ReducerKind.ANY

    def compute(self, state: ReducerState) -> Any:
        best = None
        best_tok = None
        for args, _cnt, _ord in state.iter_args():
            v = args[0]
            if is_error(v):
                continue
            tok = repr(_token(v))
            if best_tok is None or tok < best_tok:
                best_tok = tok
                best = v
        return best


class SortedTupleReducer(Reducer):
    kind = ReducerKind.SORTED_TUPLE

    def __init__(self, skip_nones: bool = False, **options: Any) -> None:
        super().__init__(**options)
        self.skip_nones = skip_nones

    def compute(self, state: ReducerState) -> Any:
        vals = []
        for args, cnt, _ord in state.iter_args():
            v = args[0]
            if is_error(v):
                return ERROR
            if v is None and self.skip_nones:
                continue
            vals.extend([v] * cnt)
        try:
            return tuple(sorted(vals))
        except TypeError:
            return tuple(sorted(vals, key=lambda v: repr(v)))


class TupleReducer(Reducer):
    """Values ordered by insertion order (time, seq) — stable across runs."""

    kind = ReducerKind.TUPLE

    def __init__(self, skip_nones: bool = False, **options: Any) -> None:
        super().__init__(**options)
        self.skip_nones = skip_nones

    def compute(self, state: ReducerState) -> Any:
        entries = []
        for args, cnt, order in state.iter_args():
            v = args[0]
            if is_error(v):
                return ERROR
            if v is None and self.skip_nones:
                continue
            entries.append((order, v, cnt))
        entries.sort(key=lambda e: e[0])
        out: list[Any] = []
        for _order, v, cnt in entries:
            out.extend([v] * cnt)
        return tuple(out)


class NdarrayReducer(Reducer):
    kind = ReducerKind.NDARRAY

    def compute(self, state: ReducerState) -> Any:
        entries = []
        for args, cnt, order in state.iter_args():
            v = args[0]
            if is_error(v):
                return ERROR
            entries.append((order, v, cnt))
        entries.sort(key=lambda e: e[0])
        out: list[Any] = []
        for _order, v, cnt in entries:
            out.extend([v] * cnt)
        return np.array(out)


class EarliestReducer(Reducer):
    kind = ReducerKind.EARLIEST

    def compute(self, state: ReducerState) -> Any:
        best = None
        best_order = None
        for args, _cnt, order in state.iter_args():
            if best_order is None or order < best_order:
                best_order = order
                best = args[0]
        return best


class LatestReducer(Reducer):
    kind = ReducerKind.LATEST

    def compute(self, state: ReducerState) -> Any:
        best = None
        best_order = None
        for args, _cnt, order in state.iter_args():
            if best_order is None or order > best_order:
                best_order = order
                best = args[0]
        return best


class CountDistinctReducer(Reducer):
    kind = ReducerKind.COUNT_DISTINCT

    def compute(self, state: ReducerState) -> Any:
        return len(state.counts)


class StatefulReducer(Reducer):
    """Custom combine over the full multiset (BaseCustomAccumulator backing).

    ``combine(rows: list[tuple[args, count]]) -> value`` recomputes from the
    retained multiset — correct under retraction for any user logic
    (reference: Stateful{combine_fn} reduce.rs:36 + stateful_reduce.rs:20).
    """

    kind = ReducerKind.STATEFUL

    def __init__(self, combine: Callable[[list[tuple[tuple, int]]], Any], n_args: int = 1, **options: Any) -> None:
        super().__init__(**options)
        self.combine = combine
        self.n_args = n_args

    def compute(self, state: ReducerState) -> Any:
        entries = []
        for args, cnt, order in state.iter_args():
            entries.append((order, args, cnt))
        entries.sort(key=lambda e: e[0])
        try:
            return self.combine([(args, cnt) for _o, args, cnt in entries])
        except Exception:  # noqa: BLE001
            return ERROR


REDUCER_CLASSES: dict[ReducerKind, type[Reducer]] = {
    ReducerKind.COUNT: CountReducer,
    ReducerKind.SUM: SumReducer,
    ReducerKind.MIN: MinReducer,
    ReducerKind.MAX: MaxReducer,
    ReducerKind.ARG_MIN: ArgMinReducer,
    ReducerKind.ARG_MAX: ArgMaxReducer,
    ReducerKind.UNIQUE: UniqueReducer,
    ReducerKind.ANY: AnyReducer,
    ReducerKind.SORTED_TUPLE: SortedTupleReducer,
    ReducerKind.TUPLE: TupleReducer,
    ReducerKind.NDARRAY: NdarrayReducer,
    ReducerKind.EARLIEST: EarliestReducer,
    ReducerKind.LATEST: LatestReducer,
    ReducerKind.STATEFUL: StatefulReducer,
    ReducerKind.COUNT_DISTINCT: CountDistinctReducer,
}


def make_reducer(kind: ReducerKind, **options: Any) -> Reducer:
    return REDUCER_CLASSES[kind](**options)
