"""Temporal stdlib: windows, temporal behaviors, interval/asof joins.

Counterpart of ``pathway_tpu/stdlib/temporal/__init__.py``, after Pathway's
``python/pathway/stdlib/temporal/``: ``windowby`` with tumbling, sliding, session and
``intervals_over`` windows (_window.py:593-863), ``CommonBehavior`` and
``ExactlyOnceBehavior`` (temporal_behavior.py:21,79), ``interval_join``
(_interval_join.py), ``asof_join`` (_asof_join.py), ``asof_now_join``
(_asof_now_join.py) and ``window_join`` (_window_join.py). Behaviors lower to the
engine's event-time buffer, forget and freeze operators (``engine/temporal.py``); a
window's reduce is a groupby over the window bounds and the instance, and a window join
an equality join on them, so both reach the engine's device operators.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import reducers as _reducers
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    apply as pw_apply,
    make_tuple,
    wrap_expression,
)
from pathway_tpu_torch.internals.table import Table, TableSpec
from pathway_tpu_torch.internals.desugaring import resolve_this, resolve_side


# -- behaviors ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CommonBehavior:
    """delay: emit window results only once the watermark passes
    window *start* + delay (reference anchors initial output at the
    beginning of the window, _window.py:396); cutoff: forget windows
    whose end passed watermark - cutoff; keep_results: whether forgotten
    windows keep their final output (reference temporal_behavior.py:21)."""

    delay: Any = None
    cutoff: Any = None
    keep_results: bool = True


def common_behavior(
    delay: Any = None, cutoff: Any = None, keep_results: bool = True
) -> CommonBehavior:
    return CommonBehavior(delay, cutoff, keep_results)


@dataclasses.dataclass(frozen=True)
class ExactlyOnceBehavior:
    """Each window emitted exactly once, then frozen. Lowered per-window to
    ``CommonBehavior(delay=duration + shift, cutoff=shift)`` at materialize
    time (reference temporal_behavior.py:79, _window.py:371-387)."""

    shift: Any = None


def exactly_once_behavior(shift: Any = None) -> ExactlyOnceBehavior:
    return ExactlyOnceBehavior(shift)


# -- windows -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TumblingWindow:
    duration: Any
    origin: Any = 0

    def assign(self, t: Any) -> tuple:
        start = ((t - self.origin) // self.duration) * self.duration + self.origin
        return ((start, start + self.duration),)


@dataclasses.dataclass(frozen=True)
class SlidingWindow:
    hop: Any
    duration: Any
    origin: Any = 0

    def assign(self, t: Any) -> tuple:
        # windows [s, s+duration) with s ≡ origin (mod hop) containing t
        out = []
        s = ((t - self.origin - self.duration) // self.hop) * self.hop + self.origin
        while s <= t:
            if s <= t < s + self.duration:
                out.append((s, s + self.duration))
            s += self.hop
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class SessionWindow:
    max_gap: Any


def tumbling(duration: Any, origin: Any = 0) -> TumblingWindow:
    return TumblingWindow(duration, origin)


def sliding(hop: Any, duration: Any, origin: Any = 0) -> SlidingWindow:
    return SlidingWindow(hop, duration, origin)


def session(max_gap: Any) -> SessionWindow:
    return SessionWindow(max_gap)


def _assign_windows(
    table: Table, time_expr: Any, window: Any, instance: Any
) -> Table:
    """Window assignment: every row gains ``_pw_time``/``_pw_instance``/
    ``_pw_window_start``/``_pw_window_end`` (sliding windows flatten rows
    into one copy per containing window). Shared by ``windowby`` and
    ``window_join``."""
    t = table
    base_cols = {n: t[n] for n in t.column_names()}
    inst_expr = (
        instance if instance is not None else pw_apply(lambda _t: 0, time_expr)
    )
    if isinstance(window, SessionWindow):
        pre = t.select(**base_cols, _pw_time=time_expr, _pw_instance=inst_expr)
        n = len(pre.column_names())
        return pre._derived(
            TableSpec(
                "session_assign",
                [pre],
                {
                    "time_col": n - 2,
                    "instance_col": n - 1,
                    "max_gap": window.max_gap,
                },
            ),
            {
                **{c: pre._dtypes[c] for c in pre.column_names()},
                "_pw_window_start": dt.ANY,
                "_pw_window_end": dt.ANY,
            },
        )
    pre = t.select(
        **base_cols,
        _pw_time=time_expr,
        _pw_instance=inst_expr,
        _pw_windows=pw_apply(lambda tv: window.assign(tv), time_expr),
    )
    flat = pre.flatten(pre["_pw_windows"])
    return flat.select(
        **{n: flat[n] for n in t.column_names()},
        _pw_time=flat["_pw_time"],
        _pw_instance=flat["_pw_instance"],
        _pw_window_start=flat["_pw_windows"].get(0),
        _pw_window_end=flat["_pw_windows"].get(1),
    )


class WindowedTable:
    """`t.windowby(...)`; materialize with `.reduce(**aggregations)`.

    Inside reduce, ``pw.this['_pw_window_start'] / ['_pw_window_end'] /
    ['_pw_instance']`` reference the window bounds (reference exposes the
    same columns)."""

    def __init__(
        self,
        table: Table,
        time_expr: ColumnExpression,
        window: Any,
        instance: ColumnExpression | None,
        behavior: CommonBehavior | None,
    ) -> None:
        self.table = table
        self.time_expr = time_expr
        self.window = window
        self.instance = instance
        self.behavior = behavior

    def _assigned(self) -> Table:
        return _assign_windows(
            self.table, self.time_expr, self.window, self.instance
        )

    def _lowered_behavior(self) -> CommonBehavior | None:
        """ExactlyOnce → CommonBehavior(duration + shift, shift, True), as
        the reference does per-window (_window.py:371-387)."""
        b = self.behavior
        if not isinstance(b, ExactlyOnceBehavior):
            return b
        if isinstance(self.window, TumblingWindow):
            duration = self.window.duration
        elif isinstance(self.window, SlidingWindow):
            duration = self.window.duration
        else:
            raise ValueError(
                "exactly_once_behavior is unsupported for session windows"
            )
        shift = b.shift if b.shift is not None else 0
        return CommonBehavior(
            delay=duration + shift, cutoff=shift, keep_results=True
        )

    def _behaved(self, assigned: Table) -> Table:
        behavior = self._lowered_behavior()
        if behavior is None:
            return assigned
        cols = assigned.column_names()
        time_col = cols.index("_pw_time")
        out = assigned
        # CUTOFF gates arrivals FIRST, on the raw stream: its watermark
        # must advance with every arriving row. Downstream of the delay
        # buffer it would only see released rows — held rows would not
        # move it, and a late row for an already-emitted window could
        # slip past the cutoff (caught by the behaviors x windows matrix:
        # exactly_once emitted a second, revised result).
        if behavior.cutoff is not None:
            cutoff = behavior.cutoff
            out = out.select(
                **{n: out[n] for n in cols},
                _pw_threshold=pw_apply(
                    lambda e: e + cutoff, out["_pw_window_end"]
                ),
            )
            kind = "forget" if not behavior.keep_results else "freeze"
            out = out._derived(
                TableSpec(
                    kind,
                    [out],
                    {
                        "threshold_col": len(cols),
                        "time_col": time_col,
                    },
                ),
                {n: out._dtypes[n] for n in out.column_names()},
            )[cols]
        if behavior.delay is not None:
            # anchored at window *start* (reference _window.py:396-398:
            # "delays initial output ... with respect to the beginning of
            # the window")
            delay = behavior.delay
            out = out.select(
                **{n: out[n] for n in cols},
                _pw_threshold=pw_apply(
                    lambda s: s + delay, out["_pw_window_start"]
                ),
            )
            out = out._derived(
                TableSpec(
                    "buffer",
                    [out],
                    {
                        "threshold_col": len(cols),
                        "time_col": time_col,
                    },
                ),
                {n: out._dtypes[n] for n in out.column_names()},
            )[cols]
        return out

    def reduce(self, *args: Any, **kwargs: Any) -> Table:
        if isinstance(self.window, IntervalsOverWindow):
            return self._reduce_intervals_over(*args, **kwargs)
        assigned = self._behaved(self._assigned())
        grouped = assigned.groupby(
            assigned["_pw_window_start"],
            assigned["_pw_window_end"],
            assigned["_pw_instance"],
        )
        resolved_kwargs = {}
        for name, value in kwargs.items():
            resolved_kwargs[name] = _retarget(value, self.table, assigned)
        for arg in args:
            resolved = _retarget(arg, self.table, assigned)
            resolved_kwargs[resolved.name] = resolved
        return grouped.reduce(**resolved_kwargs)

    def _reduce_intervals_over(self, *args: Any, **kwargs: Any) -> Table:
        """intervals_over windows: one group per value of ``at`` containing
        rows with time in [at + lower, at + upper]; with is_outer, empty
        windows surface with None aggregates (reference _window.py:771)."""
        w = self.window
        at_ref = w.at
        at_table = at_ref.table
        lb, ub = w.lower_bound, w.upper_bound
        probe = at_table.select(_pw_at=at_ref)
        joined = interval_join(
            probe,
            self.table,
            probe["_pw_at"],
            self.time_expr,
            interval(lb, ub),
            how="inner",
        )
        # instance rides as a GROUP key, not a join equality — every
        # at-window sees all rows, groups split per instance (reference
        # _IntervalsOverWindow._apply, _window.py:557-568)
        inst_kwargs = (
            {"_pw_instance": self.instance}
            if self.instance is not None
            else {}
        )
        flat = joined.select(
            *[self.table[n] for n in self.table.column_names()],
            _pw_window_start=pw_apply(lambda p: p + lb, probe["_pw_at"]),
            _pw_window_end=pw_apply(lambda p: p + ub, probe["_pw_at"]),
            **inst_kwargs,
        )
        by = [flat["_pw_window_start"], flat["_pw_window_end"]]
        if self.instance is not None:
            by.append(flat["_pw_instance"])
        grouped = flat.groupby(*by)
        resolved_kwargs = {}
        for arg in args:
            resolved = _retarget(arg, self.table, flat)
            resolved_kwargs[resolved.name] = resolved
        for name, value in kwargs.items():
            resolved_kwargs[name] = _retarget(value, self.table, flat)
        user_names = list(resolved_kwargs)
        # the bounds always ride along (needed to match empty windows back)
        resolved_kwargs.setdefault("_pw_window_start", flat["_pw_window_start"])
        resolved_kwargs.setdefault("_pw_window_end", flat["_pw_window_end"])
        reduced = grouped.reduce(**resolved_kwargs)
        if not w.is_outer:
            return reduced[user_names]
        # outer: every at-value yields a window even when empty
        windows = probe.groupby(probe["_pw_at"]).reduce(
            _pw_at=probe["_pw_at"]
        )
        windows = windows.select(
            _pw_window_start=pw_apply(lambda p: p + lb, windows["_pw_at"]),
            _pw_window_end=pw_apply(lambda p: p + ub, windows["_pw_at"]),
        )
        join = windows.join(
            reduced,
            windows["_pw_window_start"] == reduced["_pw_window_start"],
            windows["_pw_window_end"] == reduced["_pw_window_end"],
            how="left",
        )
        from pathway_tpu_torch.internals.expression import ColumnReference

        out_cols = {}
        for n in user_names:
            resolved = resolved_kwargs[n]
            bound_ref = (
                resolved.name
                if isinstance(resolved, ColumnReference)
                and resolved.name in ("_pw_window_start", "_pw_window_end")
                else None
            )
            if n in ("_pw_window_start", "_pw_window_end"):
                out_cols[n] = windows[n]
            elif bound_ref is not None:
                # a user-renamed window bound (e.g. start=this._pw_window_start)
                # must keep its value for EMPTY windows too — the reduced
                # side is all-None there
                out_cols[n] = windows[bound_ref]
            else:
                out_cols[n] = reduced[n]
        return join.select(**out_cols)


def _retarget(expression: Any, source: Table, target: Table) -> Any:
    """Rewrite references from the pre-window table onto the assigned table
    (same column names survive the window assignment select)."""
    from pathway_tpu_torch.internals.desugaring import substitute
    from pathway_tpu_torch.internals.expression import ColumnReference

    expression = resolve_this(expression, target)

    def replace(e: Any) -> Any:
        if isinstance(e, ColumnReference) and e.table is source:
            return ColumnReference(target, e.name)
        return None

    return substitute(wrap_expression(expression), replace)


def windowby(
    table: Table,
    time_expr: Any,
    *,
    window: Any,
    instance: Any = None,
    behavior: CommonBehavior | None = None,
) -> WindowedTable:
    time_resolved = resolve_this(time_expr, table)
    inst_resolved = resolve_this(instance, table) if instance is not None else None
    return WindowedTable(table, time_resolved, window, inst_resolved, behavior)


# -- temporal joins ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Interval:
    lower_bound: Any
    upper_bound: Any


def interval(lower_bound: Any, upper_bound: Any) -> Interval:
    return Interval(lower_bound, upper_bound)


class _TemporalJoinResult:
    def __init__(
        self,
        kind: str,
        left: Table,
        right: Table,
        params: dict,
        on: Sequence[Any],
        how: str,
    ) -> None:
        self._kind = kind
        self._left = left
        self._right = right
        self._params = params
        self._how = how
        from pathway_tpu_torch.internals.desugaring import resolve_join_sides
        from pathway_tpu_torch.internals.expression import BinaryOpExpression

        if left is right:
            raise ValueError(
                "temporal self-joins need distinct table objects; derive a "
                "copy first (e.g. right = left.select(*left))"
            )
        self._on = []
        for cond in on:
            resolved = resolve_join_sides(cond, left, right)
            if not (
                isinstance(resolved, BinaryOpExpression) and resolved._op == "=="
            ):
                raise ValueError("temporal join conditions must be equalities")
            self._on.append((resolved._left, resolved._right))
        if kind in ("interval_join", "asof_join"):
            # several equalities fold into one tuple-valued join key at
            # lowering time (reference takes `*on` the same way,
            # _interval_join.py:583)
            direction = params.get("direction")
            if direction is not None and direction not in (
                "backward",
                "forward",
                "nearest",
            ):
                raise ValueError(
                    f"asof direction must be backward/forward/nearest, "
                    f"got {direction!r}"
                )

    def select(self, *args: Any, **kwargs: Any) -> Table:
        from pathway_tpu_torch.internals.desugaring import resolve_join_sides
        from pathway_tpu_torch.internals.expression import ColumnReference

        exprs: dict[str, ColumnExpression] = {}
        for arg in args:
            resolved = resolve_join_sides(arg, self._left, self._right)
            if not isinstance(resolved, ColumnReference):
                raise ValueError("positional args must be column references")
            exprs[resolved.name] = resolved
        for name, value in kwargs.items():
            exprs[name] = resolve_join_sides(value, self._left, self._right)
        dtypes = {n: e._dtype for n, e in exprs.items()}
        return Table(
            TableSpec(
                self._kind,
                [self._left, self._right],
                {
                    **self._params,
                    "on": self._on,
                    "how": self._how,
                    "exprs": exprs,
                },
            ),
            list(exprs.keys()),
            dtypes,
        )


def interval_join(
    left: Table,
    right: Table,
    left_time: Any,
    right_time: Any,
    interval: Interval,
    *on: Any,
    how: str = "inner",
) -> _TemporalJoinResult:
    return _TemporalJoinResult(
        "interval_join",
        left,
        right,
        {
            "left_time": resolve_side(left_time, left, "left"),
            "right_time": resolve_side(right_time, right, "right"),
            "lower_bound": interval.lower_bound,
            "upper_bound": interval.upper_bound,
        },
        on,
        how,
    )


def interval_join_left(left, right, lt, rt, iv, *on):
    return interval_join(left, right, lt, rt, iv, *on, how="left")


def interval_join_right(left, right, lt, rt, iv, *on):
    return interval_join(left, right, lt, rt, iv, *on, how="right")


def interval_join_outer(left, right, lt, rt, iv, *on):
    return interval_join(left, right, lt, rt, iv, *on, how="outer")


def asof_join(
    left: Table,
    right: Table,
    left_time: Any,
    right_time: Any,
    *on: Any,
    how: str = "inner",
    direction: str = "backward",
) -> _TemporalJoinResult:
    return _TemporalJoinResult(
        "asof_join",
        left,
        right,
        {
            "left_time": resolve_side(left_time, left, "left"),
            "right_time": resolve_side(right_time, right, "right"),
            "direction": direction,
        },
        on,
        how,
    )


def asof_join_left(left, right, lt, rt, *on, direction="backward"):
    return asof_join(left, right, lt, rt, *on, how="left", direction=direction)


def asof_now_join(
    left: Table, right: Table, *on: Any, how: str = "inner"
) -> _TemporalJoinResult:
    return _TemporalJoinResult("asof_now_join", left, right, {}, on, how)


def asof_now_join_left(left, right, *on):
    return asof_now_join(left, right, *on, how="left")


# -- window join --------------------------------------------------------------


class WindowJoinResult:
    """Result of ``window_join``: records of both sides sharing a window
    (and satisfying the ``on`` equalities) are joined; ``.select()``
    accepts references to the original tables plus pw.left/pw.right
    (reference: _window_join.py:24 WindowJoinResult)."""

    def __init__(
        self,
        orig_left: Table,
        orig_right: Table,
        left_assigned: Table,
        right_assigned: Table,
        conds: list,
        how: str,
    ) -> None:
        from pathway_tpu_torch.internals.joins import JoinResult

        self._orig_left = orig_left
        self._orig_right = orig_right
        self._left_assigned = left_assigned
        self._right_assigned = right_assigned
        self._join = JoinResult(left_assigned, right_assigned, tuple(conds), how)

    def _retarget_both(self, expression: Any) -> Any:
        from pathway_tpu_torch.internals.desugaring import (
            resolve_join_sides,
            substitute,
        )
        from pathway_tpu_torch.internals.expression import ColumnReference

        if isinstance(expression, str):
            # bare column name binds to the left side, like resolve_this
            expression = ColumnReference(self._left_assigned, expression)
        # pw.left / pw.right / pw.this(→left) address the join sides
        # (reference WindowJoinResult.select accepts them alongside refs)
        e = resolve_join_sides(
            expression, self._left_assigned, self._right_assigned
        )

        # rewrite direct refs to the ORIGINAL tables onto the assigned twins
        def replace(x: Any) -> Any:
            if isinstance(x, ColumnReference):
                if x.table is self._orig_left:
                    return ColumnReference(self._left_assigned, x.name)
                if x.table is self._orig_right:
                    return ColumnReference(self._right_assigned, x.name)
            return None

        return substitute(e, replace)

    def select(self, *args: Any, **kwargs: Any) -> Table:
        from pathway_tpu_torch.internals.expression import ColumnReference

        out_args = []
        for arg in args:
            r = self._retarget_both(arg)
            if not isinstance(r, ColumnReference):
                raise ValueError("positional args must be column references")
            out_args.append(r)
        out_kwargs = {
            name: self._retarget_both(v) for name, v in kwargs.items()
        }
        return self._join.select(*out_args, **out_kwargs)


def _session_window_sides(
    left: Table,
    right: Table,
    left_time: Any,
    right_time: Any,
    window: SessionWindow,
    on_pairs: list,
    linst: Any,
    rinst: Any,
) -> tuple[Table, Table]:
    """Sessions span the *union* of both sides' records per (instance,
    on-values) group (reference _window_join.py session path)."""
    lt = resolve_side(left_time, left, "left")
    rt = resolve_side(right_time, right, "right")
    lgrp = make_tuple(
        linst if linst is not None else wrap_expression(0),
        *[lexpr for lexpr, _r in on_pairs],
    )
    rgrp = make_tuple(
        rinst if rinst is not None else wrap_expression(0),
        *[rexpr for _l, rexpr in on_pairs],
    )
    lg = left.select(_pw_t=lt, _pw_grp=lgrp)
    rg = right.select(_pw_t=rt, _pw_grp=rgrp)
    merged = lg.concat_reindex(rg)
    n = len(merged.column_names())
    assigned = merged._derived(
        TableSpec(
            "session_assign",
            [merged],
            {"time_col": 0, "instance_col": 1, "max_gap": window.max_gap},
        ),
        {
            **{c: merged._dtypes[c] for c in merged.column_names()},
            "_pw_window_start": dt.ANY,
            "_pw_window_end": dt.ANY,
        },
    )
    sess = assigned.groupby(assigned["_pw_t"], assigned["_pw_grp"]).reduce(
        _pw_t=assigned["_pw_t"],
        _pw_grp=assigned["_pw_grp"],
        _pw_window_start=_reducers.min(assigned["_pw_window_start"]),
        _pw_window_end=_reducers.min(assigned["_pw_window_end"]),
    )

    def attach(table: Table, t_expr: Any, grp_expr: Any) -> Table:
        base = table.select(
            **{n_: table[n_] for n_ in table.column_names()},
            _pw_t=t_expr,
            _pw_grp=grp_expr,
        )
        joined = base.join(
            sess,
            base["_pw_t"] == sess["_pw_t"],
            base["_pw_grp"] == sess["_pw_grp"],
            id=base.id,
        )
        return joined.select(
            *[base[n_] for n_ in table.column_names()],
            _pw_instance=base["_pw_grp"],
            _pw_window_start=sess["_pw_window_start"],
            _pw_window_end=sess["_pw_window_end"],
        )

    return attach(left, lt, lgrp), attach(right, rt, rgrp)


def window_join(
    left: Table,
    right: Table,
    left_time: Any,
    right_time: Any,
    window: Any,
    *on: Any,
    how: str = "inner",
    left_instance: Any = None,
    right_instance: Any = None,
) -> WindowJoinResult:
    """Join records that fall into the same window (reference:
    _window_join.py:156). Sliding windows join matching pairs once per
    shared window; session windows build sessions over the union of both
    sides."""
    from pathway_tpu_torch.internals.desugaring import resolve_join_sides
    from pathway_tpu_torch.internals.expression import BinaryOpExpression

    if left is right:
        raise ValueError(
            "window self-joins need distinct table objects; derive a copy "
            "first (e.g. right = left.select(*left))"
        )
    on_pairs = []
    for cond in on:
        resolved = resolve_join_sides(cond, left, right)
        if not (
            isinstance(resolved, BinaryOpExpression) and resolved._op == "=="
        ):
            raise ValueError("window_join conditions must be equalities")
        on_pairs.append((resolved._left, resolved._right))
    linst = (
        resolve_side(left_instance, left, "left")
        if left_instance is not None
        else None
    )
    rinst = (
        resolve_side(right_instance, right, "right")
        if right_instance is not None
        else None
    )

    if isinstance(window, SessionWindow):
        la, ra = _session_window_sides(
            left, right, left_time, right_time, window, on_pairs, linst, rinst
        )
        conds = [
            la["_pw_window_start"] == ra["_pw_window_start"],
            la["_pw_window_end"] == ra["_pw_window_end"],
            la["_pw_instance"] == ra["_pw_instance"],
        ]
        return WindowJoinResult(left, right, la, ra, conds, how)

    la = _assign_windows(left, resolve_side(left_time, left, "left"), window, linst)
    ra = _assign_windows(right, resolve_side(right_time, right, "right"), window, rinst)
    conds = [
        la["_pw_window_start"] == ra["_pw_window_start"],
        la["_pw_window_end"] == ra["_pw_window_end"],
        la["_pw_instance"] == ra["_pw_instance"],
    ]
    for lexpr, rexpr in on_pairs:
        conds.append(
            _retarget(lexpr, left, la) == _retarget(rexpr, right, ra)
        )
    return WindowJoinResult(left, right, la, ra, conds, how)


def window_join_inner(left, right, lt, rt, window, *on, **kw):
    return window_join(left, right, lt, rt, window, *on, how="inner", **kw)


def window_join_left(left, right, lt, rt, window, *on, **kw):
    return window_join(left, right, lt, rt, window, *on, how="left", **kw)


def window_join_right(left, right, lt, rt, window, *on, **kw):
    return window_join(left, right, lt, rt, window, *on, how="right", **kw)


def window_join_outer(left, right, lt, rt, window, *on, **kw):
    return window_join(left, right, lt, rt, window, *on, how="outer", **kw)


# -- intervals_over -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IntervalsOverWindow:
    """Windows anchored at each value of ``at`` (a column, possibly of
    another table): [t + lower_bound, t + upper_bound]
    (reference _window.py:771 intervals_over)."""

    at: Any
    lower_bound: Any
    upper_bound: Any
    is_outer: bool = True


def intervals_over(
    *, at: Any, lower_bound: Any, upper_bound: Any, is_outer: bool = True
) -> IntervalsOverWindow:
    return IntervalsOverWindow(at, lower_bound, upper_bound, is_outer)
