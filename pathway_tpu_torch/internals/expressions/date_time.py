"""``expr.dt.*``: the datetime and duration methods of a column expression.

Counterpart of ``pathway_tpu/internals/expressions/date_time.py``. ``to_utc`` and
``to_naive_in_timezone`` read the time-zone database through ``zoneinfo``: a zone it
cannot find raises in the row (an error value), never a wrong time."""

from __future__ import annotations

import datetime
from typing import Any

from pathway_tpu_torch.internals.expression import (
    ApplyExpression,
    ColumnExpression,
    wrap_expression,
)


def _method(fn, ret, *args):
    return ApplyExpression(fn, ret, args, {}, propagate_none=True)


class DateTimeNamespace:
    def __init__(self, expression: ColumnExpression) -> None:
        self._e = expression

    def year(self) -> ColumnExpression:
        return _method(lambda d: d.year, int, self._e)

    def month(self) -> ColumnExpression:
        return _method(lambda d: d.month, int, self._e)

    def day(self) -> ColumnExpression:
        return _method(lambda d: d.day, int, self._e)

    def hour(self) -> ColumnExpression:
        return _method(lambda d: d.hour, int, self._e)

    def minute(self) -> ColumnExpression:
        return _method(lambda d: d.minute, int, self._e)

    def second(self) -> ColumnExpression:
        return _method(lambda d: d.second, int, self._e)

    def microsecond(self) -> ColumnExpression:
        return _method(lambda d: d.microsecond, int, self._e)

    def millisecond(self) -> ColumnExpression:
        return _method(lambda d: d.microsecond // 1000, int, self._e)

    def nanosecond(self) -> ColumnExpression:
        return _method(lambda d: d.microsecond * 1000, int, self._e)

    def weekday(self) -> ColumnExpression:
        return _method(lambda d: d.weekday(), int, self._e)

    def timestamp(self, unit: str = "s") -> ColumnExpression:
        scale = {"ns": 1e9, "us": 1e6, "ms": 1e3, "s": 1.0}[unit]

        def ts(d: datetime.datetime) -> float:
            if d.tzinfo is None:
                d = d.replace(tzinfo=datetime.timezone.utc)
            return d.timestamp() * scale

        return _method(ts, float, self._e)

    def strftime(self, fmt: Any) -> ColumnExpression:
        return _method(lambda d, f: d.strftime(f), str, self._e, wrap_expression(fmt))

    def strptime(self, fmt: Any) -> ColumnExpression:
        return _method(
            lambda s, f: datetime.datetime.strptime(s, f),
            datetime.datetime,
            self._e,
            wrap_expression(fmt),
        )

    def to_utc(self, from_timezone: str) -> ColumnExpression:
        import zoneinfo

        def conv(d: datetime.datetime) -> datetime.datetime:
            tz = zoneinfo.ZoneInfo(from_timezone)
            return d.replace(tzinfo=tz).astimezone(datetime.timezone.utc)

        return _method(conv, datetime.datetime, self._e)

    def to_naive_in_timezone(self, timezone: str) -> ColumnExpression:
        import zoneinfo

        def conv(d: datetime.datetime) -> datetime.datetime:
            tz = zoneinfo.ZoneInfo(timezone)
            return d.astimezone(tz).replace(tzinfo=None)

        return _method(conv, datetime.datetime, self._e)

    def round(self, duration: Any) -> ColumnExpression:
        return _method(_round_dt, datetime.datetime, self._e, wrap_expression(duration))

    def floor(self, duration: Any) -> ColumnExpression:
        return _method(_floor_dt, datetime.datetime, self._e, wrap_expression(duration))

    # duration accessors
    def days(self) -> ColumnExpression:
        return _method(lambda d: d.days, int, self._e)

    def hours(self) -> ColumnExpression:
        return _method(lambda d: int(d.total_seconds() // 3600), int, self._e)

    def minutes(self) -> ColumnExpression:
        return _method(lambda d: int(d.total_seconds() // 60), int, self._e)

    def seconds(self) -> ColumnExpression:
        return _method(lambda d: int(d.total_seconds()), int, self._e)

    def milliseconds(self) -> ColumnExpression:
        return _method(lambda d: int(d.total_seconds() * 1e3), int, self._e)

    def microseconds(self) -> ColumnExpression:
        return _method(lambda d: int(d.total_seconds() * 1e6), int, self._e)

    def nanoseconds(self) -> ColumnExpression:
        return _method(lambda d: int(d.total_seconds() * 1e9), int, self._e)


def _floor_dt(d: datetime.datetime, dur: datetime.timedelta) -> datetime.datetime:
    epoch = datetime.datetime(1970, 1, 1, tzinfo=d.tzinfo)
    delta = (d - epoch).total_seconds()
    step = dur.total_seconds()
    return epoch + datetime.timedelta(seconds=(delta // step) * step)


def _round_dt(d: datetime.datetime, dur: datetime.timedelta) -> datetime.datetime:
    floor = _floor_dt(d, dur)
    if (d - floor) * 2 >= dur:
        return floor + dur
    return floor
