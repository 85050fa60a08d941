"""The expression namespaces of the port (``pathway_tpu_torch/internals/expressions``:
``.str``, ``.dt``, ``.num``) against the JAX package's, every method, through
``pw.debug.table_to_dicts``: the same seeded rows (with ``None`` and error values in
every column) through both packages; ids and results must be equal, floats as their
bits, error values as errors."""

from __future__ import annotations

import datetime
import zoneinfo

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch.internals.parse_graph import G as TG

UTC = datetime.timezone.utc


@pytest.fixture(autouse=True)
def _clear():
    yield
    TG.clear()
    JG.clear()


def _canon(v):
    if type(v).__name__ == "Error":
        return "ERROR"
    if isinstance(v, float):
        return ("f", np.float64(v).view(np.int64).item())
    if isinstance(v, tuple):
        return tuple(_canon(x) for x in v)
    return v


def _rows() -> list[tuple]:
    """Seeded rows of (s, n, f, d, u, td): a string, an int, a float, a naive datetime,
    a UTC datetime and a duration; row 0 is all ``None``, row 1 becomes an error value in
    every column (``_poisoned``), the rest are drawn from a seed."""
    rng = np.random.default_rng(11)
    words = ["  Hello World ", "abc", "x,y,,z", "42", "-7", "3.25", "true", "Off", "",
             "MiXeD cAsE", "2024-03-05T06:07:08", "nan", "a-b-c-a"]
    rows: list[tuple] = [(None,) * 6, ("BOOM",) + (None,) * 5]
    epoch = datetime.datetime(2024, 1, 1)
    for i in range(14):
        secs = int(rng.integers(-10**8, 10**8))
        micros = int(rng.integers(0, 10**6))
        d = epoch + datetime.timedelta(seconds=secs, microseconds=micros)
        f = float(rng.normal() * 10 ** int(rng.integers(-3, 4)))
        if i == 3:
            f = float("nan")
        rows.append((
            words[i % len(words)], int(rng.integers(-1000, 1000)), f, d,
            d.replace(tzinfo=UTC),
            datetime.timedelta(seconds=int(rng.integers(-10**6, 10**6)), microseconds=micros),
        ))
    return rows


def _poisoned(s, v):
    """``v``, or an error where the row's string is ``BOOM``."""
    if s == "BOOM":
        raise ValueError("boom")
    return v


def _table(pw):
    raw = pw.debug.table_from_rows(
        pw.schema_from_types(s=str, n=int, f=float, d=datetime.datetime,
                             u=datetime.datetime, td=datetime.timedelta),
        _rows(),
    )
    return raw.select(**{c: pw.apply(_poisoned, raw.s, raw[c]) for c in raw.column_names()})


STRING = {
    "lower": lambda t: t.s.str.lower(),
    "upper": lambda t: t.s.str.upper(),
    "reversed": lambda t: t.s.str.reversed(),
    "len": lambda t: t.s.str.len(),
    "strip": lambda t: t.s.str.strip(),
    "strip_chars": lambda t: t.s.str.strip(" a"),
    "lstrip": lambda t: t.s.str.lstrip(),
    "lstrip_chars": lambda t: t.s.str.lstrip("-a"),
    "rstrip": lambda t: t.s.str.rstrip(),
    "rstrip_chars": lambda t: t.s.str.rstrip("a "),
    "startswith": lambda t: t.s.str.startswith("a"),
    "endswith": lambda t: t.s.str.endswith("a"),
    "swapcase": lambda t: t.s.str.swapcase(),
    "title": lambda t: t.s.str.title(),
    "count": lambda t: t.s.str.count("a"),
    "count_start": lambda t: t.s.str.count("a", 1),
    "count_start_end": lambda t: t.s.str.count("a", 1, 5),
    "count_end": lambda t: t.s.str.count("a", end=3),
    "find": lambda t: t.s.str.find("b"),
    "find_start_end": lambda t: t.s.str.find("a", 2, 9),
    "rfind": lambda t: t.s.str.rfind("a"),
    "rfind_start": lambda t: t.s.str.rfind("a", 1),
    "replace": lambda t: t.s.str.replace("a", "_"),
    "replace_count": lambda t: t.s.str.replace("a", "AA", 1),
    "split": lambda t: t.s.str.split(),
    "split_sep": lambda t: t.s.str.split(","),
    "split_maxsplit": lambda t: t.s.str.split("-", 1),
    "split_whitespace_maxsplit": lambda t: t.s.str.split(None, 1),
    "slice": lambda t: t.s.str.slice(1, 4),
    "parse_int": lambda t: t.s.str.parse_int(),
    "parse_int_optional": lambda t: t.s.str.parse_int(optional=True),
    "parse_float": lambda t: t.s.str.parse_float(),
    "parse_float_optional": lambda t: t.s.str.parse_float(optional=True),
    "parse_bool": lambda t: t.s.str.parse_bool(),
    "parse_bool_optional": lambda t: t.s.str.parse_bool(optional=True),
    "to_datetime": lambda t: t.s.str.to_datetime(),
    "to_datetime_fmt": lambda t: t.s.str.to_datetime("%Y-%m-%dT%H:%M:%S"),
    "strip_of_column": lambda t: t.s.str.strip(t.s.str.slice(0, 1)),
}

DATE_TIME = {
    **{m: (lambda m: lambda t: getattr(t.d.dt, m)())(m) for m in (
        "year", "month", "day", "hour", "minute", "second", "microsecond", "millisecond",
        "nanosecond", "weekday",
    )},
    **{f"timestamp_{u}": (lambda u: lambda t: t.d.dt.timestamp(u))(u) for u in ("ns", "us", "ms", "s")},
    "timestamp_utc": lambda t: t.u.dt.timestamp(),
    "strftime": lambda t: t.d.dt.strftime("%Y/%j %H:%M:%S.%f"),
    "strptime": lambda t: t.d.dt.strftime("%Y-%m-%d %H").dt.strptime("%Y-%m-%d %H"),
    "round_hour": lambda t: t.d.dt.round(datetime.timedelta(hours=1)),
    "round_7s": lambda t: t.d.dt.round(datetime.timedelta(seconds=7)),
    "floor_minute": lambda t: t.d.dt.floor(datetime.timedelta(minutes=1)),
    "floor_day_utc": lambda t: t.u.dt.floor(datetime.timedelta(days=1)),
    "floor_3ms": lambda t: t.d.dt.floor(datetime.timedelta(milliseconds=3)),
    **{f"duration_{m}": (lambda m: lambda t: getattr(t.td.dt, m)())(m) for m in (
        "days", "hours", "minutes", "seconds", "milliseconds", "microseconds", "nanoseconds",
    )},
    # fixed-offset zones (no daylight-saving rules)
    "to_utc_UTC": lambda t: t.d.dt.to_utc("UTC"),
    "to_utc_gmt_minus_5": lambda t: t.d.dt.to_utc("Etc/GMT-5"),
    "to_naive_in_timezone_UTC": lambda t: t.u.dt.to_naive_in_timezone("UTC"),
    "to_naive_in_timezone_gmt_plus_3": lambda t: t.u.dt.to_naive_in_timezone("Etc/GMT+3"),
    "to_utc_unknown_zone": lambda t: t.d.dt.to_utc("No/Such_Zone"),
}

NUMERICAL = {
    "abs_int": lambda t: t.n.num.abs(),
    "abs_float": lambda t: t.f.num.abs(),
    "round": lambda t: t.f.num.round(),
    "round_2": lambda t: t.f.num.round(2),
    "round_int_minus_1": lambda t: t.n.num.round(-1),
    "round_by_column": lambda t: t.f.num.round(t.n % 3),
    "fill_na_float": lambda t: t.f.num.fill_na(-1.5),
    "fill_na_int": lambda t: t.n.num.fill_na(0),
}

METHODS = {
    **{f"str.{k}": v for k, v in STRING.items()},
    **{f"dt.{k}": v for k, v in DATE_TIME.items()},
    **{f"num.{k}": v for k, v in NUMERICAL.items()},
}


def _run(pw, method):
    t = _table(pw)
    data, names = pw.debug.table_to_dicts(t.select(x=method(t)))
    return names, {int(k): _canon(r["x"]) for k, r in data.items()}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_namespace_method_matches_the_reference(name):
    ours = _run(tpw, METHODS[name])
    theirs = _run(jpw, METHODS[name])
    assert ours == theirs
    values = list(ours[1].values())
    assert len(values) == len(_rows())
    assert "ERROR" in values  # the poisoned row
    if name != "dt.to_utc_unknown_zone":
        assert any(v not in (None, "ERROR") for v in values)


def test_every_reference_method_is_covered():
    from pathway_tpu.internals.expressions.date_time import DateTimeNamespace
    from pathway_tpu.internals.expressions.numerical import NumericalNamespace
    from pathway_tpu.internals.expressions.string import StringNamespace

    for prefix, cls in (("str", StringNamespace), ("dt", DateTimeNamespace),
                        ("num", NumericalNamespace)):
        public = {n for n in dir(cls) if not n.startswith("_")}
        covered = {k.split(".", 1)[1] for k in METHODS if k.startswith(prefix + ".")}
        for n in public:
            assert any(c == n or c.startswith(n + "_") or c.startswith(f"duration_{n}")
                       for c in covered), f"{prefix}.{n} is not tested"
        ours = getattr(tpw.this.x, prefix).__class__
        assert public == {n for n in dir(ours) if not n.startswith("_")}


def test_none_in_the_optional_argument_does_not_blank_the_row():
    """``strip(chars=None)``, ``count`` without bounds and ``split(None)`` must not pass
    a literal ``None`` through the None-propagating apply."""
    for pw in (tpw, jpw):
        t = pw.debug.table_from_rows(pw.schema_from_types(s=str), [(" a b ",)])
        data, _ = pw.debug.table_to_dicts(t.select(
            a=t.s.str.strip(None), b=t.s.str.count("a"), c=t.s.str.split(None),
            d=t.s.str.to_datetime(None).is_none(),
        ))
        (row,) = data.values()
        assert (row["a"], row["b"], row["c"]) == ("a b", 1, ("a", "b"))


def test_named_zone_with_daylight_saving_matches_the_reference():
    try:
        zoneinfo.ZoneInfo("Europe/Warsaw")
    except zoneinfo.ZoneInfoNotFoundError:
        pytest.skip("the time-zone database here has no Europe/Warsaw")
    for method in (lambda t: t.d.dt.to_utc("Europe/Warsaw"),
                   lambda t: t.u.dt.to_naive_in_timezone("Europe/Warsaw")):
        ours, theirs = _run(tpw, method), _run(jpw, method)
        assert ours == theirs
        assert sum(isinstance(v, datetime.datetime) for v in ours[1].values()) == 14
