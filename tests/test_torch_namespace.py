"""The port's ``pw`` namespace against the reference's: every name of
``pathway_tpu.__all__``, every connector module of ``pathway_tpu.io`` and every module of
``pathway_tpu.stdlib`` (and ``stdlib.indexing``'s names) is on the port, ported or raising
``NotImplementedError`` naming its ROADMAP item, never ``AttributeError``; the raising
``__getattr__`` shadows no real submodule, and ``from pathway_tpu_torch import *`` takes
only ported names. The small ported names (``schema_builder``, ``schema_from_csv``,
``assert_table_has_schema``, ``unsafe_make_pointer``, ``pw.universes``,
``wrap_py_object``, ``run_all``, the expression constructors) give the reference's
results."""

from __future__ import annotations

import importlib
import importlib.util
import inspect
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu.io as jio
import pathway_tpu.stdlib as jstdlib
import pathway_tpu.stdlib.indexing as jindexing
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch.internals.parse_graph import G as TG

ITEM = re.compile(r"ROADMAP queue 1 item \d+")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the port's names for the reference's (ROADMAP: deliberate differences, names)
RENAMED = {"TpuKnnFactory": "DeviceKnnFactory"}


@pytest.fixture(autouse=True)
def _clear():
    yield
    TG.clear()
    JG.clear()


def _ported_or_names_its_item(module, name: str) -> bool:
    """True where ``module.name`` is ported; asserts that an unported name raises
    ``NotImplementedError`` naming its item and its own name."""
    try:
        getattr(module, RENAMED.get(name, name))
    except NotImplementedError as e:
        assert ITEM.search(str(e)), str(e)
        assert name in str(e), str(e)
        return False
    return True


@pytest.mark.parametrize("name", sorted(jpw.__all__))
def test_every_reference_name_is_ported_or_names_its_item(name):
    if _ported_or_names_its_item(tpw, name):
        assert name in tpw.__all__, f"{name} is ported but not exported"
    else:
        assert name not in tpw.__all__


@pytest.mark.parametrize("name", sorted(jio.__all__))
def test_every_reference_connector_is_ported_or_names_item_15(name):
    if _ported_or_names_its_item(tpw.io, name):
        assert name in tpw.io.__all__, f"{name} is ported but not exported"
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 15"):
            getattr(tpw.io, name)


@pytest.mark.parametrize("name", sorted(jstdlib.__all__))
def test_every_reference_stdlib_module_is_ported_or_names_its_item(name):
    if _ported_or_names_its_item(tpw.stdlib, name):
        assert name in tpw.stdlib.__all__


@pytest.mark.parametrize("name", sorted(jindexing.__all__))
def test_every_reference_indexing_name_is_ported_or_names_its_item(name):
    _ported_or_names_its_item(tpw.stdlib.indexing, name)


#: the port's names for the xpack's (ROADMAP: deliberate differences, names)
XPACK_RENAMED = {"TpuEncoderEmbedder": "EncoderEmbedder", "TpuImageEmbedder": "ImageEmbedder",
                 "TpuPipelineChat": "PipelineChat"}


def _xpack_names() -> list[tuple[str, str]]:
    """(module, name) of every public class and function that each module of
    ``pathway_tpu.xpacks.llm`` defines; (module, "") for a module the port lacks."""
    import pathway_tpu.xpacks.llm as jllm

    out = []
    for info in pkgutil.iter_modules(jllm.__path__):
        if importlib.util.find_spec(f"pathway_tpu_torch.xpacks.llm.{info.name}") is None:
            out.append((info.name, ""))
            continue
        jmod = importlib.import_module(f"pathway_tpu.xpacks.llm.{info.name}")
        for name, obj in sorted(vars(jmod).items()):
            if (not name.startswith("_") and (inspect.isclass(obj) or inspect.isfunction(obj))
                    and obj.__module__ == jmod.__name__):
                out.append((info.name, name))
    return out


@pytest.mark.parametrize("module,name", _xpack_names())
def test_every_xpack_name_is_ported_or_names_its_item(module, name):
    import pathway_tpu_torch.xpacks.llm as tllm

    if not name:
        # a module of the reference the port lacks: the package's attribute raises
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
            getattr(tllm, module)
        return
    tmod = importlib.import_module(f"pathway_tpu_torch.xpacks.llm.{module}")
    try:
        getattr(tmod, XPACK_RENAMED.get(name, name))
    except NotImplementedError as e:
        assert ITEM.search(str(e)) and name in str(e), str(e)
    assert not hasattr(tmod, "no_such_name")


def test_the_remote_embedders_and_the_servers_name_item_8():
    """Item 8's serving slice ported these names: the remote embedders and every
    class of ``servers`` import under the reference's names, and none raises."""
    import pathway_tpu.xpacks.llm.embedders as jemb
    import pathway_tpu.xpacks.llm.servers as jservers
    import pathway_tpu_torch.xpacks.llm.embedders as temb
    import pathway_tpu_torch.xpacks.llm.servers as tservers

    for name in ("OpenAIEmbedder", "LiteLLMEmbedder", "GeminiEmbedder"):
        ours, theirs = getattr(temb, name), getattr(jemb, name)
        assert issubclass(ours, tpw.UDF)
        with pytest.raises(ValueError, match="needs an async `client`"):
            ours()
        with pytest.raises(ValueError, match="needs an async `client`"):
            theirs()
    for name in ("ServerHandle", "BaseRestServer", "DocumentStoreServer", "QARestServer",
                 "QASummaryRestServer"):
        assert getattr(tservers, name).__name__ == getattr(jservers, name).__name__
    import pathway_tpu_torch.xpacks.llm as x

    assert x.servers is tservers


def test_the_names_reference_programs_call_first():
    assert tpw.stdlib.indexing.USearchKnnFactory is tpw.stdlib.indexing.BruteForceKnnFactory
    assert tpw.stdlib.indexing.nearest_neighbors.USearchKnnFactory is \
        tpw.stdlib.indexing.BruteForceKnnFactory
    assert isinstance(tpw.udfs.DiskCache(), tpw.udfs.CacheStrategy)
    assert tpw.debug.unsafe_make_pointer is tpw.unsafe_make_pointer
    for module in (tpw, tpw.io, tpw.stdlib, tpw.stdlib.indexing):
        assert not hasattr(module, "no_such_name")  # AttributeError, not the item's error
        assert getattr(module, "__wrapped__", None) is None


def test_star_import_takes_only_ported_names():
    scope: dict = {}
    exec("from pathway_tpu_torch import *", scope)
    assert {n for n in scope if not n.startswith("__")} == set(tpw.__all__)


def test_getattr_shadows_no_submodule_on_first_import():
    code = (
        "from pathway_tpu_torch.io import python\n"
        "from pathway_tpu_torch.stdlib import indexing, stateful\n"
        "import pathway_tpu_torch as pw\n"
        "assert pw.io.python is python and pw.stdlib.indexing is indexing\n"
        "assert pw.stdlib.stateful.deduplicate\n"
        "from pathway_tpu_torch.io import csv\n"
        "assert pw.io.csv is csv and pw.persistence.Config\n"
        "from pathway_tpu_torch.io import postgres\n"
        "assert pw.io.postgres is postgres and pw.io.CONNECTORS == ()\n"
        "try:\n"
        "    from pathway_tpu_torch import sql\n"
        "except NotImplementedError as e:\n"
        "    assert 'item 8' in str(e)\n"
        "else:\n"
        "    raise AssertionError('pw.sql imported')\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=REPO, timeout=120)


def _both(program):
    """``program(pw)`` through ``pw.debug.table_to_dicts`` in both packages -> (ours,
    theirs), each (column names, {int(id): row}) with floats as their bits."""

    def canon(v):
        if type(v).__name__ == "Error":
            return "ERROR"
        if isinstance(v, float):
            return ("f", np.float64(v).view(np.int64).item())
        if isinstance(v, tuple):
            return tuple(canon(x) for x in v)
        return v

    out = []
    for pw in (tpw, jpw):
        data, names = pw.debug.table_to_dicts(program(pw))
        out.append((names, {int(k): {c: canon(x) for c, x in r.items()} for k, r in data.items()}))
    return out


def _rows(pw):
    return pw.debug.table_from_rows(
        pw.schema_from_types(k=int, s=str, v=float),
        [(1, "Ab", 1.5), (None, "cd", None), (3, None, -2.25), (4, "e", 0.5)],
    )


CONSTRUCTORS = {
    "coalesce": lambda pw, t: t.select(c=pw.coalesce(t.k, 0), d=pw.coalesce(t.s, t.k, "z")),
    "if_else": lambda pw, t: t.select(x=pw.if_else(t.v > 0, t.s, "neg")),
    "require": lambda pw, t: t.select(x=pw.require(t.v, t.k)),
    "cast": lambda pw, t: t.select(x=pw.cast(float, t.k)),
    "declare_type": lambda pw, t: t.select(x=pw.declare_type(int, t.k)),
    "unwrap": lambda pw, t: t.filter(t.k.is_not_none()).select(x=pw.unwrap(t.k)),
    "fill_error": lambda pw, t: t.select(x=pw.fill_error(t.v / (t.v - 0.5), -1.0)),
    "apply_with_type": lambda pw, t: t.select(x=pw.apply_with_type(lambda a: 2 * a, int, t.k)),
    "str_upper": lambda pw, t: t.select(x=t.s.str.upper()),
    "wrap_py_object": lambda pw, t: t.select(x=pw.apply(lambda a: str(pw.wrap_py_object(a)), t.s)),
    "unsafe_make_pointer": lambda pw, t: t.select(
        x=pw.apply(lambda a: int(pw.unsafe_make_pointer(a)) + 1 if a is not None else None, t.k)
    ),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_expression_constructors_match_the_reference(name):
    ours, theirs = _both(lambda pw: CONSTRUCTORS[name](pw, _rows(pw)))
    assert ours == theirs


def test_universe_promises_match_the_reference():
    got = []
    for pw in (tpw, jpw):
        a = pw.debug.table_from_rows(pw.schema_from_types(x=int), [(1,), (2,)])
        b = a.filter(a.x > 1).select(y=pw.this.x * 10)
        c = a.filter(a.x > 0)
        pw.universes.promise_is_subset_of(b, c)
        pw.universes.promise_are_equal(a, c)
        sel = b.select(both=b.y + c.restrict(b).x)
        data, names = pw.debug.table_to_dicts(sel)
        got.append((names, {int(k): r for k, r in data.items()}))
    assert got[0] == got[1]


def test_schema_builder_and_assertion_match_the_reference():
    for pw in (tpw, jpw):
        s = pw.schema_builder(
            {"a": pw.column_definition(dtype=int, primary_key=True),
             "b": pw.column_definition(dtype=str, default_value="x")},
            name="Built",
        )
        assert s.column_names() == ["a", "b"] and s.primary_key_columns() == ["a"]
        t = pw.debug.table_from_rows(pw.schema_from_types(a=int, b=str), [(1, "q")])
        pw.assert_table_has_schema(t, s)
        pw.assert_table_has_schema(t.with_columns(c=1), s, allow_superset=True)
        with pytest.raises(AssertionError, match="column sets differ"):
            pw.assert_table_has_schema(t.with_columns(c=1), s)
        with pytest.raises(AssertionError, match="primary keys differ"):
            pw.assert_table_has_schema(t, s, ignore_primary_keys=False)
        with pytest.raises(AssertionError, match="'b'"):
            pw.assert_table_has_schema(t.select(a=t.a, b=t.a), s)


@pytest.mark.parametrize("num_parsed_rows", [None, 1, 30])
def test_schema_from_csv_matches_the_reference(tmp_path, num_parsed_rows):
    path = tmp_path / "t.csv"
    path.write_text('i,f,s,mix,e\n1,2.5,x,3,\n2,3,"y,z",4.5,\n-3,1e3,,word,\n')
    got = []
    for pw in (tpw, jpw):
        s = pw.schema_from_csv(str(path), num_parsed_rows=num_parsed_rows)
        got.append((s.column_names(), [repr(d) for d in s.dtypes().values()]))
    assert got[0] == got[1]
    (tmp_path / "dup.csv").write_text("a,a\n1,2\n")
    for pw in (tpw, jpw):
        with pytest.raises(ValueError, match="duplicate column names"):
            pw.schema_from_csv(str(tmp_path / "dup.csv"))


def test_run_all_runs_the_sinks():
    seen = []
    t = tpw.debug.table_from_rows(tpw.schema_from_types(x=int), [(1,), (2,)])
    tpw.io.subscribe(t, on_change=lambda key, row, time, is_addition: seen.append(row["x"]))
    tpw.run_all()
    assert sorted(seen) == [1, 2]
