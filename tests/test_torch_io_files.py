"""The port's file connectors (``pw.io.fs``, ``csv``, ``jsonlines``, ``plaintext``,
``null``) against the JAX package's on the same files: the sinks' files line for line
(times and diffs included), captured tables by ``int(key)`` and value; static and
streaming reads, a changed file retracting its old rows and a deleted one all of its
rows; metadata columns, the upsert session, and a file sink resumed under one
``PATHWAY_RUN_ID``. The single-worker cases of ``tests/test_io.py`` and
``tests/test_io_roundtrips.py``."""

from __future__ import annotations

import json
import os
import time

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch.engine import device_ops as dops
from pathway_tpu_torch.internals.parse_graph import G as TG

PACKAGES = {"torch": tpw, "jax": jpw}


@pytest.fixture(autouse=True)
def _cpu_operators():
    """The CPU's device operators, an empty graph in both packages, and both packages'
    UDF cache roots as they were (a persistent run routes them under its store)."""
    from pathway_tpu.internals.udfs import caches as jcaches
    from pathway_tpu_torch.internals.udfs import caches as tcaches

    roots = (jcaches._udf_cache_root, tcaches._udf_cache_root)
    dops.configure(device="cpu")
    TG.clear()
    JG.clear()
    yield
    TG.clear()
    JG.clear()
    dops.configure()
    jcaches.set_udf_cache_root(roots[0])
    tcaches.set_udf_cache_root(roots[1])


def _runner(pw):
    if pw is tpw:
        from pathway_tpu_torch.internals.runner import GraphRunner
    else:
        from pathway_tpu.internals.runner import GraphRunner
    return GraphRunner()


def _capture(pw, table) -> dict:
    (snap,) = _runner(pw).capture(table)
    return {int(k): tuple(v) for k, v in snap.items()}


def _both_files(tmp_path, program) -> list[str]:
    """``program(pw, out_dir)`` through both packages -> the port's and the JAX
    package's files' texts (each in its own directory); asserts they are equal."""
    texts = []
    for name, pw in PACKAGES.items():
        out = tmp_path / f"out-{name}"
        out.mkdir()
        program(pw, out)
        texts.append({p: (out / p).read_text() for p in sorted(os.listdir(out))})
    assert texts[0] == texts[1]
    return texts[0]


# -- tests/test_io.py --------------------------------------------------------


def test_csv_roundtrip(tmp_path):
    src = tmp_path / "in.csv"
    src.write_text("name,age\nAlice,10\nBob,9\n")

    def program(pw, out):
        S = pw.schema_from_types(name=str, age=int)
        t = pw.io.csv.read(src, schema=S, mode="static")
        pw.io.csv.write(t.select(pw.this.name, older=pw.this.age + 1), out / "out.csv")
        pw.run()

    text = _both_files(tmp_path, program)["out.csv"]
    lines = text.strip().splitlines()
    assert lines[0] == "name,older,time,diff"
    assert {ln.split(",")[0]: ln.split(",")[1] for ln in lines[1:]} == {"Alice": "11", "Bob": "10"}


def test_jsonlines_roundtrip(tmp_path):
    src = tmp_path / "in.jsonl"
    src.write_text('{"word": "a", "n": 1}\n{"word": "b", "n": 2}\n')

    def program(pw, out):
        t = pw.io.jsonlines.read(src, schema=pw.schema_from_types(word=str, n=int), mode="static")
        pw.io.jsonlines.write(t, out / "out.jsonl")
        pw.run()

    objs = [json.loads(ln) for ln in _both_files(tmp_path, program)["out.jsonl"].splitlines()]
    assert {o["word"]: o["n"] for o in objs} == {"a": 1, "b": 2}
    assert all(o["diff"] == 1 for o in objs)


@pytest.mark.parametrize("fmt", ["plaintext", "plaintext_by_file", "binary"])
def test_plaintext_and_binary_reads(tmp_path, fmt):
    src = tmp_path / "in"
    src.mkdir()
    (src / "a.txt").write_text("hello\nworld\n\n")
    (src / "b.txt").write_text("again\n")
    got = []
    for pw in PACKAGES.values():
        if fmt == "plaintext":
            t = pw.io.plaintext.read(src, mode="static")
        else:
            t = pw.io.fs.read(src, format=fmt, mode="static")
        got.append(_capture(pw, t))
    assert got[0] == got[1]
    if fmt == "plaintext":
        assert sorted(r[0] for r in got[0].values()) == ["again", "hello", "world"]
    else:
        assert len(got[0]) == 2


def test_primary_key_from_schema(tmp_path):
    src = tmp_path / "in.csv"
    src.write_text("k,v\nx,1\ny,2\n")
    got = []
    for pw in PACKAGES.values():

        class S(pw.Schema):
            k: str = pw.column_definition(primary_key=True)
            v: int

        got.append(_capture(pw, pw.io.csv.read(src, schema=S, mode="static")))
    assert got[0] == got[1]
    assert set(got[0]) == {int(tpw.ref_scalar("x")), int(tpw.ref_scalar("y"))}


def test_fs_streaming_file_changes_and_deletions(tmp_path):
    """Streaming mode, one poll and commit a step in both packages in lockstep: a new
    file inserts, a second file inserts, a changed file retracts its old rows before
    its new ones, a deleted file retracts all of its rows. The subscribers' update
    logs (key, row, time, diff) are equal."""
    data = tmp_path / "data"
    data.mkdir()
    (data / "a.txt").write_text("one\n")
    logs = {}
    runs = {}
    for name, pw in PACKAGES.items():
        t = pw.io.plaintext.read(data, mode="streaming", with_metadata=False)
        log = logs[name] = []
        runner = _runner(pw)
        node = runner.build(t)
        runner.scope.subscribe_table(
            node, on_change=lambda k, v, tm, d, log=log: log.append((int(k), v, tm, d))
        )
        sched_mod = (
            __import__("pathway_tpu_torch.engine.graph", fromlist=["Scheduler"])
            if pw is tpw
            else __import__("pathway_tpu.engine.graph", fromlist=["Scheduler"])
        )
        runs[name] = (runner, sched_mod.Scheduler(runner.scope))

    def step():
        for runner, sched in runs.values():
            for d in runner.drivers:
                d.poll()
            sched.commit()

    step()
    (data / "b.txt").write_text("two\nthree\n")
    step()
    (data / "a.txt").write_text("uno\n")
    later = time.time() + 5
    os.utime(data / "a.txt", (later, later))
    step()
    (data / "b.txt").unlink()
    step()
    assert logs["torch"] == logs["jax"]
    assert [(v[0], t, d) for _k, v, t, d in logs["torch"]] == [
        ("one", 0, 1), ("two", 1, 1), ("three", 1, 1), ("one", 2, -1), ("uno", 2, 1),
        ("two", 3, -1), ("three", 3, -1),
    ]


def test_with_metadata_column(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    (data / "a.jsonl").write_text('{"w": "x"}\n{"w": "y"}\n')
    got = []
    for pw in PACKAGES.values():
        t = pw.io.jsonlines.read(
            data, schema=pw.schema_from_types(w=str), mode="static", with_metadata=True
        )
        assert t.column_names() == ["w", "_metadata"]
        got.append({k: (r[0], r[1].value) for k, r in _capture(pw, t).items()})
    assert got[0] == got[1]
    assert {m["path"] for _w, m in got[0].values()} == {str(data / "a.jsonl")}


def test_csv_settings_delimiter_and_null_writer(tmp_path):
    src = tmp_path / "in.csv"
    src.write_text("a;b\n1;x\n2;y\n")
    got = []
    for pw in PACKAGES.values():
        t = pw.io.csv.read(
            src, schema=pw.schema_from_types(a=int, b=str), mode="static",
            csv_settings=pw.io.csv.CsvParserSettings(delimiter=";"),
        )
        got.append(_capture(pw, t))
        seen = []
        pw.io.null.write(t)
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: seen.append(row["a"]))
        pw.run()
        assert sorted(seen) == [1, 2]
    assert got[0] == got[1]
    assert sorted(got[0].values()) == [(1, "x"), (2, "y")]


# -- tests/test_io_roundtrips.py ------------------------------------------------

ROWS_TYPED = [
    (0, 0.0, True, "plain"),
    (-(2**31), -1.5, False, "unicode-éß漢字"),
    (2**40, 3.141592653589793, True, "comma, and 'quote'"),
    (7, -0.0, False, ""),
    (42, 1e-300, True, 'double"quote'),
]


@pytest.mark.parametrize("fmt", ["csv", "jsonlines"])
def test_typed_round_trip(tmp_path, fmt):
    def program(pw, out):
        schema = pw.schema_from_types(i=int, f=float, b=bool, s=str)
        getattr(pw.io, fmt).write(pw.debug.table_from_rows(schema, ROWS_TYPED), out / "t")
        pw.run()

    _both_files(tmp_path, program)
    got = []
    for pw in PACKAGES.values():
        schema = pw.schema_from_types(i=int, f=float, b=bool, s=str)
        back = getattr(pw.io, fmt).read(tmp_path / "out-torch" / "t", schema=schema, mode="static")
        got.append(_capture(pw, back))
    assert got[0] == got[1]
    norm = lambda rows: sorted((int(i), float(f) + 0.0, bool(b), str(s)) for i, f, b, s in rows)  # noqa: E731
    assert norm(got[0].values()) == norm(ROWS_TYPED)


def test_plaintext_preserves_lines(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    lines = ["first line", "tabs\tstay", "spaces  stay", "final"]
    (src / "a.txt").write_text("\n".join(lines) + "\n")

    def program(pw, out):
        pw.io.jsonlines.write(pw.io.plaintext.read(src, mode="static"), out / "o.jsonl")
        pw.run()

    text = _both_files(tmp_path, program)["o.jsonl"]
    assert sorted(json.loads(ln)["data"] for ln in text.splitlines()) == sorted(lines)


def test_csv_null_cells_round_trip(tmp_path):
    src = tmp_path / "in.csv"
    src.write_text("a,b\n1,x\n2,\n")
    got = [
        _capture(pw, pw.io.csv.read(src, schema=pw.schema_from_types(a=int, b=str), mode="static"))
        for pw in PACKAGES.values()
    ]
    assert got[0] == got[1]
    by_a = {a: b for a, b in got[0].values()}
    assert by_a[1] == "x" and by_a[2] in ("", None)


def test_jsonlines_nested_json_column(tmp_path):
    src = tmp_path / "in.jsonl"
    rows = [
        {"k": 1, "payload": {"tags": ["a", "b"], "depth": {"x": 1}}},
        {"k": 2, "payload": {"tags": [], "depth": {"x": 2}}},
    ]
    src.write_text("\n".join(json.dumps(r) for r in rows) + "\n")

    def program(pw, out):
        t = pw.io.jsonlines.read(src, schema=pw.schema_from_types(k=int, payload=dict), mode="static")
        pw.io.jsonlines.write(t, out / "o.jsonl")
        pw.run()

    text = _both_files(tmp_path, program)["o.jsonl"]
    got = sorted((json.loads(ln)["k"], json.loads(ln)["payload"]) for ln in text.splitlines())
    assert got == sorted((r["k"], r["payload"]) for r in rows)


def test_csv_update_log_carries_diffs(tmp_path):
    """An update stream through the csv sink: the retraction of the replaced group row
    is in the log, and the log's final state is the same in both packages."""
    finals = []
    for name, pw in PACKAGES.items():

        class Feed(pw.io.python.ConnectorSubject):
            def run(self):
                self.next(k=1, v=10)
                self.next(k=2, v=20)
                self.commit()
                time.sleep(0.3)  # the first rows commit on their own
                self.next(k=1, v=11)
                self.commit()

        t = pw.io.python.read(Feed(), schema=pw.schema_from_types(k=int, v=int),
                              autocommit_duration_ms=None)
        g = t.groupby(pw.this.k).reduce(k=pw.this.k, latest=pw.reducers.max(pw.this.v))
        out = tmp_path / f"{name}.csv"
        pw.io.csv.write(g, out)
        pw.run()
        rows = out.read_text().splitlines()
        header = rows[0].split(",")
        assert "diff" in header and "time" in header
        parsed = [dict(zip(header, r.split(","))) for r in rows[1:]]
        assert any(int(p["diff"]) < 0 for p in parsed if p["k"] == "1"), "retraction missing"
        state = {}
        for p in parsed:
            if int(p["diff"]) > 0:
                state[p["k"]] = p["latest"]
            elif state.get(p["k"]) == p["latest"]:
                del state[p["k"]]
        finals.append(state)
    assert finals[0] == finals[1] == {"1": "11", "2": "20"}


@pytest.mark.parametrize("fmt", ["csv", "jsonlines", "plaintext"])
def test_resume_emits_only_delta(tmp_path, fmt):
    """Journal persistence resumes every file connector without double counting; both
    packages write the same sink files on the first run and on the resumed one."""

    def write_file(indir, name, values):
        if fmt == "csv":
            (indir / name).write_text("w\n" + "\n".join(values) + "\n")
        elif fmt == "jsonlines":
            (indir / name).write_text("\n".join(json.dumps({"w": v}) for v in values) + "\n")
        else:
            (indir / name).write_text("\n".join(values) + "\n")

    indir = tmp_path / "in"
    indir.mkdir()
    write_file(indir, "a", ["apple", "banana", "apple"])
    outs = {}
    for step in (1, 2):
        if step == 2:
            write_file(indir, "b", ["banana", "cherry"])
        for name, pw in PACKAGES.items():
            from importlib import import_module

            pers = import_module(pw.__name__ + ".persistence")
            if fmt == "plaintext":
                words = pw.io.plaintext.read(indir, mode="static", persistent_id="w")
                col = words.data
            else:
                words = getattr(pw.io, fmt).read(
                    indir, schema=pw.schema_from_types(w=str), mode="static", persistent_id="w"
                )
                col = words.w
            counts = words.groupby(col).reduce(word=col, cnt=pw.reducers.count())
            out = tmp_path / f"{name}-{step}.jsonl"
            pw.io.jsonlines.write(counts, out)
            pw.run(persistence_config=pers.Config(
                pers.Backend.filesystem(str(tmp_path / f"store-{name}")),
                persistence_mode=pers.PersistenceMode.PERSISTING,
            ))
            outs[(name, step)] = out.read_text()
        assert outs[("torch", step)] == outs[("jax", step)]
    finals = {}
    for line in outs[("torch", 2)].splitlines():
        r = json.loads(line)
        if r["diff"] > 0:
            finals[r["word"]] = r["cnt"]
        elif finals.get(r["word"]) == r["cnt"]:
            del finals[r["word"]]
    assert finals == {"apple": 2, "banana": 2, "cherry": 1}


# -- the engine's seams -------------------------------------------------------


def test_upsert_session_through_the_driver():
    """A parser of UPSERT events with explicit keys feeds an upsert session: an
    insert replaces the key's row, a None deletes it; the same events give the same
    commits in both packages."""
    from pathway_tpu.engine import connectors as jc
    from pathway_tpu.engine.graph import Scheduler as JScheduler
    from pathway_tpu.engine.graph import Scope as JScope
    from pathway_tpu_torch.engine import connectors as tc
    from pathway_tpu_torch.engine.graph import Scheduler as TScheduler
    from pathway_tpu_torch.engine.graph import Scope as TScope

    batches = [
        [("a", 1), ("b", 2)],
        [("a", 3), ("b", None)],
        [("c", 4), ("a", None)],
    ]
    logs = []
    for conn, Scope, Scheduler in ((tc, TScope, TScheduler), (jc, JScope, JScheduler)):

        class Upserts(conn.Parser):
            session_type = "upsert"

            def parse(self, payload):
                return [
                    conn.ParsedEvent(conn.UPSERT, None if v is None else (k, v), key=(k,))
                    for k, v in payload
                ]

        scope = Scope()
        session = scope.input_session(2, upsert=True)
        log = []
        scope.subscribe_table(session, on_change=lambda k, v, t, d, log=log: log.append((int(k), v, t, d)))
        reader = conn.QueueReader()
        driver = conn.InputDriver(session, reader, Upserts(["k", "v"]))
        sched = Scheduler(scope)
        for batch in batches:
            reader.push(batch)
            driver.poll()
            sched.commit()
        logs.append(log)
    assert logs[0] == logs[1]
    assert [(v, t, d) for _k, v, t, d in logs[0]] == [
        (("a", 1), 0, 1), (("b", 2), 0, 1), (("a", 1), 1, -1), (("a", 3), 1, 1),
        (("b", 2), 1, -1), (("c", 4), 2, 1), (("a", 3), 2, -1),
    ]


def test_file_writer_resumes_under_its_run_id(tmp_path, monkeypatch):
    """Under one ``PATHWAY_RUN_ID`` a relaunched writer keeps the lines of durable
    commits and drops a torn tail; another run id starts the file anew. Both packages
    leave the same bytes."""
    from pathway_tpu.engine import connectors as jc
    from pathway_tpu_torch.engine import connectors as tc

    texts = []
    for conn in (tc, jc):
        path = tmp_path / f"{conn.__name__.split('.')[0]}.jsonl"
        monkeypatch.setenv("PATHWAY_RUN_ID", "run-1")
        w = conn.FileWriter(path, conn.JsonLinesFormatter(), ["x"])
        w.on_change(tpw.ref_scalar(1), (1,), 2, 1)
        w.on_time_end(2)
        w.on_change(tpw.ref_scalar(2), (2,), 3, 1)
        w._file.flush()  # commit 3 never becomes durable: a crash here
        w2 = conn.FileWriter(path, conn.JsonLinesFormatter(), ["x"])
        w2.on_change(tpw.ref_scalar(3), (3,), 3, 1)
        w2.on_time_end(3)
        w2.on_end()
        resumed = path.read_text()
        monkeypatch.setenv("PATHWAY_RUN_ID", "run-2")
        w3 = conn.FileWriter(path, conn.JsonLinesFormatter(), ["x"])
        w3.on_end()
        texts.append((resumed, path.read_text()))
    assert texts[0] == texts[1]
    resumed, fresh = texts[0]
    assert [json.loads(ln)["x"] for ln in resumed.splitlines()] == [1, 3]
    assert fresh == ""
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 14"):
        tc.FileWriter(tmp_path / "r.jsonl", tc.JsonLinesFormatter(), ["x"]).rewind_to(0)
