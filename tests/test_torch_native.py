"""The engine's C++ host kernels in the port (``pathway_tpu_torch/native``).

Each of the 17 kernels of ``enginecore.cpp`` runs three ways on the same seeded inputs:
the port's built kernel, the port's Python branch at the kernel's call site (under
``PATHWAY_TPU_DISABLE_NATIVE=1``), and the JAX package's kernel
(``pathway_tpu.native.kernels``) handed the same values in its own types. All three must
agree bit for bit: digests and key bytes as bytes, index arrays as ints, entries and
states as normalized rows (floats by their bits, Pointers by their ints, the sentinels
by their kind). The inputs are the reference suite's adversarial ones: ints crossing
2**127, NaN payload bits, -0.0, tz-aware datetimes, the Json, PyObjectWrapper and ERROR
sentinels, keys that collide in their low 64 bits, the bails, the repr fallback. Then
programs through ``pw.run`` with the kernels and without, the hit counters, a threaded
commit, and a build from source into a temporary directory.

The kernels are built once per test process (``native.get()`` caches the module; the
library on disk is reused across processes).
"""

from __future__ import annotations

import datetime
import importlib.util
import random
import struct
import threading

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu import native as jnative
from pathway_tpu.engine import graph as jgraph
from pathway_tpu.engine import value as jv
from pathway_tpu.internals.parse_graph import G as JG
from pathway_tpu_torch import _build, native
from pathway_tpu_torch.engine import device as tdevice
from pathway_tpu_torch.engine import device_ops
from pathway_tpu_torch.engine import graph as tgraph
from pathway_tpu_torch.engine import value as tv
from pathway_tpu_torch.engine.batch import (
    Columns,
    DeltaBatch,
    _entry_keys_bytes_py,
    apply_batch_to_state,
    entry_keys_bytes,
)
from pathway_tpu_torch.engine.expression import Binary, ColumnRef, Const
from pathway_tpu_torch.engine.reducers import ReducerKind, make_reducer
from pathway_tpu_torch.internals.parse_graph import G as TG

DISABLE = "PATHWAY_TPU_DISABLE_NATIVE"
UTC = datetime.timezone.utc
KERNELS = (
    "extract_column", "entry_diffs", "consolidate", "apply_state", "build_entries",
    "filter_truthy", "join_insert_inner", "pointers_to_bytes", "bytes_to_pointers",
    "entry_keys_bytes", "hash_join_pairs", "columns_to_entries", "hash_tuples_batch",
    "shard_values", "entries_to_side", "match_pairs_i64", "session_overlay",
)


@pytest.fixture(scope="module")
def tk():
    return native.get()


@pytest.fixture(scope="module")
def jk():
    kernels = jnative.kernels
    assert kernels is not None, jnative.load_error()
    return kernels


@pytest.fixture(autouse=True)
def _kernels_on(monkeypatch):
    monkeypatch.delenv(DISABLE, raising=False)
    device_ops.configure(device="cpu")
    yield
    device_ops.configure()
    TG.clear()
    JG.clear()


def plain(monkeypatch, fn):
    """``fn()`` on the Python branches (``PATHWAY_TPU_DISABLE_NATIVE=1``)."""
    monkeypatch.setenv(DISABLE, "1")
    try:
        return fn()
    finally:
        monkeypatch.delenv(DISABLE)


def hits(fn) -> tuple:
    """``(fn(), the kernels' calls during it)``."""
    native.reset_hit_counts()
    out = fn()
    return out, {k: v for k, v in native.hit_counts().items() if v}


# -- the values of both packages, and their normal form ----------------------------


def to_jax(v):
    """A value of the port as the same value in the JAX package's types."""
    t = type(v)
    if t is tv.Pointer:
        return jv.Pointer(int(v))
    if v is tv.ERROR:
        return jv.ERROR
    if t is tv.Json:
        return jv.Json(v.value)
    if t is tv.PyObjectWrapper:
        return jv.PyObjectWrapper(v.value)
    if t is tuple:
        return tuple(to_jax(x) for x in v)
    if t is list:
        return [to_jax(x) for x in v]
    if t is dict:
        return {to_jax(k): to_jax(x) for k, x in v.items()}
    if t is np.ndarray and v.dtype == object:
        out = np.empty(v.shape, object)
        for i, x in enumerate(v):
            out[i] = to_jax(x)
        return out
    return v


def norm(v):
    """A comparable normal form: floats by their bits, Pointers by their ints, the
    sentinels by their kind, numeric arrays by dtype and bytes, string and object
    arrays by their values."""
    t = type(v)
    if t in (tv.Pointer, jv.Pointer):
        return ("ptr", int(v))
    if v is tv.ERROR or v is jv.ERROR:
        return ("ERROR",)
    if t in (tv.Json, jv.Json):
        return ("json", repr(v))
    if t in (tv.PyObjectWrapper, jv.PyObjectWrapper):
        return ("pyobj", repr(v.value))
    if t is float:
        return ("f", struct.pack("<d", v))
    if t is bool:
        return ("b", v)
    if t is int:
        return ("i", v)
    if t in (tuple, list):
        return (t.__name__, tuple(norm(x) for x in v))
    if t is dict:
        return ("dict", tuple(sorted(((norm(k), norm(x)) for k, x in v.items()), key=repr)))
    if t is np.ndarray:
        if v.dtype.kind in "OU":
            return ("values", v.shape, norm(v.tolist()))
        return ("arr", v.dtype.str, v.shape, np.ascontiguousarray(v).tobytes())
    return v


def _bits_to_float(bits: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", bits))[0]


def scalar_pool(v) -> list:
    """The reference suite's adversarial scalars, in the types of value module ``v``."""
    return [
        None, True, False, 0, 1, -1, 255, -(2**63), 2**63, 2**100, -(2**126),
        (2**127) - 1,  # the largest digestable int
        0.0, -0.0, 1.5, -2.25, 1e300, float("inf"), float("-inf"), float("nan"),
        _bits_to_float(0x7FF8000000000000 | 0xBEEF),  # a NaN with a payload
        9007199254740993.0,  # 2**53 + 1: the float == int(float) boundary
        -9.223372036854776e18,
        "", "hello", "héllo wörld", "日本語テキスト", b"", b"\x00\xff" * 3,
        (), (1, "two", 3.0), (1, (2, (3, (4,)))), [1, 2],
        v.ref_scalar(7), v.ref_scalar("x", 2), v.ERROR,
        datetime.datetime(2024, 5, 1, 12, 30),
        datetime.datetime(2024, 5, 1, 12, 30, tzinfo=UTC),
        datetime.timedelta(days=2, microseconds=5),
        v.Json({"a": [1, 2], "b": "c"}), v.PyObjectWrapper((1, 2)),
        np.int64(5), np.float64(2.5),
    ]


def random_rows(seed: int, n: int) -> list:
    rng = random.Random(seed)
    pool = scalar_pool(tv)
    return [tuple(rng.choice(pool) for _ in range(rng.randrange(0, 5))) for _ in range(n)]


def kb_of(keys) -> np.ndarray:
    buf = b"".join(int(k).to_bytes(16, "little") for k in keys)
    return np.frombuffer(buf, np.uint8).reshape(len(keys), 16).copy()


def test_kernel_names_and_order_are_the_references(tk, jk):
    assert list(tk.hit_counts()) == list(KERNELS) == list(jk.hit_counts())
    assert list(native.kernel_ns()) == list(KERNELS)


# -- 1. extract_column ------------------------------------------------------------

COLUMNS = {
    "int": lambda v, n: [i * 7 - 50 for i in range(n)],
    "int_edges": lambda v, n: [-(2**63), 2**63 - 1, 0, -1] * (n // 4),
    "bigint": lambda v, n: [i for i in range(n - 1)] + [2**70],
    "float": lambda v, n: [0.5 * i - 3 for i in range(n)],
    "float_bits": lambda v, n: [-0.0, float("nan"), _bits_to_float(0x7FF8000000000000 | 0xBEEF),
                                float("inf")] * (n // 4),
    "bool": lambda v, n: [i % 3 == 0 for i in range(n)],
    "int_float": lambda v, n: [i if i % 2 else float(i) for i in range(n)],
    "bool_int": lambda v, n: [True] + list(range(n - 1)),
    "str": lambda v, n: [f"s{i}" for i in range(n)],
    "none": lambda v, n: [None] * n,
    "error": lambda v, n: [1] * (n - 1) + [v.ERROR],
    "pointer": lambda v, n: [v.ref_scalar(i) for i in range(n)],
    "numpy_scalar": lambda v, n: [np.int64(i) for i in range(n)],
}


@pytest.mark.parametrize("from_entries", [False, True])
@pytest.mark.parametrize("kind", sorted(COLUMNS))
def test_extract_column(tk, jk, monkeypatch, kind, from_entries):
    rows = [(i, x) for i, x in enumerate(COLUMNS[kind](tv, 16))]
    seq = [(tv.ref_scalar(i), r, 1) for i, r in enumerate(rows)] if from_entries else rows
    got = tk.extract_column(seq, 1, from_entries)
    assert norm(got) == norm(jk.extract_column(to_jax(seq), 1, from_entries))
    site, calls = hits(lambda: tdevice.ColumnarView(seq, from_entries=from_entries).column(1))
    assert calls == {"extract_column": 1}
    branch = plain(monkeypatch, lambda: tdevice.ColumnarView(seq, from_entries=from_entries).column(1))
    assert norm(site) == norm(branch)
    if got is not None:
        assert norm(got) == norm(branch)
    assert (got is None) == (kind in ("bigint", "int_float", "bool_int", "str", "none", "error",
                                      "pointer", "numpy_scalar"))


# -- 2. entry_diffs ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_entry_diffs(tk, jk, monkeypatch, seed):
    rng = random.Random(seed)
    entries = [(tv.ref_scalar(i), (rng.randrange(4), float(i)), rng.choice([1, -1, 2, -3]))
               for i in range(rng.randrange(0, 40))]
    got = tk.entry_diffs(entries)
    assert norm(got) == norm(jk.entry_diffs(to_jax(entries)))
    if not entries:
        return
    site = tgraph._groupby_batch_arrays(DeltaBatch(entries), [0], [1])
    branch = plain(monkeypatch, lambda: tgraph._groupby_batch_arrays(DeltaBatch(entries), [0], [1]))
    assert norm(site[1]) == norm(branch[1]) == norm(got)
    assert norm(site[0]) == norm(branch[0]) and norm(site[2]) == norm(branch[2])


# -- 3. consolidate ---------------------------------------------------------------


def _consolidate_cases():
    a = tv.Pointer((1 << 100) | 12345)
    b = tv.Pointer((2 << 100) | 12345)  # a and b share their low 64 bits
    nan = float("nan")
    arr = np.arange(3)
    cases = {
        "low64_collision": [(a, (1,), 1), (b, (1,), 1), (a, (1,), 1)],
        "clean_inserts": [(tv.ref_scalar(i), (i,), 1) for i in range(20)],
        "cancel_to_empty": [(a, (1,), 1), (a, (1,), -1)],
        "nan_row_same_object": [(a, (nan,), 1), (a, (nan,), 1)],
        "neg_zero_rows": [(a, (0.0,), 1), (a, (-0.0,), 1), (b, (-0.0,), -1)],
        "unhashable_rows": [(a, (arr,), 1), (a, (arr,), 1), (b, (np.arange(2),), -1)],
        "error_rows": [(a, (tv.ERROR,), 1), (a, (tv.ERROR,), -1), (b, (tv.ERROR,), 2)],
    }
    rng = random.Random(9)
    keys = [tv.ref_scalar(i) for i in range(6)]
    for s in range(4):
        cases[f"random_{s}"] = [
            (rng.choice(keys), (rng.randrange(3), rng.choice(["x", "y"])), rng.choice([-1, 1, 1, 2]))
            for _ in range(rng.randrange(1, 40))
        ]
    return cases


CONSOLIDATE = _consolidate_cases()


@pytest.mark.parametrize("case", sorted(CONSOLIDATE))
def test_consolidate(tk, jk, monkeypatch, case):
    entries = CONSOLIDATE[case]
    merged, insert_only = tk.consolidate(list(entries))
    jmerged, jinsert_only = jk.consolidate(to_jax(list(entries)))
    assert norm(merged) == norm(jmerged) and insert_only == jinsert_only

    def site():
        batch = DeltaBatch(list(entries))
        out = batch.consolidate()
        return (None, batch._insert_only) if out is batch else (out.entries, out._insert_only)

    got, calls = hits(site)
    assert calls == {"consolidate": 1}
    branch = plain(monkeypatch, site)
    assert norm(got) == norm(branch) == norm((merged, insert_only))


def test_consolidate_refuses_diffs_outside_a_c_long(tk, jk, monkeypatch):
    """Both packages' kernels read a diff as a C long and raise on a larger one, where
    the Python branch would sum Python ints: diffs are row multiplicities and stay far
    inside that range."""
    a = tv.ref_scalar(1)
    entries = [(a, (1,), 2**70), (a, (1,), -(2**70) + 1)]
    with pytest.raises(OverflowError):
        tk.consolidate(entries)
    with pytest.raises(OverflowError):
        jk.consolidate(to_jax(entries))
    with pytest.raises(OverflowError):
        DeltaBatch(entries).consolidate()
    assert plain(monkeypatch, lambda: DeltaBatch(entries).consolidate().entries) == [(a, (1,), 1)]


# -- 4. apply_state ---------------------------------------------------------------


@pytest.mark.parametrize("insert_only", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_state(tk, jk, monkeypatch, seed, insert_only):
    rng = random.Random(seed)
    keys = [tv.ref_scalar(i) for i in range(12)]
    state = {k: ("old", i, -0.0) for i, k in enumerate(keys) if rng.random() < 0.5}
    if insert_only:
        entries = [(k, ("new", rng.randrange(9), float("nan")), 1) for k in rng.sample(keys, 6)]
    else:
        entries = [(k, ("new", rng.randrange(9), 1.5), rng.choice([-1, 1])) for k in rng.sample(keys, 8)]
    got = dict(state)
    tk.apply_state(got, entries, insert_only)
    want = to_jax(dict(state))
    jk.apply_state(want, to_jax(entries), insert_only)
    assert norm(got) == norm(want)

    def site():
        batch = DeltaBatch(entries)
        batch._insert_only = insert_only
        out = dict(state)
        apply_batch_to_state(out, batch)
        return out

    at_site, calls = hits(site)
    assert calls == {"apply_state": 1}
    assert norm(at_site) == norm(plain(monkeypatch, site)) == norm(got)


# -- 5. build_entries -------------------------------------------------------------


@pytest.mark.parametrize("arity", [0, 1, 3])
def test_build_entries(tk, jk, arity):
    rng = random.Random(arity)
    pool = scalar_pool(tv)
    entries = [(tv.ref_scalar(i), (i,), rng.choice([1, 2, -1])) for i in range(30)]
    cols = [[rng.choice(pool) for _ in entries] for _ in range(arity)]
    got = tk.build_entries(entries, cols)
    assert norm(got) == norm(jk.build_entries(to_jax(entries), to_jax(cols)))
    # the Python branch of ExpressionNode.process
    if not cols:
        branch = [(key, (), diff) for key, _row, diff in entries]
    else:
        branch = [(key, row, diff) for (key, _r, diff), row in zip(entries, zip(*cols))]
    assert norm(got) == norm(branch)
    with pytest.raises(ValueError):
        tk.build_entries(entries, [[1]] * max(arity, 1))


def _expression_run(n: int):
    """An ExpressionNode that takes the columnar evaluation with row output: a commit of
    ``n`` inserts after one with rows it retracts."""
    scope = tgraph.Scope()
    sess = scope.input_session(2)
    node = scope.expression_table(sess, [Binary("*", ColumnRef(0), Const(3)), ColumnRef(1)])
    sched = tgraph.Scheduler(scope, optimize=False)
    keys = [tv.ref_scalar(i) for i in range(n)]
    for i, k in enumerate(keys):
        sess.insert(k, (i, f"v{i}"))
    sched.commit()
    for i, k in enumerate(keys):
        if i % 5 == 0:
            sess.remove(k, (i, f"v{i}"))
        sess.insert(tv.ref_scalar(("new", i)), (i + 1, f"n{i}"))
    sched.commit()
    return node.current


def test_build_entries_at_its_call_site(monkeypatch):
    got, calls = hits(lambda: _expression_run(300))
    assert calls.get("build_entries", 0) >= 1, calls
    assert norm(got) == norm(plain(monkeypatch, lambda: _expression_run(300)))


# -- 6. filter_truthy -------------------------------------------------------------

CONDITIONS = {
    "bools": lambda i: i % 3 == 0,
    "all_true": lambda i: True,
    "int_truthy": lambda i: i % 2,  # not a bool: bail
    "none": lambda i: None if i == 7 else True,  # bail
    "error": lambda i: tv.ERROR if i == 3 else False,  # bail: the error is reported
}


@pytest.mark.parametrize("cond", sorted(CONDITIONS))
def test_filter_truthy(tk, jk, monkeypatch, cond):
    entries = [(tv.ref_scalar(i), (i, CONDITIONS[cond](i)), 1) for i in range(24)]
    got = tk.filter_truthy(entries, 1)
    assert norm(got) == norm(jk.filter_truthy(to_jax(entries), 1))
    assert (got is None) == (cond in ("int_truthy", "none", "error"))

    def site():
        scope = tgraph.Scope()
        sess = scope.input_session(2)
        node = scope.filter_table(sess, 1)
        sched = tgraph.Scheduler(scope, optimize=False)
        for k, row, _d in entries:
            sess.insert(k, row)
        sched.commit()
        return node.current, sorted(scope.error_log_default.current.values())

    at_site, calls = hits(site)
    assert calls.get("filter_truthy") == 1, calls
    branch = plain(monkeypatch, site)
    assert norm(at_site) == norm(branch)
    if got is not None:
        assert norm({k: r for k, r, _d in got}) == norm(branch[0])


# -- 7. join_insert_inner ---------------------------------------------------------

JOIN_KEYS = {
    "int": lambda i: i % 5,
    "float_int_bool": lambda i: [1, 1.0, True, 2.5, 0][i % 5],
    "str_bytes": lambda i: ["a", b"a", "b", b"\x00", ""][i % 5],
    "pointer": lambda i: tv.ref_scalar(i % 4),
    "error": lambda i: tv.ERROR if i == 6 else i % 3,  # bail
    "tuple": lambda i: (i % 2,),  # bail: not a scalar
}


def _join_node(prior: list):
    scope = tgraph.Scope()
    left, right = scope.input_session(2), scope.input_session(2)
    node = scope.join_tables(left, right, [0], [0])
    node._columnar_ok = False
    for side, key, row in prior:
        jk_ = (row[0],)
        (node.left_arr if side == 0 else node.right_arr).setdefault(jk_, {})[key] = row
    return node


@pytest.mark.parametrize("diff", [1, 2])
@pytest.mark.parametrize("keys", sorted(JOIN_KEYS))
def test_join_insert_inner(tk, jk, monkeypatch, keys, diff):
    key = JOIN_KEYS[keys]
    le = [(tv.ref_scalar(("l", i)), (key(i), i), diff if i == 4 else 1) for i in range(12)]
    re = [(tv.ref_scalar(("r", i)), (key(i + 1), -i), 1) for i in range(9)]
    # an earlier batch's rows, one under a plain-int key (the join_result_key callback)
    prior = [(0, tv.ref_scalar("p0"), (key(2), 100)), (1, 77, (key(3), 200))]
    node = _join_node(prior)
    larr, rarr = {k: dict(g) for k, g in node.left_arr.items()}, {k: dict(g) for k, g in node.right_arr.items()}
    got = tk.join_insert_inner(le, re, [0], [0], larr, rarr, tv.ERROR, tv.Pointer, None,
                               tgraph.join_result_key)
    jlarr, jrarr = to_jax(node.left_arr), to_jax(node.right_arr)
    jgot = jk.join_insert_inner(to_jax(le), to_jax(re), [0], [0], jlarr, jrarr, jv.ERROR,
                                jv.Pointer, None, jgraph.join_result_key)
    assert norm(got) == norm(jgot)
    assert norm((larr, rarr)) == norm((jlarr, jrarr))
    assert (got is None) == (keys in ("error", "tuple") or diff == 2)

    def site():
        n = _join_node(prior)
        out = n._process_insert_only_inner(DeltaBatch(le), DeltaBatch(re))
        return (None if out is None else out.entries), n.left_arr, n.right_arr

    at_site, calls = hits(site)
    assert calls == {"join_insert_inner": 1}
    branch = plain(monkeypatch, site)
    assert norm(at_site) == norm(branch)
    if got is not None:
        assert norm(got) == norm(branch[0]) and norm((larr, rarr)) == norm(branch[1:])


# -- 8, 9, 10. key bytes and Pointers ---------------------------------------------


def _keys(seed: int, n: int) -> list:
    rng = random.Random(seed)
    return [tv.Pointer(rng.getrandbits(128)) for _ in range(n - 3)] + [
        tv.Pointer(0), tv.Pointer(2**128 - 1), tv.Pointer((1 << 100) | 5)]


@pytest.mark.parametrize("seed", [0, 1])
def test_pointers_to_bytes_and_back(tk, jk, monkeypatch, seed):
    keys = _keys(seed, 40)
    kb = tk.pointers_to_bytes(keys)
    assert norm(kb) == norm(jk.pointers_to_bytes(to_jax(keys))) == norm(kb_of(keys))
    at_site, calls = hits(lambda: Columns(len(keys), [], kobjs=keys).kbytes())
    assert calls == {"pointers_to_bytes": 1}
    assert norm(at_site) == norm(plain(monkeypatch, lambda: Columns(len(keys), [], kobjs=keys).kbytes()))
    back = tk.bytes_to_pointers(kb, tv.Pointer)
    jback = jk.bytes_to_pointers(kb, jv.Pointer)
    assert all(type(p) is tv.Pointer for p in back)
    assert norm(back) == norm(jback) == norm(keys)
    at_site, calls = hits(lambda: Columns(len(keys), [], kbytes=kb).kobjs())
    assert calls == {"bytes_to_pointers": 1}
    branch = plain(monkeypatch, lambda: Columns(len(keys), [], kbytes=kb).kobjs())
    assert norm(at_site) == norm(branch) and all(type(p) is tv.Pointer for p in at_site)


@pytest.mark.parametrize("bad", [-1, 2**128])
def test_pointers_to_bytes_raises_as_the_branch(tk, jk, monkeypatch, bad):
    keys = [tv.ref_scalar(1), bad]
    for fn in (lambda: tk.pointers_to_bytes(keys), lambda: jk.pointers_to_bytes(keys),
               lambda: plain(monkeypatch, lambda: Columns(2, [], kobjs=keys).kbytes())):
        with pytest.raises(OverflowError):
            fn()


class _SubPointer(tv.Pointer):
    pass


class _JaxSubPointer(jv.Pointer):
    pass


ENTRY_KEYS = {
    "pointers": lambda n: [(k, (i,), 1) for i, k in enumerate(_keys(3, n))],
    "plain_int_key": lambda n: [(tv.ref_scalar(i), (i,), 1) for i in range(n - 1)] + [(5, (0,), 1)],
    "pointer_subclass": lambda n: [(_SubPointer(i), (i,), 1) for i in range(n)],
    "malformed": lambda n: [(tv.ref_scalar(0), (0,))],
    "empty": lambda n: [],
}


@pytest.mark.parametrize("case", sorted(ENTRY_KEYS))
def test_entry_keys_bytes(tk, jk, monkeypatch, case):
    entries = ENTRY_KEYS[case](20)
    got = tk.entry_keys_bytes(entries, tv.Pointer)
    assert norm(got) == norm(jk.entry_keys_bytes(to_jax(entries), jv.Pointer))
    assert (got is None) == (case in ("plain_int_key", "pointer_subclass", "malformed"))
    if case == "malformed":
        return  # the Python branch is never handed a malformed entry
    at_site, calls = hits(lambda: entry_keys_bytes(entries))
    assert calls == {"entry_keys_bytes": 1}
    assert norm(at_site) == norm(plain(monkeypatch, lambda: entry_keys_bytes(entries)))
    assert norm(got) == norm(_entry_keys_bytes_py(entries))


# -- 11. hash_join_pairs ----------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 97])
def test_hash_join_pairs(tk, jk, n):
    lkb, rkb = kb_of(_keys(n, n + 3)[:n]), kb_of(_keys(n + 1, n + 3)[:n])
    got = tk.hash_join_pairs(lkb, rkb)
    assert norm(got) == norm(jk.hash_join_pairs(lkb, rkb)) == norm(tgraph._hash_join_pairs_py(lkb, rkb))
    # the join's result key, one pair at a time
    lk, rk = tk.bytes_to_pointers(lkb, tv.Pointer), tk.bytes_to_pointers(rkb, tv.Pointer)
    assert norm(tk.bytes_to_pointers(got, tv.Pointer)) == norm(
        [tgraph.join_result_key(a, b) for a, b in zip(lk, rk)])


def test_hash_join_pairs_at_its_call_site(monkeypatch):
    def run():
        scope = tgraph.Scope()
        left, right = scope.input_session(2), scope.input_session(2)
        node = scope.join_tables(left, right, [0], [0])
        sched = tgraph.Scheduler(scope, optimize=False)
        for i in range(300):
            left.insert(tv.ref_scalar(("l", i)), (i % 40, float(i)))
        for i in range(60):
            right.insert(tv.ref_scalar(("r", i)), (i, i * 2))
        sched.commit()
        return node.current

    got, calls = hits(run)
    assert calls.get("hash_join_pairs") == 1 and calls.get("entries_to_side") == 2, calls
    assert calls.get("match_pairs_i64") == 1, calls
    assert norm(got) == norm(plain(monkeypatch, run))


# -- 12. columns_to_entries -------------------------------------------------------

COLUMN_SETS = {
    "numeric": lambda n: [np.arange(n, dtype=np.int64), np.linspace(-1, 1, n),
                          np.arange(n) % 2 == 0],
    "float_bits": lambda n: [np.array([-0.0, np.nan, _bits_to_float(0x7FF8000000000000 | 0xBEEF),
                                       np.inf] * (n // 4))],
    "narrow_dtypes": lambda n: [np.arange(n, dtype=np.int32), np.arange(n, dtype=np.float32) / 3,
                                np.arange(n, dtype=np.uint64) * (2**63 // n)],
    "strings": lambda n: [np.array([f"s{i}" for i in range(n)]), np.arange(n)],
    "objects": lambda n: [_object_column(n)],
    "datetimes": lambda n: [np.arange(n).astype("datetime64[ns]"),
                            np.arange(n).astype("timedelta64[us]")],
    "none": lambda n: [],
}


def _object_column(n: int) -> np.ndarray:
    pool = scalar_pool(tv)
    col = np.empty(n, object)
    for i in range(n):
        col[i] = pool[i % len(pool)]
    return col


@pytest.mark.parametrize("diffs", [False, True])
@pytest.mark.parametrize("case", sorted(COLUMN_SETS))
def test_columns_to_entries(tk, jk, monkeypatch, case, diffs):
    n = 40
    cols = COLUMN_SETS[case](n)
    keys = _keys(5, n)
    d = np.array([(-1) ** i * (i % 3 + 1) for i in range(n)], np.int64) if diffs else None
    got = tk.columns_to_entries(keys, [np.ascontiguousarray(c) for c in cols], d)
    jcols = [to_jax(c) if c.dtype == object else c for c in cols]
    assert norm(got) == norm(jk.columns_to_entries(to_jax(keys), jcols, d))
    at_site, calls = hits(lambda: Columns(n, cols, kobjs=keys, diffs=d).to_entries())
    assert calls == {"columns_to_entries": 1}
    branch = plain(monkeypatch, lambda: Columns(n, cols, kobjs=keys, diffs=d).to_entries())
    assert norm(at_site) == norm(branch) == norm(got)
    assert [type(v) for v in got[1][1]] == [type(v) for v in branch[1][1]]


# -- 13. hash_tuples_batch --------------------------------------------------------


def _row_fallback(salt: bytes, repr_fallback: bool):
    def fb(row):
        try:
            return tv._digest16(row, salt)
        except TypeError:
            if not repr_fallback:
                raise
            return tv._digest16(tuple(repr(v) for v in row), salt)

    return fb


def _jax_row_fallback(salt: bytes):
    return lambda row: jv._digest16(row, salt)


@pytest.mark.parametrize("salt", [b"", b"shard", b"join"])
@pytest.mark.parametrize("seed", [42, 1])
def test_hash_tuples_batch(tk, jk, monkeypatch, seed, salt):
    rows = random_rows(seed, 300)
    got = tk.hash_tuples_batch(rows, salt, False, tv.Pointer, tv.ERROR, _row_fallback(salt, False))
    want = jk.hash_tuples_batch(to_jax(rows), salt, False, jv.Pointer, jv.ERROR, _jax_row_fallback(salt))
    assert norm(got) == norm(want) == norm(tv._hash_values_batch_py(rows, salt=salt))
    at_site, calls = hits(lambda: tv.hash_values_batch(rows, salt=salt))
    assert calls == {"hash_tuples_batch": 1}
    assert norm(at_site) == norm(plain(monkeypatch, lambda: tv.hash_values_batch(rows, salt=salt)))
    # an object ndarray of rows is the same input
    arr = np.empty(len(rows), object)
    for i, r in enumerate(rows):
        arr[i] = r
    assert norm(tv.hash_values_batch(arr, salt=salt)) == norm(got)
    # each digest is hash_values of its row
    assert norm(got[:20]) == norm(kb_of([tv.hash_values(r, salt=salt) for r in rows[:20]]))


class _Weird:
    def __repr__(self):
        return "<weird>"


class _Boom:
    def __repr__(self):
        raise TypeError("unrepresentable")


def test_hash_tuples_batch_repr_fallback_and_dicts(tk, monkeypatch):
    rows = [(_Weird(),), (1, _Weird()), ({"a": 1, "b": [2]},), (1,)]
    want = tv._hash_values_batch_py(rows, on_type_error="repr")
    assert norm(tv.hash_values_batch(rows, on_type_error="repr")) == norm(want)
    assert norm(plain(monkeypatch, lambda: tv.hash_values_batch(rows, on_type_error="repr"))) == norm(want)
    assert norm(jv.hash_values_batch(rows, on_type_error="repr")) == norm(want)


@pytest.mark.parametrize("rows,error", [
    ([(1,), (_Boom(),)], TypeError),
    ([(2**127,)], OverflowError),
    ([(-(2**127) - 1,)], OverflowError),
    ([("\ud800",)], UnicodeEncodeError),
])
def test_hash_tuples_batch_raises_as_the_branch(monkeypatch, rows, error):
    with pytest.raises(error):
        tv.hash_values_batch(rows)
    with pytest.raises(error):
        plain(monkeypatch, lambda: tv.hash_values_batch(rows))
    with pytest.raises(error):
        jv.hash_values_batch(rows)


def test_hash_tuples_batch_bare_mode(tk, jk):
    vals = [v for v in scalar_pool(tv) if not isinstance(v, list)]
    arr = np.empty(len(vals), object)
    arr[:] = vals

    def bare_fb(v):
        try:
            return tv._digest16((v,), b"")
        except TypeError:
            return tv._digest16((repr(v),), b"")

    got = tk.hash_tuples_batch(arr, b"", True, tv.Pointer, tv.ERROR, bare_fb)
    jarr = to_jax(arr)
    from pathway_tpu.engine.routing import _bare_digest_fallback

    want = jk.hash_tuples_batch(jarr, b"", True, jv.Pointer, jv.ERROR, _bare_digest_fallback)
    assert norm(got) == norm(want) == norm(tv._hash_values_batch_py([(v,) for v in vals],
                                                                    on_type_error="repr"))


# -- 14. shard_values (no caller in the port until engine/routing.py is ported) -------


def _shard_of(v, n: int) -> int:
    """The plain version: ``pathway_tpu/engine/routing.py::_shard_of`` on the port's
    values."""
    if isinstance(v, tv.Pointer):
        return int(v) % n
    try:
        return int(tv.hash_values((v,), salt=b"shard")) % n
    except TypeError:
        return int(tv.hash_values((repr(v),), salt=b"shard")) % n


def _shard_fb(v):
    try:
        return tv._digest16((v,), b"shard")
    except TypeError:
        return tv._digest16((repr(v),), b"shard")


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64])
def test_shard_values(tk, jk, n):
    rng = random.Random(7)
    vals = [rng.choice(scalar_pool(tv)) for _ in range(300)]
    from pathway_tpu.engine.routing import _shard_digest_fallback

    got = tk.shard_values(vals, b"shard", n, tv.Pointer, tv.ERROR, _shard_fb)
    want = jk.shard_values(to_jax(vals), b"shard", n, jv.Pointer, jv.ERROR, _shard_digest_fallback)
    assert norm(got) == norm(want)
    assert got.tolist() == [_shard_of(v, n) for v in vals]


def test_shard_values_bails_on_a_pointer_subclass(tk, jk):
    vals = [_SubPointer(5), tv.ref_scalar(1), "x"]
    assert tk.shard_values(vals, b"shard", 3, tv.Pointer, tv.ERROR, _shard_fb) is None
    jvals = [_JaxSubPointer(5), jv.ref_scalar(1), "x"]
    assert jk.shard_values(jvals, b"shard", 3, jv.Pointer, jv.ERROR, lambda v: b"\0" * 16) is None
    assert tk.shard_values(vals, b"shard", 0, tv.Pointer, tv.ERROR, _shard_fb) is None


# -- 15. entries_to_side ----------------------------------------------------------

SIDES = {
    "typed": lambda i: ((i, float(i), i % 2 == 0), 1),
    "string_payload": lambda i: ((i % 7, f"name{i}"), 1),
    "bigint_payload": lambda i: ((i, 2**70 + i), 1),
    "object_payload": lambda i: ((i, tv.ERROR if i == 2 else None), 1),
    "string_key": lambda i: ((f"k{i}", 1), 1),  # bail
    "bigint_key": lambda i: ((2**70 + i, 1), 1),  # bail
    "diff_2": lambda i: ((i, 1), 2 if i == 3 else 1),  # bail
    "mixed_key": lambda i: ((i if i % 2 else float(i), 1), 1),  # bail
}


@pytest.mark.parametrize("case", sorted(SIDES))
def test_entries_to_side(tk, jk, monkeypatch, case):
    n = 12
    entries = [(tv.ref_scalar(i), *SIDES[case](i)) for i in range(n)]
    arity = len(entries[0][1])
    got = tk.entries_to_side(entries, [0], arity, tv.Pointer)
    assert norm(got) == norm(jk.entries_to_side(to_jax(entries), [0], arity, jv.Pointer))
    assert (got is None) == (case in ("string_key", "bigint_key", "diff_2", "mixed_key"))

    def site():
        node = _join_node([])
        batch = DeltaBatch(entries)
        batch._raw_insert_only = True
        side = node._side_from_batch(batch, [0], arity)
        return None if side is None else (side.jks, side.kb, side.cols)

    at_site, calls = hits(site)
    assert calls.get("entries_to_side") == 1, calls
    branch = plain(monkeypatch, site)
    # string payload columns: objects from the kernel, a str array from the branch,
    # the same values
    assert norm(at_site) == norm(branch)
    if got is not None:
        assert norm((got[0], got[1])) == norm((branch[1], branch[2]))


def test_entries_to_side_screens_duplicate_keys(monkeypatch):
    a = tv.Pointer((1 << 100) | 12345)
    b = tv.Pointer((2 << 100) | 12345)  # a and b share their low 64 bits
    for keys, unique in (([a, b], True), ([a, a], False)):
        entries = [(k, (i, 1), 1) for i, k in enumerate(keys)]
        assert tgraph._keys_unique(kb_of(keys), 2) == unique
        for run in (lambda f: f(), lambda f: plain(monkeypatch, f)):
            batch = DeltaBatch(entries)
            batch._raw_insert_only = True
            side = run(lambda: _join_node([])._side_from_batch(batch, [0], 2))
            assert (side is not None) == unique


# -- 16. match_pairs_i64 ----------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_match_pairs_i64(tk, jk, monkeypatch, seed):
    rng = random.Random(seed)
    for _ in range(20):
        k = rng.randrange(1, 4)
        nl, nr = rng.randrange(0, 30), rng.randrange(0, 30)
        lc = [np.array([rng.randrange(-3, 4) for _ in range(nl)], np.int64) for _ in range(k)]
        rc = [np.array([rng.randrange(-3, 4) for _ in range(nr)], np.int64) for _ in range(k)]
        got = tk.match_pairs_i64(lc, rc)
        assert norm(got) == norm(jk.match_pairs_i64(lc, rc))
        at_site, calls = hits(lambda: tgraph._match_join_pairs_multi(lc, rc))
        assert calls == {"match_pairs_i64": 1}
        branch = plain(monkeypatch, lambda: tgraph._match_join_pairs_multi(lc, rc))
        assert norm(got) == norm(at_site)
        assert [a.tolist() for a in got] == [np.asarray(a).tolist() for a in branch]


def test_match_pairs_float_codes(monkeypatch):
    la = [np.array([0.0, -0.0, 1.5, 2.0, 3.0])]
    ra = [np.array([-0.0, 2.0, 2.0, 7.0])]
    got, calls = hits(lambda: tgraph._match_join_pairs_multi(la, ra))
    assert calls == {"match_pairs_i64": 1}
    branch = plain(monkeypatch, lambda: tgraph._match_join_pairs_multi(la, ra))
    assert [a.tolist() for a in got] == [np.asarray(a).tolist() for a in branch]
    # NaN has no code view: the sort-based matcher decides
    nan = [np.array([1.0, np.nan])]
    _got, calls = hits(lambda: tgraph._match_join_pairs_multi(nan, nan))
    assert calls == {}


# -- 17. session_overlay ----------------------------------------------------------


def _overlay_reference(buffer, state, upsert):
    out = []
    overlay: dict = {}

    def effective(key):
        return overlay[key] if key in overlay else state.get(key)

    for key, row, diff in buffer:
        if upsert:
            prev = effective(key)
            if diff > 0:
                if prev is not None:
                    out.append((key, prev, -1))
                out.append((key, row, 1))
                overlay[key] = row
            elif prev is not None:
                out.append((key, prev, -1))
                overlay[key] = None
        else:
            if diff < 0 and row is None:
                row = effective(key)
                if row is None:
                    continue
            if diff > 0:
                overlay[key] = row
            elif effective(key) == row:
                overlay[key] = None
            out.append((key, row, diff))
    return out


@pytest.mark.parametrize("upsert", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_session_overlay(tk, jk, monkeypatch, seed, upsert):
    rng = random.Random(seed * 2 + upsert)
    for _ in range(40):
        keys = [tv.ref_scalar(i) for i in range(rng.randrange(1, 6))]
        state = {k: ("old", int(k) % 97) for k in keys if rng.random() < 0.5}
        buffer = []
        for _ in range(rng.randrange(0, 12)):
            k = rng.choice(keys)
            if rng.random() < 0.6:
                buffer.append((k, ("new", rng.randrange(5)), 1))
            elif upsert or rng.random() < 0.5:
                buffer.append((k, None, -1))
            else:
                buffer.append((k, ("new", rng.randrange(5)), -1))
        got = tk.session_overlay(list(buffer), dict(state), upsert)
        assert norm(got) == norm(jk.session_overlay(to_jax(buffer), to_jax(state), upsert))
        assert norm(got) == norm(_overlay_reference(buffer, state, upsert))

        def site():
            scope = tgraph.Scope()
            sess = tgraph.InputSession(scope, 2, upsert=upsert)
            sess.current = dict(state)
            for key, row, diff in buffer:
                if diff > 0:
                    sess.insert(key, row)
                else:
                    sess.remove(key, row)
            batch = sess.flush()
            return None if batch is None else batch.entries

        at_site, calls = hits(site)
        overlaid = bool(buffer) and (upsert or any(r is None for _k, r, _d in buffer))
        assert calls == ({"session_overlay": 1, "consolidate": 1} if overlaid else {})
        assert norm(at_site) == norm(plain(monkeypatch, site))


def test_session_overlay_bails_on_a_rowless_upsert_insert(tk):
    assert tk.session_overlay([(tv.ref_scalar(1), None, 1)], {}, True) is None
    assert tk.session_overlay([(tv.ref_scalar(1), None)], {}, False) is None


# -- programs through pw.run, both ways -------------------------------------------


def _canon(v):
    if isinstance(v, float):
        return ("f", np.float64(v).view(np.int64).item())
    if v is not None and type(v).__name__ == "Pointer":
        return ("ptr", int(v))
    if isinstance(v, tuple):
        return tuple(_canon(x) for x in v)
    return v


def _dicts(pw, table) -> tuple:
    data, names = pw.debug.table_to_dicts(table)
    return names, {int(k): {c: _canon(x) for c, x in r.items()} for k, r in data.items()}


def _rows(pw, n: int = 400):
    rng = np.random.default_rng(3)
    g = rng.integers(0, 9, n)
    v = rng.integers(-50, 50, n) * 0.5
    return pw.debug.table_from_rows(
        pw.schema_from_types(k=int, g=int, v=float, s=str),
        [(i, int(a), float(b), f"s{i % 13}") for i, (a, b) in enumerate(zip(g, v))])


def _right(pw, n: int = 60):
    return pw.debug.table_from_rows(
        pw.schema_from_types(g=int, w=int), [(i % 11, i) for i in range(n)])


def _edges(pw):
    rng = np.random.default_rng(5)
    us = rng.integers(0, 30, 120)
    vs = (us + 1 + rng.integers(0, 29, 120)) % 30
    return pw.debug.table_from_rows(pw.schema_from_types(u=int, v=int),
                                    [(int(u), int(v)) for u, v in zip(us, vs)])


def _graphs(pw):
    return tpw.stdlib.graphs if pw is tpw else jpw.stdlib.graphs


PROGRAMS = {
    "groupby": lambda pw: _rows(pw).groupby(pw.this.g).reduce(
        pw.this.g, n=pw.reducers.count(), s=pw.reducers.sum(pw.this.v)),
    "join_inner": lambda pw: _rows(pw).join(_right(pw), pw.left.g == pw.right.g).select(
        pw.left.k, pw.left.v, pw.right.w),
    "join_outer": lambda pw: _rows(pw).join_outer(_right(pw), pw.left.g == pw.right.g).select(
        pw.left.k, pw.right.w),
    "filter": lambda pw: _rows(pw).filter(pw.this.v > 0),
    "concat": lambda pw: _rows(pw).filter(pw.this.v > 0).concat_reindex(
        _rows(pw).filter(pw.this.v <= 0)),
    "update_rows": lambda pw: _rows(pw).update_rows(
        _rows(pw, 120).select(k=pw.this.k + 1000, g=pw.this.g, v=pw.this.v, s=pw.this.s)),
    "fused_chain": lambda pw: _rows(pw).select(pw.this.k, x=pw.this.v * 2, g=pw.this.g).filter(
        pw.this.x > -10).select(pw.this.k, y=pw.this.x + pw.this.g),
    "interval_join": lambda pw: pw.temporal.interval_join(
        _rows(pw, 150).select(t=pw.this.k, g=pw.this.g),
        _right(pw).select(t=pw.this.w * 2, g=pw.this.g),
        pw.left.t, pw.right.t, pw.temporal.interval(-3, 3), pw.left.g == pw.right.g,
    ).select(lt=pw.left.t, rt=pw.right.t),
    "iterate_pagerank": lambda pw: _graphs(pw).pagerank(_edges(pw), iteration_limit=8),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_both_ways(monkeypatch, name):
    """A program through ``pw.run`` with the kernels, then on the Python branches: the
    same output (and the JAX package's); the kernels ran in the first and not in the
    second."""
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "1")
    got, calls = hits(lambda: _dicts(tpw, PROGRAMS[name](tpw)))
    TG.clear()
    branch, branch_calls = hits(lambda: plain(monkeypatch, lambda: _dicts(tpw, PROGRAMS[name](tpw))))
    TG.clear()
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")
    want = _dicts(jpw, PROGRAMS[name](jpw))
    assert got[1], "the program produced no row"
    assert got == branch == want
    assert branch_calls == {}
    assert ENGAGED[name] <= set(calls), calls


#: kernels each program must call (at least these)
ENGAGED = {
    "groupby": {"extract_column", "consolidate", "entry_keys_bytes", "columns_to_entries"},
    "join_inner": {"entries_to_side", "hash_join_pairs", "columns_to_entries", "bytes_to_pointers"},
    "join_outer": {"consolidate", "entry_keys_bytes", "columns_to_entries"},
    "filter": {"extract_column", "entry_keys_bytes", "columns_to_entries"},
    "concat": {"extract_column", "consolidate", "apply_state"},
    "update_rows": {"consolidate", "apply_state"},
    "fused_chain": {"extract_column", "entry_keys_bytes", "columns_to_entries"},
    "interval_join": {"consolidate", "apply_state"},
    "iterate_pagerank": {"entries_to_side", "hash_join_pairs", "entry_diffs", "consolidate"},
}


def test_counts_move_and_reset(tk):
    native.reset_hit_counts()
    assert native.hit_counts() == dict.fromkeys(KERNELS, 0)
    assert all(v == 0 for v in native.kernel_ns().values())
    tv.hash_values_batch([(1, "a"), (2, "b")])
    assert native.hit_counts()["hash_tuples_batch"] == 1
    assert native.kernel_ns()["hash_tuples_batch"] > 0
    native.reset_hit_counts()
    assert all(v == 0 for v in native.hit_counts().values())


def test_disable_is_read_at_each_lookup(tk, monkeypatch):
    assert native.get() is tk and native.available() and native.load_error() is None
    monkeypatch.setenv(DISABLE, "1")
    assert native.get() is None and not native.available()
    assert "PATHWAY_TPU_DISABLE_NATIVE" in native.load_error()
    assert native.hit_counts() == tk.hit_counts()  # the counters stay readable
    monkeypatch.delenv(DISABLE)
    assert native.kernels is tk


# -- a threaded commit: the kernels hold the GIL --------------------------------------


def _threaded_program(seed: int) -> dict:
    """A join of an upsert session and a groupby over six commits, on one thread's own
    scope: the even commits insert fresh keys (the columnar join, then the insert-only
    kernel), the odd ones update the previous commit's rows (the overlay, retractions)."""
    rng = random.Random(seed)
    scope = tgraph.Scope()
    left = scope.input_session(2, upsert=True)
    right = scope.input_session(2)
    node = scope.join_tables(left, right, [0], [0])
    group = scope.group_by_table(node, by_cols=[0], reducers=[(make_reducer(ReducerKind.COUNT), [])])
    sched = tgraph.Scheduler(scope)
    for c in range(6):
        for i in range(300):
            key = tv.ref_scalar(("l", seed, c - c % 2, i))
            left.insert(key, (rng.randrange(40), c))
        for i in range(40):
            right.insert(tv.ref_scalar(("r", seed, c, i)), (rng.randrange(40), float(i)))
        sched.commit()
    return {"join": norm(node.current), "groups": norm(group.current)}


def test_threaded_commits_match_one_thread():
    want = {s: _threaded_program(s) for s in range(4)}
    got: dict = {}
    errors: list = []

    def run(s):
        try:
            got[s] = _threaded_program(s)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    native.reset_hit_counts()
    threads = [threading.Thread(target=run, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert got == want
    calls = native.hit_counts()
    assert calls["session_overlay"] > 0 and calls["join_insert_inner"] > 0, calls


# -- the build ----------------------------------------------------------------------


def test_recompiled_kernels_match(tk, tmp_path, monkeypatch):
    """The library is built from the checkout's source: a build into a temporary
    directory gives a module whose digests are the loaded one's and the Python
    branch's."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    built = _build.build_host(native.SOURCE)
    assert built.library.parent == tmp_path and built.seconds > 0
    assert _build.build_host(native.SOURCE).seconds == 0.0  # reused
    spec = importlib.util.spec_from_file_location("_enginecore", built.library)
    fresh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fresh)
    assert fresh is not tk
    rows = random_rows(5, 64)
    got = fresh.hash_tuples_batch(rows, b"", False, tv.Pointer, tv.ERROR, _row_fallback(b"", False))
    assert norm(got) == norm(tv._hash_values_batch_py(rows))
    assert list(fresh.hit_counts()) == list(KERNELS)
    assert fresh.hit_counts()["hash_tuples_batch"] == 1


def test_library_name_follows_source_flags_and_abi(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    src = tmp_path / "k.cpp"
    src.write_text("// one")
    first = _build._host_library_path(src)
    assert first.parent == tmp_path and first.name.startswith("k-")
    src.write_text("// two")
    second = _build._host_library_path(src)
    assert second != first
    monkeypatch.setattr(_build, "HOST_FLAGS", (*_build.HOST_FLAGS, "-g"))
    assert _build._host_library_path(src) != second


def test_metrics_collector_matches_the_jax_packages(tk, jk):
    """``pathway_native_kernel_hits_total`` and ``pathway_native_kernel_ns_total``, one
    sample per kernel, with the JAX package's names, kinds, help and labels."""
    from pathway_tpu.internals import metrics as jmetrics
    from pathway_tpu_torch.internals import metrics as tmetrics

    native.reset_hit_counts()
    tv.hash_values_batch([(1,)])
    got = tmetrics._native_collector()
    want = jmetrics._native_collector()
    assert [s[:4] for s in got] == [s[:4] for s in want]
    assert {s[1] for s in got} == {"counter"} and len(got) == 2 * len(KERNELS)
    values = {(s[0], s[3]["kernel"]): s[4] for s in got}
    assert values[("pathway_native_kernel_hits_total", "hash_tuples_batch")] == 1
    assert values[("pathway_native_kernel_ns_total", "hash_tuples_batch")] > 0
    assert sum(values.values()) == 1 + values[("pathway_native_kernel_ns_total", "hash_tuples_batch")]
    assert tmetrics._native_collector in tmetrics.REGISTRY._collectors
