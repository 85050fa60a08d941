"""The port's shard routing (``pathway_tpu_torch/engine/routing.py``) against the JAX
package's (``pathway_tpu/engine/routing.py``).

Every case builds the same seeded columns in both packages and asks both for the worker
of each row: the ids must be equal, and equal to the per-row definition ``_shard_of``,
with the host kernels and under ``PATHWAY_TPU_DISABLE_NATIVE=1`` (the ``mode`` fixture).
The cases are those of ``tests/test_shard_routing.py``: the key, cols, col and constant
rules, Pointers, NaNs with mixed bits, int-valued floats, object columns of mixed types
and keys that share their low 64 bits. Its three-process mesh case belongs to the
distributed runner, which the port does not have yet.
"""

from __future__ import annotations

import struct
from collections import defaultdict

import numpy as np
import pytest

from pathway_tpu.engine import batch as jb
from pathway_tpu.engine import routing as jr
from pathway_tpu.engine import value as jv
from pathway_tpu_torch import native
from pathway_tpu_torch.engine import batch as tb
from pathway_tpu_torch.engine import routing as tr
from pathway_tpu_torch.engine import value as tv

NS = (2, 3, 4, 7)
SEED = 0


@pytest.fixture(params=["native", "plain"])
def mode(request, monkeypatch):
    """The host kernels, or their plain versions."""
    if request.param == "plain":
        monkeypatch.setenv(native.DISABLE_ENV, "1")
    else:
        monkeypatch.delenv(native.DISABLE_ENV, raising=False)
    return request.param


def _to_ref(v):
    """A port value as the same value in the JAX package's types."""
    t = type(v)
    if t is tv.Pointer:
        return jv.Pointer(int(v))
    if v is tv.ERROR:
        return jv.ERROR
    if t is tv.Json:
        return jv.Json(v.value)
    if t is tuple:
        return tuple(_to_ref(x) for x in v)
    if t is list:
        return [_to_ref(x) for x in v]
    return v


def _obj(values: list) -> np.ndarray:
    arr = np.empty(len(values), object)
    arr[:] = values
    return arr


def _keys(n: int, salt: str = "k") -> list:
    return [tv.ref_scalar(salt, i) for i in range(n)]


def _both(cols: list[np.ndarray], keys: list) -> tuple:
    """The same payload as a port ``Columns`` and a JAX ``Columns``."""
    assert all(len(c) == len(keys) for c in cols)
    jcols = [_obj([_to_ref(x) for x in c.tolist()]) if c.dtype == object else c for c in cols]
    return (
        tb.Columns(len(keys), cols, kobjs=keys),
        jb.Columns(len(keys), jcols, kobjs=[jv.Pointer(int(k)) for k in keys]),
    )


def _rows_of(columns) -> list[tuple]:
    """Rows as a row-path consumer sees them."""
    return [r for _k, r, _d in tb.DeltaBatch.from_columns(columns).entries]


def _expect(rule: tuple, columns, keys: list, n: int) -> list[int]:
    """The per-row definition of ``rule``'s worker for every row."""
    kind = rule[0]
    if kind == "key":
        return [tr._shard_of(k, n) for k in keys]
    if kind == "cols":
        return [tr._shard_of(tuple(row[c] for c in rule[1]), n) for row in _rows_of(columns)]
    c = rule[1]
    return [tr._shard_of(row[c] if c is not None else None, n) for row in _rows_of(columns)]


def _routed(rule: tuple, cols: list[np.ndarray], keys: list, n: int) -> list[int]:
    """The port's columnar and entry routes of ``rule``, checked against the JAX
    package's and the per-row definition."""
    tcols, jcols = _both(cols, keys)
    got = tr.columnar_shards(rule, tcols, n)
    want = jr.columnar_shards(rule, jcols, n)
    assert got is not None and want is not None
    assert got.dtype == np.int64
    assert got.tolist() == want.tolist() == _expect(rule, tcols, keys, n)
    entries = tb.DeltaBatch.from_columns(tcols).entries
    jentries = jb.DeltaBatch.from_columns(jcols).entries
    by_entry = tr.entry_shards(rule, entries, n)
    assert by_entry.tolist() == jr.entry_shards(rule, jentries, n).tolist() == got.tolist()
    return got.tolist()


# -- ("key",): the full 128-bit pointer mod n -----------------------------------------


def test_key_rule_matches_the_reference_with_low64_collisions(mode):
    rng = np.random.default_rng(SEED)
    words = rng.integers(0, 2**63, (64, 2), dtype=np.int64).astype(object)
    keys = [tv.Pointer(int(lo) | (int(hi) << 64)) for lo, hi in words]
    # the same low 64 bits with different high halves: a fold of the low word alone
    # would put each pair together
    base = int(rng.integers(0, 2**63))
    keys += [tv.Pointer(base + (k << 64)) for k in range(1, 9)]
    keys += [tv.Pointer(0), tv.Pointer((1 << 128) - 1), tv.Pointer(1 << 64)]
    for n in NS:
        _routed(("key",), [np.arange(len(keys))], keys, n)


def test_mod_u128_bytes_matches_the_reference():
    rng = np.random.default_rng(SEED + 1)
    halves = rng.integers(0, 2**63, (200, 2), dtype=np.int64).astype(object)
    values = [int(lo) * 2 + 1 | (int(hi) << 65) for lo, hi in halves]
    values = [v % (1 << 128) for v in values] + [0, (1 << 128) - 1, 1 << 64, (1 << 64) - 1]
    kb = np.frombuffer(b"".join(v.to_bytes(16, "little") for v in values), np.uint8)
    kb = kb.reshape(len(values), 16)
    for n in (2, 3, 7, 64, 1021):
        got = tr.mod_u128_bytes(kb, n)
        assert got.tolist() == jr.mod_u128_bytes(kb, n).tolist() == [v % n for v in values]


# -- ("cols", ...) and ("col", ...): value routing per distinct key ---------------------


def test_multi_column_int_str(mode):
    rng = np.random.default_rng(SEED + 2)
    c0 = rng.integers(0, 5, 40)
    c1 = np.array([f"g{i}" for i in rng.integers(0, 3, 40)])
    for n in NS:
        _routed(("cols", [0, 1]), [c0, c1, rng.random(40)], _keys(40), n)


def test_bare_col_rule_hashes_the_bare_value(mode):
    c0 = np.random.default_rng(SEED + 3).integers(0, 4, 12)
    for n in NS:
        _routed(("col", 0), [c0], _keys(12), n)
    # the distinction matters: the digest of v is not the digest of (v,)
    assert any(tr._shard_of(3, n) != tr._shard_of((3,), n) for n in (5, 7))


def test_pointer_column_routes_by_direct_mod(mode):
    rng = np.random.default_rng(SEED + 4)
    ptrs = [tv.Pointer(int(x)) for x in rng.integers(0, 2**63, 20)]
    ptrs[5] = ptrs[0]  # a duplicate shares its class
    for n in NS:
        got = _routed(("col", 0), [_obj(ptrs)], _keys(20), n)
        assert got == [int(p) % n for p in ptrs]


def test_nan_float_column_stays_vectorized(mode):
    vals = np.array([1.0, float("nan"), 2.0, 3.0])
    for n in NS:
        _routed(("col", 0), [vals], _keys(4), n)
        _routed(("cols", [0]), [vals], _keys(4), n)
    clean = np.array([1.0, 2.5, 2.5, 3.0])
    assert tr.columnar_shards(("col", 0), tb.Columns(4, [clean], kobjs=_keys(4)), 3) is not None


def test_mixed_bit_nans_route_as_the_per_row_digests(mode):
    """NaN payload bits are routing identity; -0.0 and +0.0 split into two classes yet
    route together."""
    payload_nans = [
        struct.unpack("<d", struct.pack("<Q", 0x7FF8000000000000 | p))[0]
        for p in (0, 1, 2, 0xDEAD, 0xBEEF, (1 << 51) - 1)
    ]
    neg_nan = struct.unpack("<d", struct.pack("<Q", 0xFFF8000000000001))[0]
    pool = payload_nans + [neg_nan, 0.0, -0.0, 1.5, -2.25, 1e300]
    pick = np.random.default_rng(SEED + 5).integers(0, len(pool), 64)
    vals = np.array([pool[i] for i in pick])
    for n in NS:
        _routed(("col", 0), [vals], _keys(64), n)


def test_int_valued_float_shards_with_int(mode):
    as_int = np.array([1, 2, 3, 1, 2, 3])
    as_float = as_int.astype(np.float64)
    for n in NS:
        assert _routed(("col", 0), [as_int], _keys(6), n) == _routed(
            ("col", 0), [as_float], _keys(6), n
        )


def test_object_column_of_mixed_types(mode):
    values = [True, 1, "x", None, 3.5, (1, 2), "x", True, (1, 2), 0, False]
    for n in NS:
        _routed(("col", 0), [_obj(values)], _keys(len(values)), n)
    assert tv.hash_values((True,)) != tv.hash_values((1,))  # bool and int stay apart


def test_object_column_within_a_cols_rule(mode):
    values = [(i % 3, f"s{i % 2}") for i in range(18)]
    for n in NS:
        _routed(("cols", [0, 1]), [_obj(values), np.arange(18)], _keys(18), n)


def test_constant_rules(mode):
    tcols, jcols = _both([np.arange(5)], _keys(5))
    for rule, value in ((("cols", []), ()), (("col", None), None)):
        got = tr.columnar_shards(rule, tcols, 3)
        assert got.tolist() == jr.columnar_shards(rule, jcols, 3).tolist()
        assert got.tolist() == [tr._shard_of(value, 3)] * 5


def test_pin_rule_has_no_shard_table(mode):
    tcols, _j = _both([np.arange(3)], _keys(3))
    assert tr.columnar_shards(("pin",), tcols, 3) is None
    assert tr.entry_shards(("pin",), tb.DeltaBatch.from_columns(tcols).entries, 3) is None


def test_seeded_property_against_the_reference(mode):
    rng = np.random.default_rng(1234)
    obj_pool = [None, True, 2, "a", 2.5, (1, "b")]

    def column(kind: int, m: int) -> np.ndarray:
        if kind == 0:
            return rng.integers(-50, 50, m)
        if kind == 1:
            return rng.random(m) * 100
        if kind == 2:
            return np.array([f"s{i}" for i in rng.integers(0, 8, m)])
        if kind == 3:
            return rng.integers(0, 2, m).astype(bool)
        vals = [obj_pool[i] if i < len(obj_pool) else tv.Pointer(int(rng.integers(0, 2**63)))
                for i in rng.integers(0, len(obj_pool) + 1, m)]
        return _obj(vals)

    for _trial in range(25):
        m = int(rng.integers(1, 60))
        arity = int(rng.integers(1, 4))
        data = [column(int(rng.integers(0, 5)), m) for _ in range(arity)]
        keys = [tv.Pointer(int(x)) for x in rng.integers(0, 2**63, m)]
        n = int(rng.choice(NS))
        which = int(rng.integers(0, 3))
        if which == 0:
            rule = ("key",)
        elif which == 1:
            rule = ("cols", sorted(rng.choice(arity, int(rng.integers(1, arity + 1)),
                                              replace=False).tolist()))
        else:
            rule = ("col", int(rng.integers(0, arity)))
        _routed(rule, data, keys, n)


# -- the batched digests ----------------------------------------------------------------


def test_shards_of_values_mixes_pointers_and_values(mode):
    values = [tv.Pointer(2**100 + 12345), 3, "s", None, tv.Pointer(17), 2.5, (1, "x"), True]
    for n in NS:
        got = tr.shards_of_values(values, n)
        want = jr.shards_of_values([_to_ref(v) for v in values], n)
        assert got.tolist() == want.tolist() == [tr._shard_of(v, n) for v in values]


def test_shards_of_values_takes_the_repr_detour(mode):
    """A Json whose digest raises TypeError routes by its ``repr``, in both packages."""
    poison = tv.Json({1: "a", "b": 2})
    with pytest.raises(TypeError):
        tv.hash_values((poison,))
    for n in NS:
        want = int(tv.hash_values((repr(poison),), salt=b"shard")) % n
        assert tr._shard_of(poison, n) == want
        assert tr.shards_of_values([poison, 1], n).tolist() == [want, tr._shard_of(1, n)]
        assert jr.shards_of_values([_to_ref(poison), 1], n).tolist() == [want, tr._shard_of(1, n)]


def test_object_codes_group_by_digest_identity(mode):
    values = [True, 1, 1, "a", "a", None, True, 2.5]
    codes = tr._object_codes(_obj(values))
    groups = defaultdict(set)
    for v, c in zip(values, codes.tolist()):
        groups[int(c)].add((type(v).__name__, v))
    assert all(len(members) == 1 for members in groups.values())
    assert codes[0] != codes[1]  # True and 1 are two classes
    jcodes = jr._object_codes(_obj(values))
    # the same partition of the rows (the code values themselves may differ)
    assert len(set(zip(codes.tolist(), jcodes.tolist()))) == len(set(codes.tolist()))


def test_reshard_moves_counts_the_reference_s_moves(mode):
    rng = np.random.default_rng(SEED + 7)
    keys = [tv.Pointer(int(x)) for x in rng.integers(0, 2**63, 500)]
    values = [f"w{i}" for i in rng.integers(0, 200, 300)]
    for n_old, n_new in ((2, 3), (3, 1), (4, 4), (1, 7)):
        for vals in (keys, values):
            got = tr.reshard_moves(vals, n_old, n_new)
            assert got == jr.reshard_moves([_to_ref(v) for v in vals], n_old, n_new)
            want = sum(tr._shard_of(v, n_old) != tr._shard_of(v, n_new) for v in vals)
            assert got == want
    assert tr.reshard_moves([], 2, 3) == 0


def test_batch_shards_takes_columns_or_entries(mode):
    keys = _keys(30, "b")
    col = np.arange(30) % 4
    tcols, jcols = _both([col], keys)
    columnar = tb.DeltaBatch.from_columns(tcols)
    rows = tb.DeltaBatch(list(columnar.entries))
    for rule in (("key",), ("col", 0), ("cols", [0])):
        want = jr.batch_shards(rule, jb.DeltaBatch.from_columns(jcols), 3).tolist()
        assert tr.batch_shards(rule, columnar, 3).tolist() == want
        assert tr.batch_shards(rule, rows, 3).tolist() == want
    assert tr.batch_shards(("pin",), rows, 3) is None


# -- columnarize_entries: the row -> columnar way into the exchange ----------------------


def test_columnarize_entries_round_trips(mode):
    entries = [(tv.ref_scalar(i), (i, float(i) * 0.5, f"s{i % 3}"), 1) for i in range(10)]
    cb = tb.columnarize_entries(tb.DeltaBatch(entries).consolidate())
    assert cb is not None and cb.columns is not None
    assert cb.entries == entries
    mixed = [(tv.ref_scalar(i), (i if i % 2 else str(i),), 1) for i in range(8)]
    cb = tb.columnarize_entries(tb.DeltaBatch(mixed).consolidate())
    assert cb is not None and cb.columns.cols[0].dtype == object
    assert cb.entries == mixed


def test_columnarize_entries_rejects_ragged_and_raw_batches(mode):
    ragged = [(tv.ref_scalar(0), (1, 2), 1), (tv.ref_scalar(1), (1, 2, 3), 1)]
    assert tb.columnarize_entries(tb.DeltaBatch(ragged).consolidate()) is None
    assert tb.columnarize_entries(tb.DeltaBatch([(tv.ref_scalar(0), (1,), 1)])) is None
