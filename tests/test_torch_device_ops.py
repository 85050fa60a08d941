"""The port's device operators (``pathway_tpu_torch/engine/device_ops.py``) on
``device="cpu"`` against the JAX package's host specs: ``segment_reduce_dispatch``
against ``device.segment_count`` / ``device.segment_sum``, ``match_pairs`` against
``graph._match_join_pairs`` / ``_match_join_pairs_multi``. The JAX device functions
cannot be the reference on a machine without ``jax.experimental.enable_x64``; the host
specs are what they are held to. Every comparison is bit for bit (floats through their
int64 views): the operators add in the spec's order and emit the spec's pair order.

The cases are those of the JAX package's ``tests/test_device_ops.py``: retractions,
NaN values, an empty batch, groups without rows, duplicate int keys, the swap rule,
multi-column keys, an empty side, no matches, -0.0 float keys, NaN keys declined to the
host."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pathway_tpu.engine import device as jdevice
from pathway_tpu.engine import graph as jgraph
from pathway_tpu_torch.engine import device as tdevice
from pathway_tpu_torch.engine import device_ops as dops
from pathway_tpu_torch.engine import graph as tgraph
from pathway_tpu_torch.ops import segment_reduce as sr


@pytest.fixture(autouse=True)
def _cpu_operators():
    dops.configure(device="cpu")
    dops.reset_counters()
    yield
    dops.configure()


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int64) if a.dtype == np.float64 else a


def _check_segments(inverse, diffs, vals, nu):
    gd, deltas = dops.segment_reduce_dispatch(inverse, diffs, vals, nu).fetch()
    ref_gd = jdevice.segment_count(inverse, diffs, nu)
    assert gd.dtype == ref_gd.dtype
    assert np.array_equal(gd, ref_gd)
    for got, col in zip(deltas, vals):
        if col is None:
            assert got is None
            continue
        ref = jdevice.segment_sum(inverse, col, diffs, nu)
        if ref.size:  # np.bincount types an empty output int64 whatever the weights
            assert got.dtype == ref.dtype
            assert np.array_equal(_bits(got), _bits(ref))


def _zipf_index(rng, n, groups, s=1.1):
    """Zipf(s) over ``[0, groups)``: a draw past the last group is drawn again, so group
    0 keeps its own share of the rows."""
    inverse = rng.zipf(s, n) - 1
    out = inverse >= groups
    while out.any():
        inverse[out] = rng.zipf(s, int(out.sum())) - 1
        out = inverse >= groups
    return inverse.astype(np.int64)


def _segment_case(name: str):
    rng = np.random.default_rng(7)
    if name == "int_and_float_with_retractions":
        n, nu = 777, 13
        return (
            rng.integers(0, nu, n).astype(np.int64),
            rng.choice([-1, 1], n).astype(np.int64),
            [
                rng.integers(-1000, 1000, n).astype(np.int64),
                None,
                (rng.integers(-64, 64, n) * 0.25).astype(np.float64),
            ],
            nu,
        )
    if name == "float_rounding_order":
        # values whose sum depends on the order of the adds: only the spec's row
        # order gives the spec's bits
        n, nu = 4000, 5
        return (
            rng.integers(0, nu, n).astype(np.int64),
            rng.choice([-1, 1], n).astype(np.int64),
            [rng.standard_normal(n) * 10.0 ** rng.integers(-8, 9, n)],
            nu,
        )
    if name == "nan_values":
        return (
            np.array([0, 1, 0, 1, 2], np.int64),
            np.array([1, 1, -1, 1, 1], np.int64),
            [np.array([1.5, np.nan, 1.5, 2.0, 3.0], np.float64)],
            3,
        )
    if name == "empty_batch":
        empty = np.empty(0, np.int64)
        return empty, empty, [np.empty(0, np.float64)], 0
    if name == "groups_without_rows":
        return np.array([0, 0], np.int64), np.array([1, -1], np.int64), [np.array([2.5, 2.5])], 5
    if name == "bool_and_wrapping_int":
        n = 64
        big = np.full(n, (1 << 62), np.int64)
        return (
            np.zeros(n, np.int64),
            np.ones(n, np.int64),
            [rng.integers(0, 2, n).astype(bool), big],  # the int64 sum wraps
            1,
        )
    if name == "every_row_its_own_group":
        # the [rows, rows] shape of the card's timing, shuffled: each group one row
        n = 300
        return (
            rng.permutation(n).astype(np.int64),
            rng.choice([-1, 1], n).astype(np.int64),
            [rng.integers(-1000, 1000, n).astype(np.int64), rng.standard_normal(n)],
            n,
        )
    if name == "int64_wrapping_at_the_edges":
        # INT64_MIN / INT64_MAX weights and diffs of both signs: the sums wrap
        n, nu = 96, 4
        edges = np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 1], np.int64)
        return (
            np.arange(n, dtype=np.int64) % nu,
            rng.choice([-1, 1], n).astype(np.int64),
            [edges[rng.integers(0, 4, n)], edges[np.arange(n) % 4]],
            nu,
        )
    if name == "nan_inf_and_negative_zero":
        # +-inf meeting in one group gives NaN; a group of -0.0 alone sums to +0.0 (the
        # host accumulator starts at +0.0); NaN poisons only its own group
        vals = np.array([np.inf, -np.inf, -0.0, -0.0, np.nan, 1.0, np.inf, 2.5], np.float64)
        return (
            np.array([0, 0, 1, 1, 2, 3, 4, 4], np.int64),
            np.array([1, 1, 1, 1, 1, 1, 1, -1], np.int64),
            [vals, vals.copy()],
            6,  # group 5 has no rows
        )
    if name == "several_int_and_float_columns":
        n, nu = 5000, 300  # 9 bits: one partition pass
        return (
            rng.integers(0, nu, n).astype(np.int64),
            rng.choice([-1, 1], n).astype(np.int64),
            [
                rng.standard_normal(n) * 10.0 ** rng.integers(-8, 9, n),
                rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
                None,
                rng.standard_normal(n),
                rng.integers(0, 2, n).astype(bool),
                (rng.integers(-64, 64, n) * 0.5).astype(np.float64),
            ],
            nu,
        )
    if name == "zipf_skewed_index":
        # one hot group of thousands of rows (a warp's run on the card) beside a long
        # tail of short ones and empty groups, over 12 bits: two partition passes
        n, nu = 20_000, 4096
        return (
            _zipf_index(rng, n, nu),
            rng.choice([-1, 1], n).astype(np.int64),
            [rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n), rng.integers(-1000, 1000, n)],
            nu,
        )
    raise KeyError(name)


SEGMENT_CASES = [
    "int_and_float_with_retractions",
    "float_rounding_order",
    "nan_values",
    "empty_batch",
    "groups_without_rows",
    "bool_and_wrapping_int",
    "every_row_its_own_group",
    "int64_wrapping_at_the_edges",
    "nan_inf_and_negative_zero",
    "several_int_and_float_columns",
    "zipf_skewed_index",
]


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_segment_reduce_dispatch_matches_the_host_spec(case):
    _check_segments(*_segment_case(case))


def test_nan_values_poison_the_same_groups():
    inverse, diffs, vals, nu = _segment_case("nan_values")
    _gd, (delta,) = dops.segment_reduce_dispatch(inverse, diffs, vals, nu).fetch()
    assert np.isnan(delta[1]) and not np.isnan(delta[0])


def test_ordered_segment_sum_plain_version_adds_in_row_order():
    """The float path's plain versions (the partition, then the fold of each run)
    against a Python loop of the same adds, and the partition against NumPy's stable
    argsort."""
    rng = np.random.default_rng(11)
    n, nu = 500, 7
    inverse = rng.integers(0, nu, n)
    w = rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n)
    payload, ends = sr.partition(torch.from_numpy(inverse), torch.from_numpy(w[None]), nu)
    got = sr.fold_runs(payload, ends, nu)[0].numpy()
    want = np.zeros(nu)
    for i in range(n):
        want[inverse[i]] += w[i]
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    order = np.argsort(inverse, kind="stable")
    assert np.array_equal(payload[0].numpy(), w[order])
    assert ends.tolist() == np.cumsum(np.bincount(inverse, minlength=nu)).tolist()


def test_ordered_segment_sum_raises_on_other_devices():
    w = torch.zeros((1, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        sr.segment_reduce(w[0].long(), w.long(), w, 2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        sr.fold_runs(w, None, 1)


def _match_case(name: str):
    rng = np.random.default_rng(3)
    if name == "int_keys_with_duplicates":
        return [rng.integers(0, 40, 300).astype(np.int64)], [rng.integers(0, 40, 90).astype(np.int64)]
    if name == "swap_rule":  # the smaller side is the haystack either way round
        return [rng.integers(0, 40, 90).astype(np.int64)], [rng.integers(0, 40, 300).astype(np.int64)]
    if name == "multi_column_keys":
        rng = np.random.default_rng(5)
        return (
            [rng.integers(0, 9, 200).astype(np.int64), (rng.integers(0, 5, 200) * 0.5)],
            [rng.integers(0, 9, 60).astype(np.int64), (rng.integers(0, 5, 60) * 0.5)],
        )
    if name == "empty_side":
        return [np.array([1, 2, 3], np.int64)], [np.empty(0, np.int64)]
    if name == "no_matches":
        return [np.array([1, 2], np.int64)], [np.array([7, 8], np.int64)]
    if name == "negative_zero_float_keys":
        return [np.array([0.0, 1.0])], [np.array([-0.0, 2.0])]
    if name == "bool_keys":
        return [np.array([True, False, True])], [np.array([True, True])]
    raise KeyError(name)


MATCH_CASES = [
    "int_keys_with_duplicates",
    "swap_rule",
    "multi_column_keys",
    "empty_side",
    "no_matches",
    "negative_zero_float_keys",
    "bool_keys",
]


@pytest.mark.parametrize("case", MATCH_CASES)
def test_match_pairs_matches_the_host_matcher(case):
    l_arrays, r_arrays = _match_case(case)
    got = dops.match_pairs(l_arrays, r_arrays)
    assert got is not None
    ref = jgraph._match_join_pairs_multi(l_arrays, r_arrays)
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    if len(l_arrays) == 1:
        single = jgraph._match_join_pairs(
            jgraph._as_match_codes(l_arrays[0]), jgraph._as_match_codes(r_arrays[0])
        )
        assert np.array_equal(got[0], single[0]) and np.array_equal(got[1], single[1])
    # the port's own host matcher is the same function
    own = tgraph._match_join_pairs_multi(l_arrays, r_arrays)
    assert np.array_equal(own[0], ref[0]) and np.array_equal(own[1], ref[1])


@pytest.mark.parametrize(
    "keys",
    [np.array([1.0, np.nan]), np.array(["a", "b"]), np.array([object(), 1], dtype=object)],
    ids=["nan", "str", "object"],
)
def test_match_pairs_declines_keys_without_an_int64_code_view(keys):
    assert dops.match_pairs([keys], [keys]) is None


def test_accounting_and_the_escape_hatch(monkeypatch):
    inverse, diffs, vals, nu = _segment_case("nan_values")
    dops.segment_reduce_dispatch(inverse, diffs, vals, nu).fetch()
    dops.match_pairs(*_match_case("no_matches"))
    assert dops.hit_counts() == {"segment_reduce": 1, "match_pairs": 1}
    assert set(dops.kernel_ns()) == {"segment_reduce", "match_pairs"}
    stats = dops.stats()
    assert stats["enabled"] and stats["device"] == "cpu"
    dops.reset_counters()
    assert dops.hit_counts() == {}
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "0")
    assert not dops.enabled()
    monkeypatch.setenv("PATHWAY_TPU_DEVICE_OPS", "1")
    assert dops.enabled()


def test_the_card_is_the_default_device(monkeypatch):
    """``configure()`` names the card: with no card, the first operator raises rather
    than running on the CPU."""
    dops.configure()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dops.segment_reduce_dispatch(*_segment_case("nan_values"))


@pytest.mark.parametrize(
    "fn", ["factorize", "factorize_multi", "segment_count", "segment_sum", "int_sum_overflow_risk"]
)
def test_host_kernels_are_the_reference_ones(fn):
    rng = np.random.default_rng(1)
    a = rng.integers(0, 9, 100)
    b = (rng.integers(0, 4, 100) * 0.5)
    inv = rng.integers(0, 5, 100)
    d = rng.choice([-1, 1], 100)
    args = {
        "factorize": (b,),
        "factorize_multi": ([a, b],),
        "segment_count": (inv, d, 5),
        "segment_sum": (inv, b, d, 5),
        "int_sum_overflow_risk": (a, 100, 1),
    }[fn]
    got, ref = getattr(tdevice, fn)(*args), getattr(jdevice, fn)(*args)
    if isinstance(ref, tuple):
        for x, y in zip(got, ref):
            assert np.array_equal(np.asarray(x), np.asarray(y))
    else:
        assert np.array_equal(np.asarray(got), np.asarray(ref))


def test_columnarize_entries_matches_the_reference():
    """The columnar twin of a consolidated insert-only row batch: the same key bytes
    and column arrays as the JAX package's, and the same rows back."""
    from pathway_tpu.engine import batch as jbatch
    from pathway_tpu.engine.value import ref_scalar as jref
    from pathway_tpu_torch.engine import batch as tbatch
    from pathway_tpu_torch.engine.value import ref_scalar as tref

    rows = [(i, i * 0.5, f"s{i}", None if i % 3 else (i,)) for i in range(50)]
    got = tbatch.DeltaBatch([(tref(i), r, 1) for i, r in enumerate(rows)]).consolidate()
    ref = jbatch.DeltaBatch([(jref(i), r, 1) for i, r in enumerate(rows)]).consolidate()
    tc, jc = tbatch.columnarize_entries(got), jbatch.columnarize_entries(ref)
    assert np.array_equal(tc.columns.kbytes(), jc.columns.kbytes())
    for a, b in zip(tc.columns.cols, jc.columns.cols):
        assert a.dtype == b.dtype and a.tolist() == b.tolist()
    assert tc.entries == got.entries
    ragged = tbatch.DeltaBatch([(tref(0), (1,), 1), (tref(1), (1, 2), 1)]).consolidate()
    assert tbatch.columnarize_entries(ragged) is None
