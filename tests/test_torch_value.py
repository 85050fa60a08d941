"""Row keys are content hashes: the port's ``hash_values`` and ``ref_scalar`` must give
the JAX package's keys bit for bit, over a seeded set of values that covers every type
the digest serializes (int, negative and big ints, floats that equal ints, -0.0, nan,
inf, str, bytes, None, bool, tuples, nested tuples, lists, arrays, Pointers, Json, the
error sentinel) and the salts the engine uses."""

import datetime

import numpy as np
import pytest

from pathway_tpu.engine import value as jv
from pathway_tpu_torch.engine import value as tv

SALTS = [b"", b"connector", b"errlog", b"inst"]


def _scalars(rng: np.random.Generator, side) -> list:
    ints = [int(x) for x in rng.integers(-(2**62), 2**62, 6)]
    floats = [float(x) for x in rng.normal(size=4) * 1e3]
    words = ["", "a", "python-connector", "q", "naïve café", "東京"]
    return [
        0, 1, -1, 2**63, -(2**100), *ints,
        0.0, -0.0, 1.0, -3.0, 2.5, float("nan"), float("inf"), -float("inf"), 1e300,
        *floats,
        *words, b"", b"\x00\xff", True, False, None,
        side.Pointer(12345), side.Pointer(2**127 + 3),
        np.int64(7), np.float32(0.5),
        side.Json({"a": [1, 2], "b": "x"}),
        datetime.timedelta(seconds=1.5),
        side.ERROR,
    ]


def _values(side, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    flat = _scalars(rng, side)
    arr = rng.normal(size=(3, 2)).astype(np.float32)
    nested = [
        (1, "a"), ((1, 2), (3, (4, "x"))), [1, 2.5, None], (side.Pointer(9), b"z", -0.0),
        arr, np.arange(4, dtype=np.int64), (),
    ]
    return flat + nested


def test_pointer_type_and_rendering_match():
    for n in (0, 1, 31, 32, 2**64 + 5, 2**128 - 1, 2**128 + 7):
        assert int(tv.Pointer(n)) == int(jv.Pointer(n))
        assert repr(tv.Pointer(n)) == repr(jv.Pointer(n))


@pytest.mark.parametrize("salt", SALTS)
def test_hash_values_of_each_value_matches_jax(salt):
    for ours, theirs in zip(_values(tv), _values(jv)):
        assert int(tv.hash_values((ours,), salt=salt)) == int(
            jv.hash_values((theirs,), salt=salt)
        ), repr(ours)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_values_of_value_tuples_matches_jax(seed):
    ours, theirs = _values(tv, seed), _values(jv, seed)
    rng = np.random.default_rng(seed + 100)
    for _ in range(50):
        picks = rng.integers(0, len(ours), int(rng.integers(1, 6)))
        a = tuple(ours[i] for i in picks)
        b = tuple(theirs[i] for i in picks)
        for salt in SALTS:
            assert int(tv.hash_values(a, salt=salt)) == int(jv.hash_values(b, salt=salt))


def test_ref_scalar_matches_jax():
    ours, theirs = _values(tv), _values(jv)
    for a, b in zip(ours, theirs):
        assert int(tv.ref_scalar(a)) == int(jv.ref_scalar(b))
        assert int(tv.ref_scalar(a, "x", 3)) == int(jv.ref_scalar(b, "x", 3))
        assert int(tv.ref_scalar(a, instance=5)) == int(jv.ref_scalar(b, instance=5))
    assert int(tv.ref_scalar()) == int(jv.ref_scalar())


def test_connector_keys_match_jax():
    """The python connector's key for the n-th row of a source."""
    for seq in range(1, 20):
        values = ("python-connector", "q", 0, seq)
        assert int(tv.hash_values(values, salt=b"connector")) == int(
            jv.hash_values(values, salt=b"connector")
        )


def test_error_sentinel_poisons_and_is_a_singleton():
    assert tv.Error() is tv.ERROR
    assert tv.is_error(tv.ERROR) and not tv.is_error(None)
    with pytest.raises(ValueError):
        bool(tv.ERROR)
    assert hash(tv.ERROR) == hash(jv.ERROR)
