"""The port's segment reduction (``pathway_tpu_torch/ops/segment_reduce.py``) stage by
stage on CPU tensors, where every wrapper takes its plain PyTorch version, against the
JAX package's host specs (``pathway_tpu/engine/device.py``: ``segment_count`` /
``segment_sum``, that is ``np.add.at`` and ``np.bincount``) and NumPy's stable argsort.
The JAX device function (``device_ops._scatter_add``) cannot run on a machine without
``jax.experimental.enable_x64``; the host specs are what it is held to as well. Every
comparison is bit for bit (tolerance 0: the spec is exact; floats through their int64
views).

The pass plan, the tile count and where the run ends come from are Python that the
card's route shares, so these tests reach them; the kernels themselves are held to the
same plain versions by the ``gpu`` twins in ``tests/test_torch_gpu.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pathway_tpu.engine import device as jdevice
from pathway_tpu_torch.ops import segment_reduce as sr

INT64_MIN, INT64_MAX = np.iinfo(np.int64).min, np.iinfo(np.int64).max


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int64) if a.dtype == np.float64 else a


def _index(n: int, groups: int, rng) -> np.ndarray:
    """Random group indices that reach both ends of ``[0, groups)``."""
    inverse = rng.integers(0, groups, n)
    if n >= 2:
        inverse[0], inverse[-1] = groups - 1, 0
    return inverse.astype(np.int64)


@pytest.mark.parametrize(
    "groups, plan",
    [
        (1, []),
        (2, [(0, 1)]),
        (255, [(0, 8)]),
        (256, [(0, 8)]),
        (257, [(0, 9)]),
        (2048, [(0, 11)]),
        (2049, [(0, 6), (6, 6)]),
        (4096, [(0, 6), (6, 6)]),
        (1 << 20, [(0, 10), (10, 10)]),
        ((1 << 20) + 1, [(0, 11), (11, 10)]),
        (1 << 22, [(0, 11), (11, 11)]),
        ((1 << 22) + 1, [(0, 8), (8, 8), (16, 7)]),
    ],
)
def test_radix_passes_cover_the_index_bits_in_even_digits(groups, plan):
    assert sr.radix_passes(groups) == plan
    bits = sum(b for _s, b in plan)
    assert (1 << bits) >= groups and (bits == 0 or (1 << (bits - 1)) < groups)
    assert all(1 <= b <= sr.MAX_DIGIT_BITS for _s, b in plan)


@pytest.mark.parametrize("groups", [1, 2, 255, 256, 257, 2048, 2049, (1 << 20) + 1])
def test_partition_plain_version_is_numpys_stable_argsort(groups):
    """The partition's plain version (one ``torch.sort(stable=True)`` per digit) gives
    the rows in ``np.argsort(kind="stable")`` order with every float column carried
    along, and run ends that are the host's cumulative counts."""
    rng = np.random.default_rng(groups)
    n = 9000  # five tiles of the card's partition, the last one ragged
    inverse = _index(n, groups, rng)
    w = rng.standard_normal((2, n))
    payload, ends = sr.partition(torch.from_numpy(inverse), torch.from_numpy(w), groups)
    order = np.argsort(inverse, kind="stable")
    assert np.array_equal(_bits(payload.numpy()), _bits(w[:, order]))
    if ends is None:
        assert groups == 1
    else:
        assert ends.dtype == torch.int32
        assert np.array_equal(ends.numpy(), np.cumsum(np.bincount(inverse, minlength=groups)))


@pytest.mark.parametrize("shift, bits", [(0, 3), (2, 4), (0, 11), (6, 6)])
def test_radix_pass_plain_version_gives_each_digits_end(shift, bits):
    """One pass: the rows stably by digit, keys narrowed to int32, and where each
    digit's rows end, which after a single pass are the runs' ends."""
    rng = np.random.default_rng(bits)
    n = 2 * sr.TILE_ROWS + 123
    keys = rng.integers(0, 1 << (shift + bits), n).astype(np.int64)
    payload = rng.standard_normal((1, n))
    keys_out, payload_out, digit_end = sr.radix_pass(
        torch.from_numpy(keys), torch.from_numpy(payload), shift, bits
    )
    digit = (keys >> shift) & ((1 << bits) - 1)
    order = np.argsort(digit, kind="stable")
    assert keys_out.dtype == torch.int32 and np.array_equal(keys_out.numpy(), keys[order])
    assert np.array_equal(payload_out.numpy(), payload[:, order])
    assert digit_end.dtype == torch.int32
    assert np.array_equal(digit_end.numpy(), np.cumsum(np.bincount(digit, minlength=1 << bits)))


def test_run_ends_plain_version():
    keys = torch.tensor([0, 0, 2, 2, 2, 5], dtype=torch.int32)
    assert sr.run_ends(keys, 7).tolist() == [2, 2, 5, 5, 5, 6, 6]


def test_fold_runs_plain_version_adds_each_run_in_order_from_positive_zero():
    rng = np.random.default_rng(3)
    lens = np.array([0, 1, 31, 32, 33, 700, 0, 5])
    ends = np.cumsum(lens).astype(np.int32)
    w = rng.standard_normal((2, int(ends[-1]))) * 10.0 ** rng.integers(-8, 9, (2, int(ends[-1])))
    w[1, :1] = -0.0
    got = sr.fold_runs(torch.from_numpy(w), torch.from_numpy(ends), len(lens)).numpy()
    want = np.zeros((2, len(lens)))
    for c in range(2):
        for g in range(len(lens)):
            acc = 0.0
            for j in range(ends[g] - lens[g], ends[g]):
                acc += w[c, j]
            want[c, g] = acc
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    assert np.signbit(got[:, 0]).tolist() == [False, False]  # an empty run is +0.0


def test_segment_sum_int_plain_version_wraps():
    inverse = torch.tensor([0, 0, 1, 1, 2], dtype=torch.int64)
    w = torch.tensor([[INT64_MAX, 1, INT64_MIN, -1, 7], [INT64_MIN, INT64_MIN, 3, 4, 0]])
    got = sr.segment_sum_int(inverse, w, 3).numpy()
    want = np.zeros((2, 3), np.int64)
    for c in range(2):
        np.add.at(want[c], inverse.numpy(), w[c].numpy())
    assert np.array_equal(got, want) and got[0, 0] == INT64_MIN and got[1, 0] == 0


@pytest.mark.parametrize("n", [0, 1, 1000])
@pytest.mark.parametrize("groups", [1, 3, 2049])
def test_segment_reduce_matches_the_host_spec(n, groups):
    rng = np.random.default_rng(n + groups)
    inverse = _index(n, groups, rng)
    w_int = rng.integers(INT64_MIN, INT64_MAX, (2, n), dtype=np.int64, endpoint=True)
    w_float = rng.standard_normal((2, n)) * 10.0 ** rng.integers(-8, 9, (2, n))
    ones = np.ones(n, np.int64)
    got = sr.segment_reduce(torch.from_numpy(inverse), torch.from_numpy(w_int),
                            torch.from_numpy(w_float), groups).numpy()
    assert got.shape == (4, groups)
    for c in range(2):
        assert np.array_equal(got[c], jdevice.segment_count(inverse, w_int[c], groups))
        ref = jdevice.segment_sum(inverse, w_float[c], ones, groups)
        assert np.array_equal(got[2 + c], _bits(ref))
    plain = sr.segment_reduce_reference(torch.from_numpy(inverse), torch.from_numpy(w_int),
                                        torch.from_numpy(w_float), groups)
    assert np.array_equal(got, plain.numpy())


def test_segment_reduce_with_no_float_column_takes_no_partition(monkeypatch):
    def no_partition(*_a, **_k):
        raise AssertionError("the int path took the partition")

    monkeypatch.setattr(sr, "_partition", no_partition)  # both routes partition through it
    inverse = torch.tensor([1, 0, 1], dtype=torch.int64)
    w_int = torch.tensor([[1, 2, 3]])
    got = sr.segment_reduce(inverse, w_int, torch.empty((0, 3), dtype=torch.float64), 2)
    assert got.tolist() == [[2, 4]]


def test_segment_reduce_checks_what_it_takes():
    inverse = torch.zeros(4, dtype=torch.int64)
    w_int = torch.zeros((1, 4), dtype=torch.int64)
    w_float = torch.zeros((1, 4), dtype=torch.float64)
    with pytest.raises(TypeError):
        sr.segment_reduce(inverse.int(), w_int, w_float, 1)
    with pytest.raises(TypeError):
        sr.segment_reduce(inverse, w_int, w_float.float(), 1)
    with pytest.raises(ValueError):
        sr.segment_reduce(inverse, w_int[:, :3], w_float, 1)
    with pytest.raises(ValueError):
        sr.segment_reduce(inverse, w_int.t(), w_float, 1)
    with pytest.raises(ValueError):
        sr.segment_reduce(inverse, w_int, w_float, 0)
    with pytest.raises(ValueError):
        sr.segment_reduce(inverse, w_int, w_float, -1)
    with pytest.raises(ValueError):
        sr.radix_pass(inverse, w_float, 0, sr.MAX_DIGIT_BITS + 1)


def test_dadd_chain_plain_version_rounds_every_add():
    assert sr.dadd_chain(torch.tensor([0.0, 1.0], dtype=torch.float64), 1000).item() == 1000.0
    # 1 + 2^-53 rounds back to 1 (ties to even) at every step of the chain
    tiny = torch.tensor([1.0, 2.0**-53], dtype=torch.float64)
    assert sr.dadd_chain(tiny, 64).item() == 1.0
