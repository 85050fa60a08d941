"""The port's ``DeviceKnnIndex`` (on CPU tensors) against the JAX package's
``DeviceKnnIndex`` and ``HostKnnIndex`` through adds, replacements, removals, growth
past capacity, read views and ``op_state`` round trips. Vectors are small integers, so
every score is exact and hits must be equal, slots and order included."""

import numpy as np
import pytest
import torch

from pathway_tpu.engine import external_index as jidx
from pathway_tpu_torch.engine import external_index as tidx

DIM = 8


def _vecs(seed, n):
    rng = np.random.default_rng(seed)
    v = rng.integers(-3, 4, (n, DIM)).astype(np.float32)
    v[np.abs(v).sum(axis=1) == 0, 0] = 1.0  # no zero rows (cos of 0 is 0/eps)
    return v


def _indexes(metric, capacity=8):
    return [
        jidx.DeviceKnnIndex(dim=DIM, metric=metric, capacity=capacity),
        jidx.HostKnnIndex(dim=DIM, metric=metric, capacity=capacity),
        tidx.DeviceKnnIndex(dim=DIM, metric=metric, capacity=capacity, device="cpu"),
        tidx.HostKnnIndex(dim=DIM, metric=metric, capacity=capacity),
    ]


def _same_answers(indexes, queries, k):
    answers = [ix.search(list(queries), k) for ix in indexes]
    for other in answers[1:]:
        assert other == answers[0]
    return answers[0]


def _same_slots(indexes):
    for ix in indexes[1:]:
        assert ix.key_to_slot == indexes[0].key_to_slot
        assert ix._free == indexes[0]._free
        assert ix.capacity == indexes[0].capacity


@pytest.mark.parametrize("metric", ["cos", "l2sq", "dot"])
def test_lifecycle_matches_jax(metric):
    indexes = _indexes(metric)
    data = _vecs(0, 40)
    data[30:34] = data[2]  # duplicates: ties decided by slot ids
    queries = _vecs(1, 6)
    queries[0] = data[2]
    # commit 1: 6 rows; commit 2: 14 more, growing past capacity 8 -> 32
    for ix in indexes:
        ix.add([f"d{i}" for i in range(6)], list(data[:6]))
    _same_slots(indexes)
    for ix in indexes:
        ix.add([f"d{i}" for i in range(6, 20)], list(data[6:20]))
    _same_slots(indexes)
    assert indexes[2].capacity == 32 and len(indexes[2]) == 20
    _same_answers(indexes, queries, 5)
    # replace some keys, remove some, add duplicates
    for ix in indexes:
        ix.add(["d3", "d7", "d30"], [data[30], data[31], data[32]])
        ix.remove(["d1", "d8", "missing"])
        ix.add([f"d{i}" for i in range(33, 40)], list(data[33:40]))
    _same_slots(indexes)
    hits = _same_answers(indexes, queries, 7)
    assert all(len(h) == 7 for h in hits)
    assert _same_answers(indexes, queries, 64)  # k past capacity


def test_read_view_is_frozen_and_op_state_round_trips():
    indexes = _indexes("cos")
    data, queries = _vecs(2, 30), _vecs(3, 4)
    for ix in indexes:
        ix.add(list(range(12)), list(data[:12]))
    views = [ix.read_view() for ix in indexes]
    snaps = [ix.op_state() for ix in indexes]
    before = _same_answers(views, queries, 4)
    for ix in indexes:
        ix.add(list(range(12, 30)), list(data[12:30]))
        ix.remove([0, 1, 2])
    assert _same_answers(views, queries, 4) == before  # views did not move
    after = _same_answers(indexes, queries, 4)
    assert after != before
    for ix, snap in zip(indexes, snaps):
        ix.restore_op_state(snap)
    _same_slots(indexes)
    assert _same_answers(indexes, queries, 4) == before
    # the snapshot does not alias the live buffers: mutating after restore keeps it
    port = indexes[2]
    port.add([99], [data[29]])
    assert not np.array_equal(snaps[2]["valid"], port.state.valid.numpy())


def test_tensor_rows_take_the_device_run():
    """A [n, dim] tensor, and row views of one, go through _add_device_run and
    land where host vectors land."""
    data, queries = _vecs(4, 20), _vecs(5, 3)
    a = tidx.DeviceKnnIndex(dim=DIM, capacity=16, device="cpu")
    b = tidx.DeviceKnnIndex(dim=DIM, capacity=16, device="cpu")
    runs = []
    a._add_device_run = lambda keys, dev, idx, f=a._add_device_run: runs.append(len(keys)) or f(keys, dev, idx)
    block = torch.from_numpy(np.concatenate([data, data]))  # parent of the row views
    a.add(range(10), block[:10])  # a tensor
    a.add(range(10, 20), list(block[30:40]))  # row views of one tensor, out of order offset
    b.add(range(10), list(data[:10]))
    b.add(range(10, 20), list(data[10:20]))
    assert runs == [10, 10]
    assert a.key_to_slot == b.key_to_slot
    assert torch.equal(a.state.vectors, b.state.vectors)
    # replacements fall back to the host path, and still land
    a.add([3], block[15:16])
    b.add([3], [data[15]])
    assert runs == [10, 10, 1]
    assert a.search(torch.from_numpy(queries), 5) == b.search(list(queries), 5)
    assert a.search(list(torch.from_numpy(queries)), 5) == b.search(list(queries), 5)


def test_mixed_rows_group_by_parent():
    data = _vecs(6, 12)
    a = tidx.DeviceKnnIndex(dim=DIM, capacity=16, device="cpu")
    b = tidx.HostKnnIndex(dim=DIM, capacity=16)
    p1, p2 = torch.from_numpy(data[:6]), torch.from_numpy(data[6:])
    rows = [p1[0], p2[0], data[11], p1[3], p2[1]]
    a.add(list("abcde"), rows)
    b.add(list("abcde"), [data[0], data[6], data[11], data[3], data[7]])
    assert set(a.key_to_slot) == set(b.key_to_slot)
    q = _vecs(7, 2)
    assert [sorted(h) for h in a.search(list(q), 5)] == [sorted(h) for h in b.search(list(q), 5)]


def test_pack_results_is_one_int32_tensor():
    scores = torch.tensor([[0.5, -float("inf")]])
    slots = torch.tensor([[3, 8]])
    packed = tidx._pack_results(scores, slots)
    assert packed.dtype == torch.int32 and packed.shape == (2, 1, 2)
    assert packed[0].numpy().view(np.float32)[0, 0] == 0.5


def test_entry_points_need_a_device_where_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tidx.DeviceKnnIndex(dim=DIM)
