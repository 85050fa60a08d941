"""Lazy device rows on CPU tensors: ``device_runs`` partitions mixed sequences as the
JAX package's does; the host twin equals the tensor; ``decay`` drops the device copy
and keeps the host twin; the synchronous commit boundary decays every batch of the
commit, and the async one defers that to its completion thread until ``drain()``; and
``DeviceKnnIndex.add`` of lazy rows takes the device route and leaves the state an add
of the same rows as numpy arrays leaves, bit for bit."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.engine import device as jdev
from pathway_tpu_torch.engine import device as tdev
from pathway_tpu_torch.engine import device_pipeline as dp
from pathway_tpu_torch.engine.external_index import DeviceKnnIndex
from pathway_tpu_torch.engine.graph import Scheduler, Scope


class _GatedEvent:
    """Stands in for the CUDA event behind a host twin's copy: ``synchronize`` blocks
    until the test opens the gate."""

    def __init__(self, gate: threading.Event) -> None:
        self._gate = gate

    def synchronize(self) -> None:
        if not self._gate.wait(timeout=30):
            raise TimeoutError("test gate never opened")


def _batches(side, rng, sizes):
    mats = [rng.normal(size=(n, 3)).astype(np.float32) for n in sizes]
    if side is jdev:
        return mats, [jdev.lazy_rows(jnp.asarray(m), len(m)) for m in mats]
    return mats, [tdev.lazy_rows(torch.from_numpy(m.copy()), len(m)) for m in mats]


def _sequence(side, seed: int) -> list:
    """Rows of three batches (the third decayed), host arrays and None, shuffled in
    blocks as upstream operators leave them."""
    rng = np.random.default_rng(seed)
    _mats, (a, b, c) = _batches(side, rng, (5, 4, 3))
    c[0].batch.decay()
    host = [np.ones(3, np.float32) * i for i in range(3)]
    pieces = [a[:2], [host[0]], b[1:3], a[2:], [None], c, b[:1], [host[1], host[2]], b[3:]]
    order = rng.permutation(len(pieces))
    return [row for i in order for row in pieces[i]]


def _runs(side, seq) -> list:
    return [(s, e, dev is None, idx) for s, e, dev, idx in side.device_runs(seq)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_runs_partition_as_jax(seed):
    ours, theirs = _runs(tdev, _sequence(tdev, seed)), _runs(jdev, _sequence(jdev, seed))
    assert ours == theirs
    assert any(not is_host for _s, _e, is_host, _i in ours)


def test_common_device_parent():
    rows = tdev.lazy_rows(torch.arange(6.0).reshape(3, 2), 3)
    dev, idx = tdev.common_device_parent([rows[2], rows[0]])
    assert idx == [2, 0] and dev.shape == (3, 2)
    other = tdev.lazy_rows(torch.zeros(1, 2), 1)
    assert tdev.common_device_parent([rows[0], other[0]]) is None
    assert tdev.common_device_parent([np.zeros(2)]) is None


def test_host_after_prefetch_equals_the_tensor():
    t = torch.randn(7, 5)
    rows = tdev.lazy_rows(t, 6)
    handle = rows[0].batch
    assert np.array_equal(handle.host(), t.numpy())
    for i, row in enumerate(rows):
        assert np.array_equal(np.asarray(row), t[i].numpy())
        assert row.dtype == np.float32 and row.shape == (5,) and len(row) == 5
    assert np.array_equal(np.asarray(rows[1], np.float64), t[1].numpy().astype(np.float64))


def test_decay_drops_the_device_copy_and_keeps_the_host_twin():
    t = torch.randn(4, 3)
    rows = tdev.lazy_rows(t, 4, prefetch=False)
    handle = rows[0].batch
    assert handle.dev is not None
    handle.decay()
    assert handle.dev is None
    assert np.array_equal(np.asarray(rows[3]), t[3].numpy())
    assert rows[3].dtype == np.float32  # read from the host twin now
    assert tdev.device_runs(rows) == [(0, 4, None, None)]


def test_lazy_rows_behave_like_arrays():
    rows = tdev.lazy_rows(torch.tensor([[1.0, 2.0]]), 1)
    row = rows[0]
    assert (row == np.array([1.0, 2.0])).all()
    with pytest.raises(TypeError):
        hash(row)
    assert list(row) == [1.0, 2.0] and row[1] == 2.0
    assert row.reshape(2, 1).shape == (2, 1)


@pytest.fixture
def fresh_pipeline():
    """The device pipeline is a process-wide singleton: drain and reconfigure it
    around the test, so no staged commit leaks in or out."""
    tdev._LIVE_HANDLES.clear()
    dp.PIPELINE.configure()
    yield
    tdev._LIVE_HANDLES.clear()
    dp.PIPELINE.configure()
    dp.PIPELINE.stop_worker()


def _one_device_commit() -> tuple[list, list]:
    """One commit of five rows through a batch UDF making lazy rows -> (the rows in
    state after the commit, the UDF's host copies of its outputs)."""
    scope = Scope()
    sess = scope.input_session(arity=1)
    made = []

    def rows_fn(rows):
        mat = torch.randn(len(rows), 2)
        made.append(mat.numpy().copy())
        return [(True, r) for r in tdev.lazy_rows(mat, len(rows))]

    applied = scope.batch_apply_table(sess, rows_fn, [0])
    sched = Scheduler(scope)
    for i in range(5):
        sess.insert(i, (i,))
    sched.commit()
    rows = [r[0] for r in applied.current.values()]
    assert len(rows) == 5 and all(isinstance(r, tdev.LazyDeviceVector) for r in rows)
    return rows, made


def test_commit_boundary_decays_every_batch_of_the_commit(fresh_pipeline, monkeypatch):
    """The synchronous boundary (``PATHWAY_TPU_ASYNC_DEVICE=0``) decays inline."""
    monkeypatch.setenv("PATHWAY_TPU_ASYNC_DEVICE", "0")
    rows, _made = _one_device_commit()
    assert all(r.batch.dev is None for r in rows)  # state holds host twins only
    assert tdev.device_batches_held() == 0
    assert dp.PIPELINE.inflight() == 0


def test_async_commit_boundary_defers_the_decay_until_drain(fresh_pipeline, monkeypatch):
    """The async boundary stages the commit: it returns while the completion thread
    still waits on the batch's copy, and after ``drain()`` the state holds host twins
    with the UDF's bits."""
    monkeypatch.setenv("PATHWAY_TPU_ASYNC_DEVICE", "1")
    gate = threading.Event()
    staged = []
    stage = tdev.stage_device_batches

    def stage_gated():
        # the copy of the commit's batch is held open, as a slow copy on the card is
        handles = stage()
        for handle in handles:
            handle._copied = _GatedEvent(gate)
            handle._pinned = handle.dev.clone()
        staged.extend(handles)
        return handles

    monkeypatch.setattr(tdev, "stage_device_batches", stage_gated)
    rows, made = _one_device_commit()
    assert staged and all(h.dev is not None for h in staged)  # deferred
    assert dp.PIPELINE.inflight() == 1
    gate.set()
    dp.drain()
    assert dp.PIPELINE.inflight() == 0 and dp.PIPELINE.completed_time() == 0
    assert all(r.batch.dev is None for r in rows)
    assert tdev.device_batches_held() == 0
    assert np.array_equal(np.stack([np.asarray(r) for r in rows]), made[0])


def test_numpy_dtype_reads_torch_dtypes():
    assert tdev.numpy_dtype(torch.float32) == np.float32
    assert tdev.numpy_dtype(np.dtype(np.float16)) == np.float16
    with pytest.raises(TypeError):
        tdev.numpy_dtype(torch.bfloat16)


def _index_state(index: DeviceKnnIndex) -> tuple:
    s = index.state
    return (
        s.vectors.numpy().copy(), s.valid.numpy().copy(), s.norms.numpy().copy(),
        {int(k): v for k, v in index.key_to_slot.items()}, list(index._free), index.capacity,
    )


def _same(a: tuple, b: tuple) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a[:3], b[:3])) and a[3:] == b[3:]


def test_index_add_of_lazy_rows_takes_the_device_route():
    rng = np.random.default_rng(5)
    mats = [rng.normal(size=(n, 8)).astype(np.float32) for n in (5, 6, 3)]
    lazy = [tdev.lazy_rows(torch.from_numpy(m.copy()), len(m)) for m in mats]
    # rows of two batches interleaved, a host row among them: one gather and scatter
    # per batch, the host row through the host route
    keys = list(range(14))
    rows = [lazy[0][0], lazy[1][0], lazy[0][1], mats[2][0], lazy[1][1], lazy[0][2],
            lazy[1][2], lazy[0][3], lazy[1][3], lazy[1][4], lazy[0][4], lazy[1][5],
            mats[2][1], mats[2][2]]
    ours = DeviceKnnIndex(dim=8, capacity=8, device="cpu")  # grows on the way
    ours.add(keys, rows)
    assert ours.rows_device == 11 and ours.rows_host == 3
    plain = DeviceKnnIndex(dim=8, capacity=8, device="cpu")
    # the order the device route assigns slots in: each batch's rows, then host rows
    order = [0, 2, 5, 7, 10, 1, 4, 6, 8, 9, 11, 3, 12, 13]
    plain.add([keys[i] for i in order], [np.asarray(rows[i]) for i in order])
    assert plain.rows_device == 0 and plain.rows_host == 14
    assert _same(_index_state(ours), _index_state(plain))
    q = [lazy[1][2]]
    assert ours.search(q, k=3) == plain.search([np.asarray(q[0])], k=3)


def test_replacing_lazy_rows_go_through_their_host_twin():
    rng = np.random.default_rng(6)
    m = rng.normal(size=(4, 8)).astype(np.float32)
    index = DeviceKnnIndex(dim=8, capacity=16, device="cpu")
    index.add([0, 1], [m[0], m[1]])
    lazy = tdev.lazy_rows(torch.from_numpy(m.copy()), 4)
    index.add([1, 2], [lazy[2], lazy[3]])  # key 1 is replaced: the host route
    assert index.rows_device == 0 and index.rows_host == 4
    slot = index.key_to_slot[1]
    assert np.array_equal(index.state.vectors[slot].numpy(), m[2])
