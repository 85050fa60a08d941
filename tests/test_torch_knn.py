"""The port's ``knn_update`` / ``knn_search`` against ``pathway_tpu.ops.knn`` for all
three metrics. Vectors are small integers, so every dot product and norm is exact in
f32 and the scores and slots must be bit-identical; duplicate vectors pin the tie rule
(``lax.top_k``: among equal scores, the lowest slot first)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathway_tpu.ops import knn as jknn
from pathway_tpu_torch.ops import knn as tknn

CAP, DIM = 64, 8


def _corpus(seed):
    rng = np.random.default_rng(seed)
    vecs = rng.integers(-3, 4, (40, DIM)).astype(np.float32)
    vecs[0] = 0.0
    vecs[0, 0] = 1.0  # a row with a single non-zero
    vecs[10:16] = vecs[3]  # duplicates: equal scores on several slots
    vecs[20:24] = 2 * vecs[5]  # equal cosine, different dot and l2
    slots = rng.permutation(CAP)[:40].astype(np.int32)
    queries = np.concatenate([vecs[[3, 5, 0]], rng.integers(-3, 4, (5, DIM))]).astype(np.float32)
    return vecs, slots, queries


def _both_states(vecs, slots, enabled=None, set_valid=None):
    n = len(slots)
    enabled = np.ones(n, bool) if enabled is None else enabled
    set_valid = np.ones(n, bool) if set_valid is None else set_valid
    js = jknn.knn_update(
        jknn.knn_init(CAP, DIM), jnp.asarray(slots), jnp.asarray(vecs),
        jnp.asarray(set_valid), jnp.asarray(enabled),
    )
    ts = tknn.knn_update(
        tknn.knn_init(CAP, DIM, device="cpu"), torch.from_numpy(slots),
        torch.from_numpy(vecs), torch.from_numpy(set_valid), torch.from_numpy(enabled),
    )
    return js, ts


def _assert_state_equal(js, ts):
    assert np.array_equal(np.asarray(js.vectors), ts.vectors.numpy())
    assert np.array_equal(np.asarray(js.valid), ts.valid.numpy())
    assert np.array_equal(np.asarray(js.norms), ts.norms.numpy())


@pytest.mark.parametrize("metric", ["cos", "l2sq", "dot"])
@pytest.mark.parametrize("k", [1, 5, 12])
def test_search_bit_identical_to_jax(metric, k):
    vecs, slots, queries = _corpus(seed=0)
    js, ts = _both_states(vecs, slots)
    _assert_state_equal(js, ts)
    j_scores, j_slots = jknn.knn_search(js, jnp.asarray(queries), k, metric)
    t_scores, t_slots = tknn.knn_search(ts, torch.from_numpy(queries), k, metric)
    assert np.array_equal(np.asarray(j_slots), t_slots.numpy())
    assert np.array_equal(
        np.asarray(j_scores).view(np.int32), t_scores.numpy().view(np.int32)
    )


def test_ties_break_by_lowest_slot():
    vecs = np.zeros((6, DIM), np.float32)
    vecs[:, 1] = 2.0  # six identical vectors
    slots = np.array([40, 7, 33, 2, 19, 8], np.int32)
    _, ts = _both_states(vecs, slots)
    scores, top = tknn.knn_search(ts, torch.from_numpy(vecs[:1]), 4, "dot")
    assert top[0].tolist() == [2, 7, 8, 19]
    assert torch.all(scores == 4.0)


def test_empty_hits_map_to_capacity():
    vecs, slots, queries = _corpus(seed=1)
    js, ts = _both_states(vecs[:3], slots[:3])
    j_scores, j_slots = jknn.knn_search(js, jnp.asarray(queries), 6, "cos")
    t_scores, t_slots = tknn.knn_search(ts, torch.from_numpy(queries), 6, "cos")
    assert np.array_equal(np.asarray(j_slots), t_slots.numpy())
    assert (t_slots[:, 3:] == CAP).all() and torch.isinf(t_scores[:, 3:]).all()


def test_disabled_rows_are_dropped_and_removals_apply():
    vecs, slots, queries = _corpus(seed=2)
    enabled = np.ones(len(slots), bool)
    enabled[::3] = False
    enabled[0] = False  # the first enabled row is not row 0
    set_valid = np.ones(len(slots), bool)
    set_valid[5::7] = False  # deletions
    js, ts = _both_states(vecs, slots, enabled, set_valid)
    _assert_state_equal(js, ts)
    for metric in ("cos", "l2sq", "dot"):
        j = jknn.knn_search(js, jnp.asarray(queries), 8, metric)
        t = tknn.knn_search(ts, torch.from_numpy(queries), 8, metric)
        assert np.array_equal(np.asarray(j[1]), t[1].numpy())


def test_all_disabled_batch_changes_nothing():
    vecs, slots, _ = _corpus(seed=3)
    _, ts = _both_states(vecs, slots)
    before = [x.clone() for x in ts]
    tknn.knn_update(
        ts, torch.from_numpy(slots[:4]), torch.zeros((4, DIM)),
        torch.zeros(4, dtype=torch.bool), torch.zeros(4, dtype=torch.bool),
    )
    assert all(torch.equal(a, b) for a, b in zip(before, ts))


def test_update_writes_in_place():
    vecs, slots, _ = _corpus(seed=4)
    state = tknn.knn_init(CAP, DIM, device="cpu")
    ptr = state.vectors.data_ptr()
    out = tknn.knn_update(
        state, torch.from_numpy(slots), torch.from_numpy(vecs), torch.ones(len(slots), dtype=torch.bool)
    )
    assert out.vectors.data_ptr() == ptr and out is state


@pytest.mark.parametrize("metric", ["cos", "l2sq", "dot"])
def test_scores_stay_full_f32_when_the_process_lowers_matmul_precision(metric):
    """A process that turns on reduced-precision f32 matmuls ("medium": bf16 through
    oneDNN on the CPU; on the card, TF32) still gets full-f32 scores, and keeps its own
    setting. Bar: 1e-4 against float64 (bf16 products miss by ~1e-1 here)."""
    rng = np.random.default_rng(7)
    db = rng.normal(size=(300, 64)).astype(np.float32)
    q = rng.normal(size=(8, 64)).astype(np.float32)
    state = tknn.knn_init(512, 64, device="cpu")
    tknn.knn_update(state, torch.arange(300), torch.from_numpy(db), torch.ones(300, dtype=torch.bool))
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        scores, slots = tknn.knn_search(state, torch.from_numpy(q), 10, metric)
        assert torch.get_float32_matmul_precision() == "medium"
        assert torch.backends.mkldnn.matmul.fp32_precision == "bf16"
    finally:
        torch.set_float32_matmul_precision(saved)
    q64, db64 = q.astype(np.float64), db.astype(np.float64)
    dots = q64 @ db64.T
    if metric == "cos":
        ref = dots / np.outer(np.linalg.norm(q64, axis=1), np.linalg.norm(db64, axis=1))
    elif metric == "l2sq":
        ref = -((q64 * q64).sum(1)[:, None] + (db64 * db64).sum(1)[None, :] - 2 * dots)
    else:
        ref = dots
    picked = np.take_along_axis(ref, slots.numpy(), axis=1)
    assert np.abs(scores.numpy() - picked).max() < 1e-4
    assert np.array_equal(slots.numpy(), np.argsort(-ref, axis=1, kind="stable")[:, :10])
