"""Fixed-capacity brute-force KNN resident in device memory.

Counterpart of ``pathway_tpu/ops/knn.py``. The index is a fixed-capacity slot array
``[capacity, dim]`` with a validity mask and the rows' squared norms; the host keeps the
slot <-> key mapping. Adds and removes are scatters into the kept buffers, search is one
masked f32 matmul followed by a top-k. Metrics: ``cos``, ``l2sq``, ``dot``.

The sharded search over several cards (``knn_search_sharded``) is not ported yet.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, NamedTuple

import torch

from pathway_tpu_torch._device import resolve_device

METRICS = ("cos", "l2sq", "dot")


class DeviceKnnState(NamedTuple):
    """Device-resident index state; ``knn_update`` writes into it in place."""

    vectors: torch.Tensor  # [capacity, dim]
    valid: torch.Tensor  # [capacity] bool
    norms: torch.Tensor  # [capacity] float32 — squared L2 norms, for l2sq and cos


def knn_init(
    capacity: int,
    dim: int,
    dtype: torch.dtype = torch.float32,
    *,
    device: "str | torch.device | None" = None,
) -> DeviceKnnState:
    """Allocate an empty index."""
    device = resolve_device(device)
    return DeviceKnnState(
        vectors=torch.zeros((capacity, dim), dtype=dtype, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        norms=torch.zeros((capacity,), dtype=torch.float32, device=device),
    )


@torch.no_grad()
def knn_update(
    state: DeviceKnnState,
    slots: torch.Tensor,  # [b] int — slot per row
    vectors: torch.Tensor,  # [b, dim]
    set_valid: torch.Tensor,  # [b] bool — True = insert, False = delete
    enabled: torch.Tensor | None = None,  # [b] bool — padding rows are disabled
) -> DeviceKnnState:
    """Scatter a batch of adds/removes into the slot array, IN PLACE: ``index_copy_``
    into the state's own buffers (the JAX version donates them to a functional
    scatter; here the buffers are simply kept and written). Returns ``state``.

    Disabled rows are dropped without a device-to-host sync: each one is redirected
    to the first enabled row and carries that row's values, so the duplicate writes
    agree; when no row is enabled, every row points at row 0's slot and writes back
    what that slot holds.

    Precondition, as in the JAX version: enabled slots are unique within a batch.
    """
    if slots.numel() == 0:
        return state
    vecs = vectors.to(state.vectors.dtype)
    sq = torch.sum(vectors.float() ** 2, dim=-1)
    slots = slots.long()
    if enabled is not None:
        rows = torch.arange(slots.shape[0], device=slots.device)
        first = torch.argmax(enabled.to(torch.uint8))  # first enabled row, or 0
        src = torch.where(enabled, rows, first)
        slots, vecs, set_valid, sq = slots[src], vecs[src], set_valid[src], sq[src]
        any_on = enabled.any()
        held = slots[:1].clamp(0, state.vectors.shape[0] - 1)
        slots = torch.where(any_on, slots, held)
        vecs = torch.where(any_on, vecs, state.vectors[held])
        set_valid = torch.where(any_on, set_valid, state.valid[held])
        sq = torch.where(any_on, sq, state.norms[held])
    state.vectors.index_copy_(0, slots, vecs)
    state.valid.index_copy_(0, slots, set_valid.to(torch.bool))
    state.norms.index_copy_(0, slots, sq)
    return state


# the per-backend fp32 matmul setting that TF32 (cuBLAS) or bf16 (oneDNN) turn on
_MATMUL_BACKENDS = {"cuda": torch.backends.cuda.matmul, "cpu": torch.backends.mkldnn.matmul}
_PRECISION_LOCK = threading.Lock()


@contextlib.contextmanager
def _ieee_f32_matmuls(device: torch.device) -> Iterator[None]:
    """Full-f32 matmuls inside the block whatever the process has set (``allow_tf32``,
    ``set_float32_matmul_precision``), as the JAX version pins ``Precision.HIGHEST`` per
    call: TF32 scores cost recall. The caller's setting is put back on the way out; the
    lock keeps two searches from restoring each other's value. The setting is read when
    a matmul is issued, so it covers the asynchronous launch."""
    backend = _MATMUL_BACKENDS.get(device.type)
    if backend is None:
        yield
        return
    with _PRECISION_LOCK:
        saved = backend.fp32_precision
        backend.fp32_precision = "ieee"
        try:
            yield
        finally:
            backend.fp32_precision = saved


def _scores(
    state: DeviceKnnState, queries: torch.Tensor, metric: str
) -> torch.Tensor:
    """Higher-is-better scores ``[q, capacity]`` with invalid slots at -inf."""
    q = queries.float()
    db = state.vectors.float()
    with _ieee_f32_matmuls(db.device):
        dots = q @ db.T
    if metric == "dot":
        scores = dots
    elif metric == "cos":
        qn = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
        dbn = torch.sqrt(state.norms)[None, :]
        scores = dots / torch.clamp(qn * dbn, min=1e-30)
    elif metric == "l2sq":
        qn = torch.sum(q * q, dim=-1, keepdim=True)
        scores = -(qn + state.norms[None, :] - 2.0 * dots)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return torch.where(state.valid[None, :], scores, float("-inf"))


def top_k_lowest_slot(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``'s order: highest score first and, among equal scores, the lowest
    slot first (``torch.topk`` promises no order among ties). One ``topk`` over an
    int64 key: the f32 score's bits mapped to an order-preserving int32 in the high
    half, ``capacity - 1 - slot`` in the low half."""
    capacity = scores.shape[-1]
    bits = scores.float().contiguous().view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # flips the magnitude of negatives
    low = capacity - 1 - torch.arange(capacity, device=scores.device, dtype=torch.int64)
    key = (ordered.to(torch.int64) << 32) | low
    top = torch.topk(key, k, dim=-1).values
    slots = capacity - 1 - (top & 0xFFFFFFFF)
    return torch.gather(scores, -1, slots), slots


@torch.no_grad()
def knn_search(
    state: DeviceKnnState,
    queries: torch.Tensor,  # [q, dim]
    k: int,
    metric: str = "cos",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k search. Returns (scores [q, k] f32, slots [q, k] int64); empty hits
    have score ``-inf`` and slot ``capacity`` (the host filters them)."""
    scores = _scores(state, queries, metric)
    top_scores, top_idx = top_k_lowest_slot(scores, k)
    capacity = state.vectors.shape[0]
    top_idx = torch.where(torch.isfinite(top_scores), top_idx, capacity)
    return top_scores, top_idx
