"""As-of-now KNN index against device-resident state, and the engine operator that
runs it.

Counterpart of ``DeviceKnnIndex``, ``HostKnnIndex`` and ``ExternalIndexNode`` in
``pathway_tpu/engine/external_index.py``. The index lives on the card (``ops/knn.py``):
adds and removes are bucket-padded scatter batches, searches are bucket-padded masked
matmuls with a top-k. The host keeps only the key <-> slot mapping and the free list,
which decide slot ids and so the order of tied hits; they follow the JAX version step
for step. Keys are any hashables.

Vectors and queries may be host vectors, a ``[n, dim]`` tensor on the index's device,
the engine's lazy device rows (``engine.device.LazyDeviceVector``, the embedder UDF's
output), or row views of such tensors. Rows already on the card are gathered and
scattered there, with no host round trip, one gather and scatter per parent batch; a
search comes back in one packed device-to-host copy. ``rows_device`` and ``rows_host``
count the rows each add took through the two routes. The node counts
``pathway_device_knn_updates_total`` and ``pathway_device_knn_queries_total`` and, in a
sampled commit, records the ``knn-update`` and ``knn-search`` spans.
"""

from __future__ import annotations

import time as _walltime
from typing import Any, Hashable, NamedTuple, Sequence

import numpy as np
import torch

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.engine.batch import DeltaBatch
from pathway_tpu_torch.engine.device import LazyDeviceVector
from pathway_tpu_torch.engine.graph import Node, Scope
from pathway_tpu_torch.engine.value import is_error
from pathway_tpu_torch.internals import metrics as _metrics
from pathway_tpu_torch.internals import tracing as _tracing
from pathway_tpu_torch.ops.knn import DeviceKnnState, knn_init, knn_search, knn_update

#: the volume each commit pushes through the KNN index: mutations and query probes
_KNN_UPDATES = _metrics.REGISTRY.counter(
    "pathway_device_knn_updates_total",
    "key add/remove mutations dispatched to the device KNN index",
)
_KNN_QUERIES = _metrics.REGISTRY.counter(
    "pathway_device_knn_queries_total",
    "query vectors dispatched to the device KNN search",
)


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _pack_results(scores: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Stack (scores f32, slots) into ONE int32 tensor ``[2, q, k]`` (scores
    bit-cast) so the host pays a single device-to-host copy per search."""
    return torch.stack(
        [scores.float().contiguous().view(torch.int32), slots.to(torch.int32)]
    )


def _gather_pad(
    dev: torch.Tensor, idx_pad: torch.Tensor, enabled: torch.Tensor
) -> torch.Tensor:
    """Bucketed device gather: ``[B, dim]`` batch + padded indices -> ``[b, dim]``
    float32 rows, zeroed where disabled."""
    rows = dev.index_select(0, idx_pad).float()
    return torch.where(enabled[:, None], rows, 0.0)


def _to_host(vec: Any, dim: int) -> np.ndarray:
    if isinstance(vec, torch.Tensor):
        vec = vec.detach().float().cpu().numpy()
    return np.asarray(vec, np.float32).reshape(dim)


def _row_of(vec: Any, dim: int, device: torch.device) -> tuple[torch.Tensor, int] | None:
    """(base ``[N, dim]`` tensor, row index) when ``vec`` is a row view of a
    contiguous tensor on ``device``, else None."""
    if not isinstance(vec, torch.Tensor) or vec.device != device:
        return None
    base = vec._base  # the tensor a view was cut from (None for a non-view)
    if (
        base is None
        or vec.shape != (dim,)
        or vec.stride() != (1,)
        or base.dim() != 2
        or base.shape[1] != dim
        or not base.is_contiguous()
    ):
        return None
    offset = vec.storage_offset() - base.storage_offset()
    if offset % dim:
        return None
    return base, offset // dim


class DeviceKnnIndex:
    """Brute-force KNN on the card with a host slot allocator.

    Capacity doubles by a device-side copy when the free list runs dry; update and
    query batches are padded to power-of-two buckets, as in the JAX version, so the
    device sees a small set of shapes.
    """

    def __init__(
        self,
        dim: int,
        metric: str = "cos",
        capacity: int = 1024,
        dtype: torch.dtype | None = None,
        *,
        device: "str | torch.device | None" = None,
    ) -> None:
        self.dim = dim
        self.metric = metric
        self.capacity = capacity
        self.dtype = dtype if dtype is not None else torch.float32
        self.device = resolve_device(device)
        self.state = knn_init(capacity, dim, self.dtype, device=self.device)
        self.key_to_slot: dict[Hashable, int] = {}
        self.slot_to_key: dict[int, Hashable] = {}
        self._free: list[int] = list(range(capacity - 1, -1, -1))
        self.rows_device = 0  # rows added through _add_device_run
        self.rows_host = 0  # rows added through _add_host

    def __len__(self) -> int:
        return len(self.key_to_slot)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _device_groups(
        self, vectors: Any
    ) -> tuple[list[tuple[torch.Tensor, list[int], list[int], Any]], list[int]]:
        """Split ``vectors`` into the rows of each parent tensor on the index's device
        -> ([(parent, row indices, positions, lazy batch or None)], host positions).
        Rows group by parent, not by contiguous runs, so rows whose order upstream
        operators scrambled still take one gather and scatter per parent."""
        if isinstance(vectors, torch.Tensor) and vectors.dim() == 2:
            if vectors.device == self.device and vectors.shape[1] == self.dim:
                n = vectors.shape[0]
                return [(vectors, list(range(n)), list(range(n)), None)], []
            return [], list(range(vectors.shape[0]))
        groups: dict[int, tuple[torch.Tensor, list[int], list[int], Any]] = {}
        host: list[int] = []
        # each batch's tensor is read once, so all of its rows take one route even if
        # the device pipeline's completion thread decays the batch meanwhile
        devs: dict[int, "torch.Tensor | None"] = {}
        for pos, vec in enumerate(vectors):
            if isinstance(vec, LazyDeviceVector):
                handle = vec.batch
                if id(handle) not in devs:
                    devs[id(handle)] = handle.dev
                dev = devs[id(handle)]
                if (
                    dev is None
                    or dev.device != self.device
                    or tuple(dev.shape[1:]) != (self.dim,)
                ):
                    host.append(pos)
                    continue
                _, rows, positions, _ = groups.setdefault(id(handle), (dev, [], [], handle))
                rows.append(vec.index)
                positions.append(pos)
                continue
            found = _row_of(vec, self.dim, self.device)
            if found is None:
                host.append(pos)
                continue
            base, row = found
            _, rows, positions, _ = groups.setdefault(id(base), (base, [], [], None))
            rows.append(row)
            positions.append(pos)
        return list(groups.values()), host

    # -- mutation ------------------------------------------------------------

    def _grow(self) -> None:
        old = self.state
        new_capacity = self.capacity * 2
        fresh = knn_init(new_capacity, self.dim, self.dtype, device=self.device)
        fresh.vectors[: self.capacity].copy_(old.vectors)
        fresh.valid[: self.capacity].copy_(old.valid)
        fresh.norms[: self.capacity].copy_(old.norms)
        self.state = fresh
        self._free = list(range(new_capacity - 1, self.capacity - 1, -1)) + self._free
        self.capacity = new_capacity

    def _apply(
        self, slots: list[int], vecs: np.ndarray, set_valid: list[bool]
    ) -> None:
        n = len(slots)
        if n == 0:
            return
        b = _bucket(n)
        slots_arr = np.zeros((b,), np.int64)
        slots_arr[:n] = slots
        vec_arr = np.zeros((b, self.dim), np.float32)
        vec_arr[:n] = vecs
        valid_arr = np.zeros((b,), bool)
        valid_arr[:n] = set_valid
        enabled = np.zeros((b,), bool)
        enabled[:n] = True
        knn_update(
            self.state,
            self._upload(slots_arr),
            self._upload(vec_arr),
            self._upload(valid_arr),
            self._upload(enabled),
        )

    def add(self, keys: Sequence[Hashable], vectors: Any) -> None:
        keys = list(keys)
        if len(keys) != len(vectors):
            raise ValueError(f"{len(keys)} keys for {len(vectors)} vectors")
        groups, host_pos = self._device_groups(vectors)
        host_keys = [keys[p] for p in host_pos]
        host_vecs = [vectors[p] for p in host_pos]
        # one gather+scatter per parent tensor keeps the device queue short
        for base, rows, positions, lazy in groups:
            gkeys = [keys[p] for p in positions]
            if not self._add_device_run(gkeys, base, rows):
                # replacements take the general path: lazy rows through their host
                # twin (already on its way), other rows through one host copy
                if lazy is not None:
                    host = lazy.host()[rows]
                else:
                    idx = torch.tensor(rows, device=base.device)
                    host = base.index_select(0, idx).float().cpu().numpy()
                self._add_host(gkeys, list(host))
        if host_keys:
            self._add_host(host_keys, host_vecs)

    def _add_host(self, keys: Sequence[Hashable], vectors: Sequence[Any]) -> None:
        self.rows_host += len(keys)
        slots, vecs, valid = [], [], []
        deferred_free: list[int] = []  # freed only after the batch lands, so
        # a replaced key's old slot can't be reused (= written twice) in it
        for key, vec in zip(keys, vectors):
            if key in self.key_to_slot:
                old_slot = self.key_to_slot.pop(key)
                self.slot_to_key.pop(old_slot, None)
                slots.append(old_slot)
                vecs.append(np.zeros((self.dim,), np.float32))
                valid.append(False)
                deferred_free.append(old_slot)
            if not self._free:
                self._apply(slots, np.asarray(vecs, np.float32), valid)
                self._free.extend(deferred_free)
                slots, vecs, valid, deferred_free = [], [], [], []
                if not self._free:
                    self._grow()
            slot = self._free.pop()
            self.key_to_slot[key] = slot
            self.slot_to_key[slot] = key
            slots.append(slot)
            vecs.append(_to_host(vec, self.dim))
            valid.append(True)
        self._apply(slots, np.asarray(vecs, np.float32), valid)
        self._free.extend(deferred_free)

    def _add_device_run(
        self, keys: Sequence[Hashable], dev: torch.Tensor, indices: Sequence[int]
    ) -> bool:
        """Transfer-free ingest of rows of one device tensor (the embedder's
        output): gather on the card and scatter straight into the index."""
        if tuple(dev.shape[1:]) != (self.dim,):
            return False  # rejection must precede any capacity growth
        if any(key in self.key_to_slot for key in keys):
            return False  # replacements take the general path
        while len(self._free) < len(keys):
            self._grow()
        n = len(keys)
        self.rows_device += n
        slots = []
        for key in keys:
            slot = self._free.pop()
            self.key_to_slot[key] = slot
            self.slot_to_key[slot] = key
            slots.append(slot)
        b = _bucket(n)
        slots_arr = np.zeros((b,), np.int64)
        slots_arr[:n] = slots
        enabled = np.zeros((b,), bool)
        enabled[:n] = True
        idx_pad = np.zeros((b,), np.int64)
        idx_pad[:n] = indices
        # only the control arrays go up: the vectors are already on the card
        enabled_dev = self._upload(enabled)
        gathered = _gather_pad(dev, self._upload(idx_pad), enabled_dev)
        knn_update(
            self.state, self._upload(slots_arr), gathered, enabled_dev, enabled_dev
        )
        return True

    def remove(self, keys: Sequence[Hashable]) -> None:
        slots, vecs, valid = [], [], []
        for key in keys:
            slot = self.key_to_slot.pop(key, None)
            if slot is None:
                continue
            self.slot_to_key.pop(slot, None)
            self._free.append(slot)
            slots.append(slot)
            vecs.append(np.zeros((self.dim,), np.float32))
            valid.append(False)
        self._apply(slots, np.asarray(vecs, np.float32), valid)

    # -- operator persistence -------------------------------------------------

    def op_state(self) -> dict:
        """Host copies of the whole capacity's state, so snapshots pickle and never
        alias the live buffers (which ``knn_update`` writes in place)."""
        return {
            "vectors": self.state.vectors.to("cpu", copy=True).numpy(),
            "valid": self.state.valid.to("cpu", copy=True).numpy(),
            "norms": self.state.norms.to("cpu", copy=True).numpy(),
            "key_to_slot": dict(self.key_to_slot),
            "free": list(self._free),
            "capacity": self.capacity,
        }

    def restore_op_state(self, state: dict) -> None:
        """The snapshot's state, uploaded to the index's own device."""
        self.capacity = state["capacity"]

        def up(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device, dtype, copy=True)

        self.state = DeviceKnnState(
            vectors=up(state["vectors"], self.dtype),
            valid=up(state["valid"], torch.bool),
            norms=up(state["norms"], torch.float32),
        )
        self.key_to_slot = dict(state["key_to_slot"])
        self.slot_to_key = {s: k for k, s in self.key_to_slot.items()}
        self._free = list(state["free"])

    # -- read snapshots ------------------------------------------------------

    def read_view(self) -> "DeviceKnnIndex":
        """Immutable search-only twin at the current state. ``knn_update`` writes
        the live buffers in place, so the view takes a device-side copy (no host
        transfer); the slot maps are host dicts and copy shallowly."""
        view = object.__new__(type(self))
        view.dim = self.dim
        view.metric = self.metric
        view.capacity = self.capacity
        view.dtype = self.dtype
        view.device = self.device
        view.state = DeviceKnnState(*(x.clone() for x in self.state))
        view.key_to_slot = dict(self.key_to_slot)
        view.slot_to_key = dict(self.slot_to_key)
        view._free = []
        return view

    # -- search --------------------------------------------------------------

    def search(
        self, queries: Any, k: int
    ) -> list[list[tuple[Hashable, float]]]:
        n = len(queries)
        if n == 0:
            return []
        k_eff = min(k, self.capacity)
        b = _bucket(n)
        groups, host_pos = self._device_groups(queries)
        if not host_pos and len(groups) == 1:
            # the queries still live on the card (embedder output): gather there
            # and fetch only the top-k
            dev, rows, _, _ = groups[0]
            idx_pad = np.zeros((b,), np.int64)
            idx_pad[:n] = rows
            enabled = np.zeros((b,), bool)
            enabled[:n] = True
            q_dev = _gather_pad(dev, self._upload(idx_pad), self._upload(enabled))
        else:
            q = np.zeros((b, self.dim), np.float32)
            for i in range(n):
                q[i] = _to_host(queries[i], self.dim)
            q_dev = self._upload(q)
        scores, slots = knn_search(self.state, q_dev, k_eff, self.metric)
        packed = _pack_results(scores, slots).cpu().numpy()
        return self._hits(packed[0].view(np.float32)[:n], packed[1][:n])

    def _hits(
        self, scores: np.ndarray, slots: np.ndarray
    ) -> list[list[tuple[Hashable, float]]]:
        """Per query, the (key, score) pairs of its live, finite hits."""
        out: list[list[tuple[Hashable, float]]] = []
        for row_scores, row_slots in zip(scores, slots):
            hits = []
            for score, slot in zip(row_scores, row_slots):
                key = self.slot_to_key.get(int(slot))
                if key is not None and np.isfinite(score):
                    hits.append((key, float(score)))
            out.append(hits)
        return out


class _HostKnnState(NamedTuple):
    """NumPy twin of ops.knn.DeviceKnnState (same field contract)."""

    vectors: np.ndarray  # [capacity, dim]
    valid: np.ndarray  # [capacity] bool
    norms: np.ndarray  # [capacity] float32 — squared L2 norms


class HostKnnIndex(DeviceKnnIndex):
    """NumPy twin of :class:`DeviceKnnIndex`, the plain reference for the device
    index: exact f32 search on the host.

    It inherits the slot allocator, bucket padding, replacement and growth logic
    (the behaviours that decide slot ids and therefore tie order), overriding only
    the device seams: state lives in NumPy arrays, and the scatter and the masked
    matmul + top-k run on the host. Ties break as ``lax.top_k`` does (lowest slot
    first) through a stable descending argsort.
    """

    def __init__(
        self,
        dim: int,
        metric: str = "cos",
        capacity: int = 1024,
        dtype: Any = None,
    ) -> None:
        self.dim = dim
        self.metric = metric
        self.capacity = capacity
        self.dtype = np.float32
        self.device = torch.device("cpu")
        self.state = _HostKnnState(
            vectors=np.zeros((capacity, dim), np.float32),
            valid=np.zeros((capacity,), bool),
            norms=np.zeros((capacity,), np.float32),
        )
        self.key_to_slot = {}
        self.slot_to_key = {}
        self._free = list(range(capacity - 1, -1, -1))
        self._cow_shared = False
        self.rows_device = 0
        self.rows_host = 0

    def _grow(self) -> None:
        old = self.state
        new_capacity = self.capacity * 2
        vectors = np.zeros((new_capacity, self.dim), np.float32)
        valid = np.zeros((new_capacity,), bool)
        norms = np.zeros((new_capacity,), np.float32)
        vectors[: self.capacity] = old.vectors
        valid[: self.capacity] = old.valid
        norms[: self.capacity] = old.norms
        self.state = _HostKnnState(vectors, valid, norms)
        self._cow_shared = False  # growth allocated fresh arrays
        self._free = (
            list(range(new_capacity - 1, self.capacity - 1, -1)) + self._free
        )
        self.capacity = new_capacity

    def _add_device_run(
        self, keys: Sequence[Hashable], dev: Any, indices: Sequence[int]
    ) -> bool:
        return False  # a host index takes every row through the host path

    def _apply(
        self, slots: list[int], vecs: np.ndarray, set_valid: list[bool]
    ) -> None:
        n = len(slots)
        if n == 0:
            return
        if self._cow_shared:
            # a read view shares these arrays: clone before the in-place
            # scatter so the published snapshot stays frozen
            self.state = _HostKnnState(
                self.state.vectors.copy(),
                self.state.valid.copy(),
                self.state.norms.copy(),
            )
            self._cow_shared = False
        vecs = np.asarray(vecs, np.float32).reshape(n, self.dim)
        idx = np.asarray(slots, np.int64)
        self.state.vectors[idx] = vecs
        self.state.valid[idx] = np.asarray(set_valid, bool)
        # same formula as ops.knn.knn_update: f32 square-sum of the row
        self.state.norms[idx] = np.sum(vecs * vecs, axis=-1)

    def op_state(self) -> dict:
        # explicit copies: the host arrays mutate in place
        return {
            "vectors": self.state.vectors.copy(),
            "valid": self.state.valid.copy(),
            "norms": self.state.norms.copy(),
            "key_to_slot": dict(self.key_to_slot),
            "free": list(self._free),
            "capacity": self.capacity,
        }

    def restore_op_state(self, state: dict) -> None:
        self.capacity = state["capacity"]
        self.state = _HostKnnState(
            vectors=np.array(state["vectors"], np.float32),
            valid=np.array(state["valid"], bool),
            norms=np.array(state["norms"], np.float32),
        )
        self.key_to_slot = dict(state["key_to_slot"])
        self.slot_to_key = {s: k for k, s in self.key_to_slot.items()}
        self._free = list(state["free"])
        self._cow_shared = False

    def read_view(self) -> "HostKnnIndex":
        """Copy-on-write read view: the view SHARES the live arrays and both
        sides are flagged, so the next in-place scatter on either clones first."""
        view = object.__new__(type(self))
        view.dim = self.dim
        view.metric = self.metric
        view.capacity = self.capacity
        view.dtype = self.dtype
        view.device = self.device
        view.state = self.state
        view.key_to_slot = dict(self.key_to_slot)
        view.slot_to_key = dict(self.slot_to_key)
        view._free = []
        view._cow_shared = True
        self._cow_shared = True
        return view

    def search(
        self, queries: Any, k: int
    ) -> list[list[tuple[Hashable, float]]]:
        n = len(queries)
        if n == 0:
            return []
        k_eff = min(k, self.capacity)
        q = np.zeros((n, self.dim), np.float32)
        for i in range(n):
            q[i] = _to_host(queries[i], self.dim)
        db = self.state.vectors
        dots = q @ db.T
        if self.metric == "dot":
            scores = dots
        elif self.metric == "cos":
            qn = np.sqrt(np.sum(q * q, axis=-1, keepdims=True))
            dbn = np.sqrt(self.state.norms)[None, :]
            scores = dots / np.maximum(qn * dbn, np.float32(1e-30))
        elif self.metric == "l2sq":
            qn = np.sum(q * q, axis=-1, keepdims=True)
            scores = -(qn + self.state.norms[None, :] - 2.0 * dots)
        else:
            raise ValueError(f"unknown metric {self.metric!r}")
        scores = np.where(self.state.valid[None, :], scores, -np.inf)
        # lax.top_k's tie rule: highest score first, lowest slot among equals
        order = np.argsort(-scores, axis=1, kind="stable")[:, :k_eff]
        return self._hits(np.take_along_axis(scores, order, axis=1), order)


class ExternalIndexNode(Node):
    """As-of-now index operator: port 0 is the indexed data, port 1 the queries.

    Output: keyed by query id, row = (result ids: tuple of keys, result scores: tuple
    of floats). Index-side updates of a commit are applied (removes before adds)
    before the queries of the same commit are answered. Answers stick until their
    query row is deleted; a query of a live key again replaces its answer. An error or
    ``None`` payload (a vector, or the text of the BM25 index) is reported, not indexed,
    under the JAX engine's message. ``index`` is None on a sharded run's replicas
    w > 0: the node is pinned to worker 0, and the others receive no row.
    """

    def __init__(
        self,
        scope: Scope,
        index_table: Node,
        query_table: Node,
        index: Any,
        index_col: int,
        query_col: int,
        k: int,
        limit_col: int | None = None,
    ) -> None:
        super().__init__(scope, [index_table, query_table], 2)
        # not ``self.index``: that is the node's position in its scope
        self.ext_index = index
        self.index_col = index_col
        self.query_col = query_col
        self.k = k
        self.limit_col = limit_col

    def op_state(self) -> dict:
        state = super().op_state()
        if self.ext_index is None:
            return state
        index_state = getattr(self.ext_index, "op_state", None)
        if index_state is None:
            # skipping it would resume with an empty index while the readers have moved
            # past the rows that filled it
            raise TypeError(
                f"{type(self.ext_index).__name__} does not implement "
                "op_state/restore_op_state, so it cannot be used with "
                "PersistenceMode.OPERATOR_PERSISTING"
            )
        state["index"] = index_state()
        return state

    def restore_op_state(self, state: dict) -> None:
        super().restore_op_state(state)
        if "index" in state and hasattr(self.ext_index, "restore_op_state"):
            self.ext_index.restore_op_state(state["index"])

    def process(self, time: int) -> DeltaBatch:
        index_batch = self.take(0)
        query_batch = self.take(1)

        # 1. fold the index side's deltas into the device state
        add_keys: list[Hashable] = []
        add_vecs: list[Any] = []
        rm_keys: list[Hashable] = []
        for key, row, diff in index_batch:
            vec = row[self.index_col]
            if diff > 0:
                if is_error(vec) or vec is None:
                    self.report(key, "error/None vector in index input")
                    continue
                add_keys.append(key)
                add_vecs.append(vec)
            else:
                rm_keys.append(key)
        # removes first, so a delete and insert of a key in one commit nets to an add
        if rm_keys or add_keys:
            t0 = _walltime.perf_counter()
            if rm_keys:
                add_set = set(add_keys)
                self.ext_index.remove([k_ for k_ in rm_keys if k_ not in add_set])
            if add_keys:
                self.ext_index.add(add_keys, add_vecs)
            _KNN_UPDATES.inc(len(rm_keys) + len(add_keys))
            ctx = _tracing.current()
            if ctx is not None:
                # ends at the enqueue: the scatter may still run on the card
                ctx.span("knn-update", "pipeline", t0, _walltime.perf_counter(),
                         adds=len(add_keys), removes=len(rm_keys))

        # 2. answer new queries as of now; retract the answers of deleted queries
        out = DeltaBatch()
        pending: list[tuple[Hashable, Any, int]] = []
        retracted: set = set()
        for key, row, diff in query_batch:
            if diff < 0:
                prev = self.current.get(key)
                if prev is not None and key not in retracted:
                    out.append(key, prev, -1)
                    retracted.add(key)
                continue
            vec = row[self.query_col]
            if is_error(vec) or vec is None:
                self.report(key, "error/None vector in query input")
                continue
            limit = self.k
            if self.limit_col is not None:
                lv = row[self.limit_col]
                if lv is not None and not is_error(lv):
                    limit = int(lv)
            pending.append((key, vec, limit))
        if pending:
            max_k = max(limit for _k, _v, limit in pending)
            t0 = _walltime.perf_counter()
            results = self.ext_index.search([v for _k, v, _l in pending], max_k)
            _KNN_QUERIES.inc(len(pending))
            ctx = _tracing.current()
            if ctx is not None:
                # ends after the results' device-to-host copy: covers the search
                ctx.span("knn-search", "pipeline", t0, _walltime.perf_counter(),
                         queries=len(pending), k=max_k)
            for (key, _vec, limit), hits in zip(pending, results):
                hits = hits[:limit]
                # a query of a live key again replaces its previous answer (unless
                # this commit's deletion pass already retracted it)
                prev = self.current.get(key)
                if prev is not None and key not in retracted:
                    out.append(key, prev, -1)
                out.append(
                    key,
                    (tuple(hk for hk, _s in hits), tuple(s for _hk, s in hits)),
                    1,
                )
        return out.consolidate()
