"""Device-resident row cells: a UDF's batch stays on the card, its rows travel the
engine as lazy cells, and device operators read them there.

Counterpart of the lazy-row part of ``pathway_tpu/engine/device.py``
(``DeviceBatchHandle``, ``LazyDeviceVector``, ``lazy_rows``, ``device_runs``): the
embedder's ``[n, dim]`` output becomes ``n`` lazy cells of one handle; the KNN index
gathers their rows on the card with no host round trip, and any host reader (a
subscribe callback, a consolidation that compares rows) gets the host twin, whose copy
was started when the batch was made.

The host twin is copied into pinned memory with ``non_blocking=True`` and an event is
recorded behind the copy: ``host()`` waits on that event before it reads the buffer, so
no reader sees the bytes before the copy has landed. At each commit boundary the
scheduler hands the commit's live batches (:func:`stage_device_batches`) to the device
pipeline (``engine/device_pipeline.py``), which completes each batch's host twin and
drops its device tensor, inline or on its completion thread: device memory holds at
most ``depth`` commits of batches, and rows kept in table state end up holding only
host arrays.

A handle is shared by two threads under the async pipeline: the completion thread
decays it while the scheduler thread may still read its host twin or its device
tensor (a row of commit N kept in state and read in commit N+1). ``host()`` and
``decay()`` take the handle's lock, and a reader of ``dev`` reads it once into a local,
which keeps the tensor alive for as long as the reader uses it. The completion thread
only waits on events and drops references; every copy is enqueued on the scheduler
thread, whose stream produced the batch.

The JAX package's columnar evaluator (the rest of its ``device.py``) is not ported yet.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Sequence

import numpy as np
import torch

#: device batches produced since the last commit boundary (weak: a batch no row
#: references any more needs no decay)
_LIVE_HANDLES: "weakref.WeakSet" = weakref.WeakSet()
#: every handle still alive, to count those that hold a device tensor
_ALL_HANDLES: "weakref.WeakSet" = weakref.WeakSet()

#: device-to-host copies of host twins, counted where ``host()`` completes one
TRANSFERS = {"d2h_copies": 0, "d2h_bytes": 0}
_TRANSFERS_LOCK = threading.Lock()  # host() runs on the scheduler and completion threads

_NUMPY_DTYPES = {
    torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64),
    torch.float16: np.dtype(np.float16),
    torch.int64: np.dtype(np.int64),
    torch.int32: np.dtype(np.int32),
    torch.bool: np.dtype(np.bool_),
}


def numpy_dtype(dtype: "torch.dtype | np.dtype") -> np.dtype:
    """The numpy dtype of a tensor's or an array's elements. ``np.dtype`` cannot read
    ``str(torch.float32)``; bf16 has no numpy dtype and raises."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _NUMPY_DTYPES:
            raise TypeError(f"no numpy dtype for {dtype}")
        return _NUMPY_DTYPES[dtype]
    return np.dtype(dtype)


def _identity(arr: np.ndarray) -> np.ndarray:
    return arr


class DeviceBatchHandle:
    """A ``[n, dim]`` tensor with a host twin copied in the background: made by device
    UDF batches (the embedder), read on the card by device operators (the index).

    Within the commit that made it, both copies may exist: a subscribe callback that
    reads the host twin must not take the device copy from an index operator later in
    the same sweep. At the commit boundary the device pipeline completes the host twin
    and drops the device tensor (``decay``), inline or on its completion thread.
    """

    __slots__ = (
        "dev", "_host", "_pinned", "_copied", "_prefetched", "_lock", "__weakref__"
    )

    def __init__(self, dev: torch.Tensor) -> None:
        self.dev: torch.Tensor | None = dev
        self._host: np.ndarray | None = None
        self._pinned: torch.Tensor | None = None
        self._copied: "torch.cuda.Event | None" = None
        self._prefetched = False
        # reentrant: decay() completes the host twin through host()
        self._lock = threading.RLock()
        _LIVE_HANDLES.add(self)
        _ALL_HANDLES.add(self)

    def prefetch(self) -> None:
        """Start the device-to-host copy without blocking. On the card the copy goes
        into pinned memory on the current stream, behind the kernels that produce the
        batch, and an event marks its end; ``host()`` later waits on that event
        instead of paying a synchronous copy. Called on the scheduler thread: when the
        batch is made and at the commit boundary, before the batch is staged."""
        if self._host is not None or self._prefetched:
            return
        self._prefetched = True
        dev = self.dev
        if dev is None or dev.device.type != "cuda":
            return  # a CPU tensor is its own host copy
        pinned = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        pinned.copy_(dev.detach(), non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._pinned, self._copied = pinned, event

    def host(self) -> np.ndarray:
        """The batch as a host array, the same bits as the device tensor."""
        host = self._host
        if host is not None:
            return host
        with self._lock:
            if self._host is None:
                dev = self.dev
                if self._copied is not None:
                    # the copy may still be in flight: wait for it before reading
                    # (the wait releases the GIL)
                    self._copied.synchronize()
                    # out of the pinned buffer, so pinned memory is held for one commit
                    host = self._pinned.numpy().copy()
                    self._pinned = self._copied = None
                elif dev.device.type == "cuda":
                    host = dev.detach().cpu().numpy()
                else:
                    host = dev.detach().numpy()
                if dev is not None and dev.device.type == "cuda":
                    with _TRANSFERS_LOCK:
                        TRANSFERS["d2h_copies"] += 1
                        TRANSFERS["d2h_bytes"] += int(host.nbytes)
                self._host = host
            return self._host

    def decay(self) -> None:
        """Complete the host twin and release the device copy."""
        with self._lock:
            if self.dev is not None:
                self.prefetch()
                self.host()
                self.dev = None


def stage_device_batches() -> list:
    """Detach and return this commit's live device batches without decaying them: the
    caller owns their completion, and the next commit gathers a fresh set. ``[]`` on a
    commit that made none."""
    if not _LIVE_HANDLES:
        return []
    handles = list(_LIVE_HANDLES)
    _LIVE_HANDLES.clear()
    return handles


def device_batches_held() -> int:
    """How many live handles still hold a device tensor."""
    return sum(1 for handle in list(_ALL_HANDLES) if handle.dev is not None)


class LazyDeviceVector:
    """One row of a :class:`DeviceBatchHandle`. Any host-side use reads the row of the
    batch's host twin (``__array__``), while device consumers slice ``batch.dev`` with
    no transfer. Like ndarrays, instances are unhashable and compare elementwise, so
    the engine's consolidation and diff paths treat them as they treat arrays."""

    __slots__ = ("batch", "index")

    def __init__(self, batch: DeviceBatchHandle, index: int) -> None:
        self.batch = batch
        self.index = index

    def __array__(self, dtype: Any = None, copy: Any = None) -> np.ndarray:
        row = self.batch.host()[self.index]
        if dtype is not None and row.dtype != dtype:
            row = row.astype(dtype)
        return np.array(row, copy=True) if copy else row

    def _parent(self) -> "torch.Tensor | np.ndarray":
        dev = self.batch.dev
        return dev if dev is not None else self.batch.host()

    @property
    def shape(self) -> tuple:
        return tuple(self._parent().shape[1:])

    @property
    def dtype(self) -> np.dtype:
        return numpy_dtype(self._parent().dtype)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def reshape(self, *shape: Any) -> np.ndarray:
        return np.asarray(self).reshape(*shape)

    def __len__(self) -> int:
        return self.shape[0]

    def __iter__(self):
        return iter(np.asarray(self))

    def __getitem__(self, item: Any) -> Any:
        return np.asarray(self)[item]

    def __eq__(self, other: Any) -> Any:
        return np.asarray(self) == other

    def __ne__(self, other: Any) -> Any:
        return np.asarray(self) != other

    __hash__ = None  # type: ignore[assignment]  # like np.ndarray

    def __repr__(self) -> str:
        return repr(np.asarray(self))

    def __reduce__(self):
        return (_identity, (np.array(np.asarray(self)),))


def lazy_rows(dev_batch: torch.Tensor, n: int, prefetch: bool = True) -> list:
    """Wrap a device ``[b, dim]`` result as ``n`` lazy row cells. ``prefetch`` starts
    the host copy at once: device consumers slice the tensor regardless, and a host
    reader finds the bytes already on their way."""
    handle = DeviceBatchHandle(dev_batch)
    if prefetch:
        handle.prefetch()
    return [LazyDeviceVector(handle, i) for i in range(n)]


def _live_dev(v: Any) -> "torch.Tensor | None":
    """The device tensor of a lazy row's batch, read once, or None."""
    return v.batch.dev if isinstance(v, LazyDeviceVector) else None


def device_runs(
    vectors: Sequence[Any],
) -> list[tuple[int, int, Any, list[int] | None]]:
    """Partition ``vectors`` into maximal contiguous runs of ``(start, stop,
    device tensor or None, row indices or None)``. A run with a tensor holds lazy rows
    of that one live batch, which a device operator gathers with no transfer; a
    ``None`` run is host data. Each batch's tensor is read once: the run keeps it
    alive even if the completion thread decays the batch meanwhile."""
    runs: list[tuple[int, int, Any, list[int] | None]] = []
    i, n = 0, len(vectors)
    while i < n:
        v = vectors[i]
        dev = _live_dev(v)
        if dev is not None:
            parent = v.batch
            indices = [v.index]
            j = i + 1
            while (
                j < n
                and isinstance(vectors[j], LazyDeviceVector)
                and vectors[j].batch is parent
            ):
                indices.append(vectors[j].index)
                j += 1
            runs.append((i, j, dev, indices))
        else:
            j = i + 1
            while j < n and _live_dev(vectors[j]) is None:
                j += 1
            runs.append((i, j, None, None))
        i = j
    return runs


def common_device_parent(vectors: Sequence[Any]) -> tuple[Any, list[int]] | None:
    """(device tensor, row indices) when every vector is a lazy row of one live batch,
    else None."""
    runs = device_runs(list(vectors))
    if len(runs) == 1 and runs[0][2] is not None:
        return runs[0][2], runs[0][3]
    return None
