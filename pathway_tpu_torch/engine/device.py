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

The rest is the columnar bridge of the JAX package's ``device.py``: a column-major
view of a batch's rows (:class:`ColumnarView`, :class:`PayloadView`; a list's clean
numeric columns come out of the C++ host kernel ``extract_column``), the vectorized
NumPy evaluator of engine expressions (:func:`eval_columnar`), and the host kernels
behind the groupby and the join: :func:`factorize`, :func:`factorize_multi`, and the
segment reductions :func:`segment_count` and :func:`segment_sum`, which are the spec
that the device operators (``engine/device_ops.py``) are held to bit for bit.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Sequence

import numpy as np
import torch

from pathway_tpu_torch import native as _native
from pathway_tpu_torch.engine import expression as ex

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


# -- the columnar bridge ------------------------------------------------------

#: batches smaller than this are cheaper to run through the per-row interpreter than
#: to columnarise
VECTOR_THRESHOLD = 256

_OK_KINDS = frozenset("bifU")
_CLEAN_TYPES = frozenset((int, float, bool, str))
_MISSING = object()


class ColumnarView:
    """Lazy column-major view over a batch's rows (insertions only). Extraction is
    per column and gives up (``None``) on a column that is not a clean homogeneous
    numeric, bool or string sequence, so ERROR poisoning, ``None`` handling and other
    Python values keep their row-wise semantics. ``from_entries=True`` views
    ``(key, row, diff)`` entries directly."""

    __slots__ = ("rows", "n", "_cols", "_entries")

    def __init__(self, rows: Sequence[tuple], from_entries: bool = False) -> None:
        self.rows = rows
        self.n = len(rows)
        self._cols: dict[int, np.ndarray | None] = {}
        self._entries = from_entries

    def column(self, index: int) -> np.ndarray | None:
        """The column as a NumPy array, or None if not cleanly columnar (mixed types,
        None or ERROR values, nested containers, bigints)."""
        got = self._cols.get(index, _MISSING)
        if got is not _MISSING:
            return got
        arr = None
        kern = _native.get() if isinstance(self.rows, list) else None
        if kern is not None:
            # one C pass for int64, float64 and bool columns; None for strings and
            # anything not clean (the Python branch below decides those)
            arr = kern.extract_column(self.rows, index, self._entries)
        if arr is None:
            values = (
                [e[1][index] for e in self.rows]
                if self._entries
                else [row[index] for row in self.rows]
            )
            arr = _extract(values)
        self._cols[index] = arr
        return arr


def materialize_columns(view: ColumnarView, arity: int) -> list[np.ndarray]:
    """Every column of an entry view as an array: clean dtypes where extraction
    succeeds, an exact-object array otherwise (never None), so a row round trip
    through ``Columns.to_entries`` is lossless."""
    cols = []
    rows = view.rows
    for c in range(arity):
        col = view.column(c)
        if col is None:
            col = np.empty(view.n, object)
            col[:] = [e[1][c] for e in rows] if view._entries else [r[c] for r in rows]
        cols.append(col)
    return cols


class PayloadView:
    """ColumnarView-compatible adapter over a columnar batch payload: the columns are
    arrays already, so extraction is a dtype screen."""

    __slots__ = ("_payload", "n")

    def __init__(self, payload: Any) -> None:
        self._payload = payload
        self.n = payload.n

    def column(self, index: int) -> np.ndarray | None:
        col = self._payload.cols[index]
        return col if col.dtype.kind in _OK_KINDS else None


def _extract(values: list) -> np.ndarray | None:
    """A list of Python scalars as a homogeneous ndarray, else None."""
    kinds = set(map(type, values))
    if not kinds or not kinds.issubset(_CLEAN_TYPES):
        return None
    if len(kinds) > 1:
        # int+float mixing would promote ints in pass-through columns; bool+int
        # would demote: keep exact dtypes only
        return None
    if next(iter(kinds)) is str and any("\x00" in v for v in values):
        return None  # NumPy's U dtype strips trailing NULs on the round trip
    try:
        arr = np.asarray(values)
    except (OverflowError, ValueError):
        return None
    if arr.dtype == object or arr.dtype.kind not in _OK_KINDS:
        return None
    return arr


class NotVectorizable(Exception):
    """An expression (or its operand columns) cannot run column-wise; the caller
    falls back to the row interpreter."""


# ops where NumPy diverges from the row interpreter on edge inputs (ZeroDivisionError
# poisoning against inf/nan, 0**-1)
_DIVISION_OPS = frozenset(("/", "//", "%"))
_I64_MAX = (1 << 63) - 1


def _guard_int_overflow(op: str, a: np.ndarray, b: np.ndarray) -> None:
    """int64 wraps in NumPy while the row interpreter computes exact Python ints:
    reject any int op whose result could leave the int64 range (magnitude bounds in
    exact Python ints)."""
    if op not in ("+", "-", "*", "**", "<<"):
        return  # //, %, comparisons and bitwise ops stay within the operands' range
    amax = int(np.abs(a).max(initial=0))
    bmax = int(np.abs(b).max(initial=0))
    if amax < 0 or bmax < 0:  # np.abs(INT64_MIN) wraps negative
        raise NotVectorizable(f"possible int64 overflow in {op}")
    if op in ("+", "-"):
        safe = amax + bmax <= _I64_MAX
    elif op == "*":
        safe = amax * bmax <= _I64_MAX
    elif op == "**":
        safe = bmax <= 63 and (amax <= 1 or amax.bit_length() * bmax <= 63)
    else:  # <<
        safe = bmax <= 62 and amax.bit_length() + bmax <= 63
    if not safe:
        raise NotVectorizable(f"possible int64 overflow in {op}")


def eval_columnar(expr: ex.EngineExpression, view: Any) -> np.ndarray:
    """Evaluate ``expr`` over all rows at once; raises NotVectorizable when a
    sub-expression or an operand column needs row-wise treatment."""
    if isinstance(expr, ex.ColumnRef):
        col = view.column(expr.index)
        if col is None:
            raise NotVectorizable(f"column {expr.index}")
        return col
    if isinstance(expr, ex.Const):
        v = expr.value
        if type(v) not in _CLEAN_TYPES:
            raise NotVectorizable("const")
        return np.broadcast_to(np.asarray(v), (view.n,))
    if isinstance(expr, ex.Binary):
        if expr.op == "@":
            raise NotVectorizable("matmul")
        a = eval_columnar(expr.left, view)
        b = eval_columnar(expr.right, view)
        if expr.op in _DIVISION_OPS:
            if b.dtype.kind not in "bif" or not np.all(b):
                raise NotVectorizable("division edge case")
        if expr.op == "**":
            if a.dtype.kind == "i" and (b.dtype.kind != "i" or np.any(b < 0)):
                raise NotVectorizable("pow edge case")
        if a.dtype.kind == "U" or b.dtype.kind == "U":
            if a.dtype.kind != b.dtype.kind:
                raise NotVectorizable("string vs non-string operands")
            if expr.op not in ("==", "!=", "<", "<=", ">", ">=", "+"):
                raise NotVectorizable("string op")
            if expr.op == "+":
                return np.char.add(a, b)
        if expr.op in ("+", "-", "*", "**", "//", "%") and (
            a.dtype.kind == "b" or b.dtype.kind == "b"
        ):
            # NumPy's bool arithmetic (True+True=True) diverges from Python's int
            # promotion (True+True=2)
            raise NotVectorizable("bool arithmetic")
        if a.dtype.kind == "i" and b.dtype.kind == "i":
            _guard_int_overflow(expr.op, a, b)
        try:
            with np.errstate(all="raise"):
                return expr.fn(a, b)
        except Exception as e:  # noqa: BLE001 — the row path owns error semantics
            raise NotVectorizable(str(e)) from None
    if isinstance(expr, ex.Unary):
        a = eval_columnar(expr.arg, view)
        if expr.op == "not":
            if a.dtype.kind != "b":
                raise NotVectorizable("not on non-bool")
            return ~a
        if expr.op == "~" and a.dtype.kind == "b":
            return ~a
        try:
            with np.errstate(all="raise"):
                return expr.fn(a)
        except Exception as e:  # noqa: BLE001
            raise NotVectorizable(str(e)) from None
    if isinstance(expr, ex.BooleanChain):
        parts = [eval_columnar(arg, view) for arg in expr.args]
        if any(p.dtype.kind != "b" for p in parts):
            raise NotVectorizable("boolean chain on non-bool")
        fn = np.logical_and if expr.op == "and" else np.logical_or
        out = parts[0]
        for p in parts[1:]:
            out = fn(out, p)
        return out
    if isinstance(expr, ex.IfElse):
        c = eval_columnar(expr.cond, view)
        if c.dtype.kind != "b":
            raise NotVectorizable("if_else condition not bool")
        t = eval_columnar(expr.then, view)
        f = eval_columnar(expr.otherwise, view)
        if t.dtype != f.dtype:
            raise NotVectorizable("if_else branch dtype mismatch")
        return np.where(c, t, f)
    if isinstance(expr, ex.IsNone):
        # a successfully extracted column holds no None by construction
        eval_columnar(expr.arg, view)
        return np.broadcast_to(np.asarray(bool(expr.negated)), (view.n,))
    raise NotVectorizable(type(expr).__name__)


def eval_expressions_columnar_cols(
    expressions: Sequence[ex.EngineExpression],
    rows: Sequence[tuple],
    from_entries: bool = False,
) -> list[list] | None:
    """All expressions over all rows, column-major as plain Python lists (the
    interpreter's exact types), or None to fall back to the row interpreter."""
    view = ColumnarView(rows, from_entries=from_entries)
    outs = []
    for expr in expressions:
        try:
            arr = eval_columnar(expr, view)
        except NotVectorizable:
            return None
        outs.append(np.ascontiguousarray(arr).tolist())
    return outs


# -- the groupby's host kernels: the spec of the device reductions -------------


def factorize(values: np.ndarray) -> tuple[list, np.ndarray]:
    """Distinct values, and the inverse index of each row's group."""
    uniques, inverse = np.unique(values, return_inverse=True)
    return uniques.tolist(), inverse


def factorize_multi(arrays: "list[np.ndarray]") -> tuple[np.ndarray, np.ndarray]:
    """Composite factorization over several same-length columns: ``(first,
    inverse)``, where ``first[g]`` is a row of distinct tuple ``g`` and ``inverse[i]``
    is row ``i``'s tuple id. Per-column dense codes chain through a mixed-radix
    combine, densified at each step so the int64 product cannot overflow."""
    combined: np.ndarray | None = None
    for a in arrays:
        _u, inv = np.unique(a, return_inverse=True)
        inv = inv.astype(np.int64, copy=False).reshape(-1)
        if combined is None:
            combined = inv
        else:
            _pu, prev = np.unique(combined, return_inverse=True)
            combined = prev.astype(np.int64).reshape(-1) * np.int64(len(_u)) + inv
    assert combined is not None
    _uc, first, inverse = np.unique(combined, return_index=True, return_inverse=True)
    return first, inverse.reshape(-1)


def segment_count(inverse: np.ndarray, diffs: np.ndarray, n_groups: int) -> np.ndarray:
    """Per-group sum of diffs (int64, wrapping)."""
    out = np.zeros(n_groups, np.int64)
    np.add.at(out, inverse, diffs)
    return out


def int_sum_overflow_risk(col: np.ndarray, n: int, dmax: int) -> bool:
    """True when an int64 segment sum of ``col`` (diff magnitudes up to ``dmax`` over
    ``n`` rows) could leave the int64 range: the vectorized paths compute in wrapping
    int64 while the row interpreter uses exact Python ints."""
    if col.dtype.kind != "i" or col.size == 0:
        return False
    amax = int(np.abs(col).max())
    if amax < 0 or dmax < 0:  # np.abs(INT64_MIN) wraps negative
        return True
    return amax * n * dmax > (1 << 62)


def segment_sum(
    inverse: np.ndarray, values: np.ndarray, diffs: np.ndarray, n_groups: int
) -> np.ndarray:
    """Per-group sum of value*diff: int64 (wrapping) for int and bool values; for
    floats, float64 added in row order from +0.0 (``np.bincount``)."""
    if values.dtype.kind in "ib":
        out = np.zeros(n_groups, np.int64)
        np.add.at(out, inverse, values.astype(np.int64) * diffs)
        return out
    return np.bincount(inverse, weights=values * diffs, minlength=n_groups)
