"""Shard routing: the worker that owns each row, for whole batches at once.

Counterpart of ``pathway_tpu/engine/routing.py``. Given a partition rule from
:func:`pathway_tpu_torch.engine.sharded.partition_rule` and a batch, these functions give
an int64 worker id per row, equal bit for bit to the per-row definition
:func:`_shard_of`: row keys route by the full 128-bit pointer mod n, column values by
their salted ``hash_values`` digest, computed once per distinct value. ``None`` means
the vectorized assignment does not apply (a ``("pin",)`` rule, an unsupported column
dtype, keys that cannot be derived) and the caller takes the row path; nothing here
raises on data it cannot route.

The digests go through the host kernels (``native/enginecore.cpp``'s ``shard_values``
and ``hash_tuples_batch``); ``PATHWAY_TPU_DISABLE_NATIVE=1`` runs their plain versions
over :func:`hash_values_batch`, and a kernel that bails hands the call to the same plain
version. The schedulers move the routed parts by a host gather, or on the device through
``engine/collective_exchange.py`` (``collective_deliveries``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Sequence

import numpy as np

from pathway_tpu_torch import native as _native
from pathway_tpu_torch.engine.value import (
    ERROR,
    Pointer,
    _digest16,
    hash_values,
    hash_values_batch,
)
from pathway_tpu_torch.internals import metrics as _metrics

if TYPE_CHECKING:  # pragma: no cover
    from pathway_tpu_torch.engine.batch import Columns

__all__ = [
    "EXCHANGE_STATS",
    "batch_shards",
    "columnar_shards",
    "entry_shards",
    "mod_u128_bytes",
    "reshard_moves",
    "shards_of_values",
]

#: The exchange's delivery counters, mirrored into
#: ``pathway_exchange_events_total{kind=...}``. Every (consumer, port) delivery decision
#: adds one to exactly one of ``elided`` / ``host_deliveries`` /
#: ``collective_deliveries`` and one to ``repartitions``, so
#: ``elided + host_deliveries + collective_deliveries == repartitions`` always holds. The
#: ``path`` label names the plane (elided, host, device, total). The frame counters
#: belong to the multi-process mesh and stay 0 in one process.
EXCHANGE_STATS = _metrics.MirroredCounterDict(
    "pathway_exchange_events_total",
    "kind",
    {
        "columnar_frames_sent": 0,
        "columnar_frames_received": 0,
        "row_batches_sent": 0,
        "elided": 0,
        "host_deliveries": 0,
        "collective_deliveries": 0,
        "repartitions": 0,
    },
    help="exchange-path events by kind (mirrors EXCHANGE_STATS)",
    extra_labels={
        "columnar_frames_sent": {"path": "host"},
        "columnar_frames_received": {"path": "host"},
        "row_batches_sent": {"path": "host"},
        "elided": {"path": "elided"},
        "host_deliveries": {"path": "host"},
        "collective_deliveries": {"path": "device"},
        "repartitions": {"path": "total"},
    },
)


def _shard_of(value: Any, n: int) -> int:
    """The worker that owns ``value`` among ``n``: the definition every vectorized
    function below agrees with bit for bit."""
    if isinstance(value, Pointer):
        return int(value) % n
    try:
        return int(hash_values((value,), salt=b"shard")) % n
    except TypeError:
        return int(hash_values((repr(value),), salt=b"shard")) % n


def _shard_digest_fallback(value: Any) -> bytes:
    """The digest of one value the host kernel bailed on: :func:`_shard_of`'s rule
    (``repr`` where the value's digest raises TypeError)."""
    try:
        return _digest16((value,), b"shard")
    except TypeError:
        return _digest16((repr(value),), b"shard")


def mod_u128_bytes(kb: np.ndarray, n: int) -> np.ndarray:
    """``int.from_bytes(row, "little") % n`` for each row of an ``(m, 16)`` uint8 matrix
    of little-endian 128-bit integers. The halves fold as ``((hi % n) * (2**64 % n) +
    lo % n) % n``; every intermediate stays below ``n**2``, exact in uint64 for
    ``n < 2**32``."""
    kb = np.ascontiguousarray(kb)
    lo = kb[:, :8].copy().view(np.uint64).ravel()
    hi = kb[:, 8:].copy().view(np.uint64).ravel()
    nn = np.uint64(n)
    base = np.uint64((1 << 64) % n)
    return (((hi % nn) * base + lo % nn) % nn).astype(np.int64)


def shards_of_values(values: Sequence[Any], n: int) -> np.ndarray:
    """:func:`_shard_of` of every value, in one call: the host kernel ``shard_values``
    serializes, digests and folds them (Pointers route by ``int(v) % n``); its plain
    version digests the non-Pointer values with one :func:`hash_values_batch` call and
    folds the matrix with :func:`mod_u128_bytes`. Callers pass distinct values, so the
    per-value work runs once per distinct key."""
    kern = _native.get()
    if kern is not None:
        vlist = values if isinstance(values, list) else list(values)
        got = kern.shard_values(vlist, b"shard", n, Pointer, ERROR, _shard_digest_fallback)
        if got is not None:
            return got
    shards = np.empty(len(values), np.int64)
    rows: list[tuple] = []
    where: list[int] = []
    for i, v in enumerate(values):
        if isinstance(v, Pointer):
            shards[i] = int(v) % n
        else:
            rows.append((v,))
            where.append(i)
    if rows:
        kb = hash_values_batch(rows, salt=b"shard", on_type_error="repr")
        shards[np.asarray(where, np.int64)] = mod_u128_bytes(kb, n)
    return shards


def reshard_moves(keys: Sequence[Any], n_old: int, n_new: int) -> int:
    """How many of ``keys`` change owner when the worker count goes from ``n_old`` to
    ``n_new``: a re-shard's state transfer, counted exactly with the live routing."""
    if not len(keys) or n_old == n_new:
        return 0
    vlist = keys if isinstance(keys, list) else list(keys)
    old = shards_of_values(vlist, n_old)
    new = shards_of_values(vlist, n_new)
    return int(np.count_nonzero(old != new))


def entry_shards(rule: tuple, entries: "Sequence[tuple]", n: int) -> np.ndarray | None:
    """Worker ids for row entries ``(key, row, diff)``, the row-path twin of
    :func:`columnar_shards`: ``cols`` hashes the column tuple, ``col`` the bare value,
    ``key`` the row key. ``None`` for ``("pin",)``."""
    kind = rule[0]
    if kind == "key":
        return shards_of_values([e[0] for e in entries], n)
    if kind == "cols":
        cols = rule[1]
        return shards_of_values([tuple(e[1][c] for c in cols) for e in entries], n)
    if kind == "col":
        c = rule[1]
        if c is None:
            return shards_of_values([None] * len(entries), n)
        return shards_of_values([e[1][c] for e in entries], n)
    return None


def _bare_digest_fallback(value: Any) -> bytes:
    """The unsalted digest of one value, ``repr`` where it raises TypeError."""
    try:
        return _digest16((value,), b"")
    except TypeError:
        return _digest16((repr(value),), b"")


def _object_codes(col: np.ndarray) -> np.ndarray:
    """Dense int64 codes for an object column, one per distinct ``hash_values`` digest
    (the per-row partitioners' identity: dict equality is coarser, ``True == 1``). The
    codes come from one ``np.unique`` over the digest matrix; their order does not
    matter, since the caller reads only the classes."""
    kern = _native.get()
    if kern is not None:
        kb = kern.hash_tuples_batch(
            np.ascontiguousarray(col), b"", True, Pointer, ERROR, _bare_digest_fallback
        )
    else:
        kb = hash_values_batch([(v,) for v in col.tolist()], on_type_error="repr")
    _uniq, inverse = np.unique(kb, axis=0, return_inverse=True)
    return inverse.ravel().astype(np.int64, copy=False)


def columnar_shards(rule: tuple, columns: "Columns", n: int) -> np.ndarray | None:
    """Worker ids for a columnar batch, or ``None`` when the rule needs the row path.

    Row-key routing folds the key bytes; column routing factorizes the columns
    (``factorize_multi``), routes one representative of each distinct tuple and maps
    back through the inverse. A float column with NaNs factorizes over its bit
    patterns, so NaNs with distinct payloads keep their distinct digests (and +0.0 and
    -0.0, two classes there, still land together: their digests are equal). ``None``
    for ``("pin",)``, a column dtype outside bool/int/float/unicode/object, or keys that
    cannot be derived."""
    kind = rule[0]
    if kind in ("cols", "col"):
        if kind == "cols":
            idxs = list(rule[1])
            if not idxs:
                return np.full(columns.n, _shard_of((), n), np.int64)
            bare = False  # the value tuple
        else:
            c = rule[1]
            if c is None:
                return np.full(columns.n, _shard_of(None, n), np.int64)
            idxs = [c]
            bare = True  # the bare value
        from pathway_tpu_torch.engine.device import factorize_multi

        arrays = []
        for c in idxs:
            col = columns.cols[c]
            if col.dtype.kind in "bifU":
                if col.dtype.kind == "f" and np.isnan(col).any():
                    arrays.append(
                        np.ascontiguousarray(col).view(np.dtype(f"u{col.dtype.itemsize}"))
                    )
                    continue
                arrays.append(col)
            elif col.dtype == object:
                arrays.append(_object_codes(col))
            else:
                return None
        first, inverse = factorize_multi(arrays)
        reps = zip(*(columns.cols[c][first].tolist() for c in idxs))
        if bare:
            table = shards_of_values([t[0] for t in reps], n)
        else:
            table = shards_of_values(list(reps), n)
        return table[inverse]
    if kind != "key":
        return None
    try:
        kb = columns.kbytes()
    except Exception:  # noqa: BLE001 — a lazy key thunk failed: the row path derives keys
        return None
    return mod_u128_bytes(kb, n)


def batch_shards(rule: tuple, batch: Any, n: int) -> np.ndarray | None:
    """Worker ids for every row of a :class:`DeltaBatch` under ``rule``: the columnar
    function where the payload allows it, else the entries'; ``None`` for pin rules.
    The elision check (``PATHWAY_TPU_VERIFY_ELISION=1``) reads it."""
    if batch._entries is None and batch.columns is not None:
        got = columnar_shards(rule, batch.columns, n)
        if got is not None:
            return got
    return entry_shards(rule, batch.entries, n)
