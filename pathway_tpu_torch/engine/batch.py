"""Delta batches, the unit of incremental data movement.

Counterpart of ``pathway_tpu/engine/batch.py``: every engine table is a keyed update
stream, batches of ``(key, row, diff)`` entries at a logical time. A batch is
consolidated when each (key, row) appears once with a non-zero diff.

Two physical forms share the :class:`DeltaBatch` interface:

- **row form**: a list of ``(Pointer, tuple, int)`` entries, which every operator
  understands;
- **columnar form**: a :class:`Columns` payload, keys as a ``(n, 16)`` little-endian
  byte matrix (or a list of Pointers), one NumPy array per column and an optional diff
  vector (``None`` means all +1). The vectorized operator paths (expression eval,
  filter, the hash join, the groupby) produce and consume it array to array; rows
  materialise only when something row-oriented touches the batch.

Where the JAX code branches on its C++ host kernels (``pathway_tpu.native``), this
module takes the NumPy/Python branch, which the JAX package's own tests hold equal to
the kernels.
"""

from __future__ import annotations

import operator
from typing import Any, Iterable, Iterator, Sequence

import numpy as np

from pathway_tpu_torch.engine.value import Pointer

Entry = tuple[Pointer, tuple, int]


class Columns:
    """Columnar payload of a delta batch.

    ``kbytes`` and ``kobjs`` are two views of the same keys, 16-byte little-endian rows
    and Pointer objects; either may be absent and is derived from the other on demand.
    ``cols`` holds one 1-D array per column (clean dtypes where possible, ``object``
    otherwise). ``diffs`` is ``None`` when every diff is +1.
    """

    __slots__ = ("n", "_kbytes", "_kobjs", "_kb_thunk", "cols", "diffs")

    def __init__(
        self,
        n: int,
        cols: Sequence[np.ndarray],
        kbytes: np.ndarray | None = None,
        kobjs: Sequence[Pointer] | None = None,
        diffs: np.ndarray | None = None,
        kb_thunk: "Any | None" = None,
    ) -> None:
        assert kbytes is not None or kobjs is not None or kb_thunk is not None
        self.n = n
        self._kbytes = kbytes
        self._kobjs = list(kobjs) if kobjs is not None else None
        #: lazy key derivation (the join's pair hash): runs only when somebody
        #: observes the keys
        self._kb_thunk = kb_thunk
        self.cols = list(cols)
        self.diffs = diffs

    # -- key views ----------------------------------------------------------

    def kbytes(self) -> np.ndarray:
        """Keys as a C-contiguous (n, 16) uint8 little-endian matrix."""
        if self._kbytes is None:
            if self._kb_thunk is not None:
                self._kbytes = self._kb_thunk()
                self._kb_thunk = None
                return self._kbytes
            buf = b"".join(int(k).to_bytes(16, "little") for k in self._kobjs)
            self._kbytes = np.frombuffer(buf, np.uint8).reshape(self.n, 16)
        return self._kbytes

    def kobjs(self) -> list[Pointer]:
        """Keys as Pointer objects (materialised once, then cached)."""
        if self._kobjs is None:
            mem = np.ascontiguousarray(self.kbytes()).tobytes()
            self._kobjs = [
                Pointer(int.from_bytes(mem[i * 16 : i * 16 + 16], "little"))
                for i in range(self.n)
            ]
        return self._kobjs

    # -- transforms ---------------------------------------------------------

    def gather(self, idx: np.ndarray) -> "Columns":
        """Row subset or reorder by an index vector."""
        kb = self._kbytes
        kobjs = None
        if kb is None and self._kb_thunk is not None:
            kb = self.kbytes()  # force the lazy keys once
        if kb is not None:
            kb = kb[idx]
        else:
            arr = np.empty(self.n, object)
            arr[:] = self._kobjs
            kobjs = arr[idx].tolist()
        diffs = self.diffs[idx] if self.diffs is not None else None
        return Columns(
            int(len(idx)), [c[idx] for c in self.cols], kbytes=kb, kobjs=kobjs, diffs=diffs
        )

    def compress(self, mask: np.ndarray) -> "Columns":
        """Row subset by boolean mask."""
        return self.gather(np.flatnonzero(mask))

    def column_diffs(self) -> np.ndarray:
        """Diff vector (materialising the implicit all-ones case)."""
        if self.diffs is None:
            return np.ones(self.n, np.int64)
        return self.diffs

    @classmethod
    def with_keys_of(
        cls, other: "Columns", cols: Sequence[np.ndarray], diffs: np.ndarray | None = None
    ) -> "Columns":
        """New payload sharing ``other``'s key storage (keys are immutable); used by
        key-preserving operators (select, filter)."""
        c = cls.__new__(cls)
        c.n = other.n
        c._kbytes = other._kbytes
        c._kobjs = other._kobjs
        # a still-lazy source: go through other.kbytes, so the thunk runs once and
        # caches in the source
        c._kb_thunk = (
            other.kbytes if other._kbytes is None and other._kobjs is None else None
        )
        c.cols = list(cols)
        c.diffs = diffs
        return c

    @classmethod
    def concat(cls, parts: "Sequence[Columns]") -> "Columns | None":
        """Stack columnar payloads row-wise, or None when layouts differ (arity or any
        per-column dtype: NumPy's promotion would change materialised Python types)."""
        arity = len(parts[0].cols)
        if any(len(p.cols) != arity for p in parts[1:]):
            return None
        for c in range(arity):
            dt = parts[0].cols[c].dtype
            if any(p.cols[c].dtype != dt for p in parts[1:]):
                return None
        n = sum(p.n for p in parts)
        cols = [np.concatenate([p.cols[c] for p in parts]) for c in range(arity)]
        if all(p.diffs is None for p in parts):
            diffs = None
        else:
            diffs = np.concatenate([p.column_diffs() for p in parts])
        if all(p._kbytes is not None or p._kb_thunk is not None for p in parts):
            if any(p._kbytes is None for p in parts):
                # keep laziness across the concat, pinning only each part's key
                # source, not the whole Columns
                sources = [p._kb_thunk if p._kbytes is None else p._kbytes for p in parts]
                return cls(
                    n,
                    cols,
                    kb_thunk=lambda: np.concatenate(
                        [s() if callable(s) else s for s in sources]
                    ),
                    diffs=diffs,
                )
            return cls(n, cols, kbytes=np.concatenate([p._kbytes for p in parts]), diffs=diffs)
        return cls(n, cols, kobjs=[k for p in parts for k in p.kobjs()], diffs=diffs)

    def to_entries(self) -> list[Entry]:
        """Materialise row-form entries (the per-row object cost lives here, paid only
        when a row-oriented consumer needs it)."""
        keys = self.kobjs()
        if self.cols:
            rows = zip(*[c.tolist() for c in self.cols])
        else:
            rows = ((),) * self.n
        if self.diffs is None:
            return [(k, r, 1) for k, r in zip(keys, rows)]
        return [(k, r, int(d)) for k, r, d in zip(keys, rows, self.diffs)]


class DeltaBatch:
    """A consolidatable batch of keyed row updates."""

    __slots__ = (
        "_entries",
        "columns",
        "_consolidated",
        "_insert_only",
        "_raw_insert_only",
        "_ccache",
    )

    def __init__(self, entries: Iterable[Entry] | None = None) -> None:
        self._entries: list[Entry] | None = list(entries) if entries is not None else []
        self.columns: Columns | None = None
        self._consolidated = False
        self._insert_only = False  # set by consolidate(): unique-key inserts
        #: the producer guarantees every diff is +1 (session inserts, static rows)
        #: without the key-uniqueness scan of consolidate(); multiset-correct
        #: consumers (the columnar join) accept it, dict-state consumers consolidate
        self._raw_insert_only = False
        #: cached consolidate() result: a batch fanning out to several consumers
        #: (each consolidating in take()) merges only once
        self._ccache: "DeltaBatch | None" = None

    @classmethod
    def from_columns(
        cls, columns: Columns, consolidated: bool = True, insert_only: bool = False
    ) -> "DeltaBatch":
        """Wrap a columnar payload; producers assert the consolidation invariants at
        construction (unique keys mean consolidated)."""
        out = cls.__new__(cls)
        out._entries = None
        out.columns = columns
        out._consolidated = consolidated
        out._insert_only = insert_only and columns.diffs is None
        out._raw_insert_only = out._insert_only
        out._ccache = None
        return out

    @property
    def entries(self) -> list[Entry]:
        if self._entries is None:
            self._entries = self.columns.to_entries()
        return self._entries

    @entries.setter
    def entries(self, value: list[Entry]) -> None:
        self._entries = value
        self.columns = None
        self._ccache = None
        self._raw_insert_only = False

    def _row_mutated(self) -> None:
        self.columns = None  # a row mutation invalidates the columnar view
        self._consolidated = False
        self._insert_only = False
        self._raw_insert_only = False
        self._ccache = None

    def append(self, key: Pointer, row: tuple, diff: int) -> None:
        if diff != 0:
            self.entries.append((key, row, diff))
            self._row_mutated()

    def extend(self, entries: Iterable[Entry]) -> None:
        target = self.entries
        appended = False
        for key, row, diff in entries:
            if diff != 0:
                target.append((key, row, diff))
                appended = True
        if appended:
            self._row_mutated()

    def __iter__(self) -> Iterator[Entry]:
        return iter(self.entries)

    def __len__(self) -> int:
        if self._entries is not None:
            return len(self._entries)
        return self.columns.n

    def __bool__(self) -> bool:
        return len(self) > 0

    def __repr__(self) -> str:
        if self._entries is None:
            return f"DeltaBatch(<columnar n={self.columns.n}>)"
        return f"DeltaBatch({self._entries!r})"

    def consolidate(self) -> "DeltaBatch":
        """Merge duplicate (key, row) entries, dropping zero diffs, in first-seen
        order."""
        if self._consolidated:
            return self
        if self._ccache is not None:
            return self._ccache
        if self._entries is None:
            got = self._consolidate_columns()
            if got is not None:
                return got
            # no vectorized merge for this payload (object columns, NaN or -0.0
            # floats, unfetchable keys): materialise rows
            self.entries  # noqa: B018 — force the row form
        # The dominant shape, insert-only with unique keys (connector ingest,
        # expression outputs): key uniqueness alone implies (key, row) uniqueness,
        # so the batch is already consolidated.
        seen: set = set()
        seen_add = seen.add
        clean = True
        for key, _row, diff in self._entries:
            if diff <= 0 or key in seen:
                clean = False
                break
            seen_add(key)
        if clean:
            self._consolidated = True
            self._insert_only = True
            return self
        acc: dict[tuple[Pointer, Any], list[Any]] = {}
        order: list[tuple[Pointer, Any]] = []
        for key, row, diff in self._entries:
            try:
                hash(row)
                slot = (key, row)  # dict handles hash + equality correctly
            except TypeError:  # a row holding an array (or a lazy device row)
                slot = (key, id(row))
            found = acc.get(slot)
            if found is None:
                acc[slot] = [row, diff]
                order.append(slot)
            else:
                found[1] += diff
        out = DeltaBatch()
        for slot in order:
            row, diff = acc[slot]
            if diff != 0:
                out._entries.append((slot[0], row, diff))
        out._consolidated = True
        self._ccache = out
        return out

    def _consolidate_columns(self) -> "DeltaBatch | None":
        """Vectorized consolidate of a columnar payload: merge duplicate (key, row)
        rows without materialising row tuples, or ``None`` when bit equality and value
        equality could diverge (object columns, NaN or -0.0 in a float column) or the
        keys cannot be fetched. Within a uniform-dtype column with NaN and -0.0
        excluded, bit equality is value equality, so a structured view over (key
        bytes, columns) groups exactly the rows the dict slot ``(key, row)`` merges."""
        cols = self.columns
        n = cols.n
        if n == 0:
            self._consolidated = True
            self._insert_only = True
            return self
        for c in cols.cols:
            if c.dtype.kind not in "bifU":
                return None
            if c.dtype.kind == "f" and (np.isnan(c).any() or np.signbit(c[c == 0]).any()):
                return None
        try:
            kb = np.ascontiguousarray(cols.kbytes())
        except Exception:
            return None
        diffs = cols.diffs
        # positive diffs and unique keys: nothing to merge, flag in place
        if diffs is None or (diffs > 0).all():
            lo = np.sort(kb[:, :8].view(np.uint64).ravel())
            if not (lo[1:] == lo[:-1]).any() or len(
                np.unique(kb.view(np.dtype((np.void, 16))).ravel())
            ) == n:
                self._consolidated = True
                self._insert_only = True
                return self
        rec = np.empty(
            n,
            dtype=[("k", (np.void, 16))] + [(f"c{i}", c.dtype) for i, c in enumerate(cols.cols)],
        )
        rec["k"] = kb.view(np.dtype((np.void, 16))).ravel()
        for i, c in enumerate(cols.cols):
            rec[f"c{i}"] = c
        _uniq, first, inverse = np.unique(rec, return_index=True, return_inverse=True)
        sums = np.zeros(len(first), np.int64)
        np.add.at(sums, inverse.ravel(), np.int64(1) if diffs is None else diffs)
        order = np.argsort(first, kind="stable")  # first-seen entry order
        keep = sums[order] != 0
        idx = first[order][keep]
        newdiffs = sums[order][keep]
        merged = Columns(
            int(len(idx)),
            [c[idx] for c in cols.cols],
            kbytes=kb[idx],
            diffs=None if (newdiffs == 1).all() else newdiffs,
        )
        out = DeltaBatch.from_columns(merged, consolidated=True, insert_only=False)
        self._ccache = out
        return out


def entry_keys_bytes(entries: list) -> np.ndarray | None:
    """The entries' keys as an (n, 16) little-endian byte matrix, or None when a key
    is not a Pointer."""
    if any(type(e[0]) is not Pointer for e in entries):
        return None
    buf = b"".join(int(e[0]).to_bytes(16, "little") for e in entries)
    return np.frombuffer(buf, np.uint8).reshape(len(entries), 16)


def columnarize_entries(batch: DeltaBatch) -> DeltaBatch | None:
    """Columnar twin of a consolidated insert-only row batch, or None. Requires
    Pointer keys and a uniform row arity; mixed-type columns become exact-object
    arrays."""
    if not (batch._consolidated and batch._insert_only):
        return None
    entries = batch._entries
    if not entries:
        return None
    # a ragged batch stays row-form: the columnar twin would truncate long rows
    if len(set(map(len, map(operator.itemgetter(1), entries)))) != 1:
        return None
    kb = entry_keys_bytes(entries)
    if kb is None:
        return None  # non-Pointer keys: row path
    from pathway_tpu_torch.engine import device

    view = device.ColumnarView(entries, from_entries=True)
    return DeltaBatch.from_columns(
        Columns(len(entries), device.materialize_columns(view, len(entries[0][1])), kbytes=kb),
        consolidated=True,
        insert_only=True,
    )


def apply_batch_to_state(state: dict[Pointer, tuple], batch: DeltaBatch) -> None:
    """Apply a consolidated batch of +-1 updates to a key -> row map. A table maps each
    key to exactly one row; an in-place update arrives as a retraction of the old row
    and an insertion of the new one."""
    entries = batch.entries
    if batch._insert_only:
        state.update((key, row) for key, row, _d in entries)
        return
    for key, _row, diff in entries:
        if diff < 0:
            state.pop(key, None)
    for key, row, diff in entries:
        if diff > 0:
            state[key] = row
