"""Delta batches, the unit of incremental data movement.

Counterpart of ``pathway_tpu/engine/batch.py`` in its row form: every engine table is a
keyed update stream, batches of ``(key, row, diff)`` entries at a logical time. A batch
is consolidated when each (key, row) appears once with a non-zero diff. The JAX
package's columnar payload (``Columns``) waits for the device planes; the row form is
what every operator there understands, and what the ported operators use.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator

from pathway_tpu_torch.engine.value import Pointer

Entry = tuple[Pointer, tuple, int]


class DeltaBatch:
    """A consolidatable batch of keyed row updates."""

    __slots__ = ("entries", "_consolidated", "_insert_only", "_ccache")

    def __init__(self, entries: Iterable[Entry] | None = None) -> None:
        self.entries: list[Entry] = list(entries) if entries is not None else []
        self._consolidated = False
        self._insert_only = False  # set by consolidate(): unique-key inserts
        #: cached consolidate() result: a batch fanning out to several consumers
        #: (each consolidating in take()) merges only once
        self._ccache: "DeltaBatch | None" = None

    def append(self, key: Pointer, row: tuple, diff: int) -> None:
        if diff != 0:
            self.entries.append((key, row, diff))
            self._consolidated = False
            self._insert_only = False
            self._ccache = None

    def extend(self, entries: Iterable[Entry]) -> None:
        appended = False
        for key, row, diff in entries:
            if diff != 0:
                self.entries.append((key, row, diff))
                appended = True
        if appended:
            self._consolidated = False
            self._insert_only = False
            self._ccache = None

    def __iter__(self) -> Iterator[Entry]:
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __bool__(self) -> bool:
        return bool(self.entries)

    def __repr__(self) -> str:
        return f"DeltaBatch({self.entries!r})"

    def consolidate(self) -> "DeltaBatch":
        """Merge duplicate (key, row) entries, dropping zero diffs, in first-seen
        order."""
        if self._consolidated:
            return self
        if self._ccache is not None:
            return self._ccache
        # The dominant shape, insert-only with unique keys (connector ingest,
        # expression outputs): key uniqueness alone implies (key, row) uniqueness,
        # so the batch is already consolidated.
        seen: set = set()
        seen_add = seen.add
        clean = True
        for key, _row, diff in self.entries:
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
        for key, row, diff in self.entries:
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
                out.entries.append((slot[0], row, diff))
        out._consolidated = True
        self._ccache = out
        return out


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
