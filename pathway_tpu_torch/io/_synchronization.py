"""Input synchronization groups: sources that advance together.

Counterpart of ``pathway_tpu/io/_synchronization.py``. The sources registered in one
group hold back the rows whose time column runs more than ``max_difference`` ahead of
the slowest source, so a join over several live streams sees aligned time ranges
instead of whichever source happens to read faster. A member's held events wait, in
order, in the backlog of its ``engine/connectors.py::InputDriver``; the runner registers
each member's input driver when it builds the graph.

The group's rules: a member that has produced nothing blocks everyone (all sources
start aligned); a finished source stops capping the others; and a time that does not
compare with a member's frontier (a mix of types) is admitted, since denying it
forever would stall the run on one malformed row.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.expression import ColumnReference

__all__ = ["InputSynchronizationGroup", "register_input_synchronization_group"]


class InputSynchronizationGroup:
    """The shared pacing state of a set of input drivers."""

    def __init__(self, max_difference: Any) -> None:
        self.max_difference = max_difference
        self._members: list = []
        self._done: set[int] = set()
        self._owner: int | None = None  # the current run's GraphRunner id
        #: driver id -> the time of its next held event (None: no backlog)
        self.pending_head: dict[int, Any] = {}
        #: driver id -> the largest time it was admitted
        self.admitted: dict[int, Any] = {}

    def ensure_run(self, owner: int) -> None:
        """Membership is per run: a rebuild (a retry after a failed run, a repeated
        capture) starts from a clean slate, not blocked by stale drivers."""
        if self._owner != owner:
            self._owner = owner
            self._members = []
            self._done = set()
            self.pending_head = {}
            self.admitted = {}

    def register(self, driver: Any) -> None:
        self._members.append(driver)
        self.pending_head[id(driver)] = None
        self.admitted[id(driver)] = None

    def _frontier(self, member: Any) -> Any:
        """A member's frontier: its next held event's time, else the last time it was
        admitted (a source with no backlog holds no one back once it has caught up)."""
        head = self.pending_head[id(member)]
        if head is not None:
            return head
        return self.admitted[id(member)]

    def mark_done(self, driver: Any) -> None:
        """A finished source stops capping the others."""
        self._done.add(id(driver))

    def admit(self, driver: Any, t: Any) -> bool:
        """May ``driver`` emit an event at time ``t`` now? Yes while ``t <= min(the
        other members' frontiers) + max_difference``; a member that has produced nothing
        yet blocks everyone."""
        for member in self._members:
            if member is driver or id(member) in self._done:
                continue
            frontier = self._frontier(member)
            if frontier is None:
                return False  # the member has produced nothing yet
            try:
                if t > frontier + self.max_difference:
                    return False
            except TypeError:
                # a mix that does not compare: admit (fail open), or the run would
                # stall on one malformed row
                continue
        prev = self.admitted[id(driver)]
        try:
            newer = prev is None or t > prev
        except TypeError:
            newer = True
        if newer:
            self.admitted[id(driver)] = t
        return True

    def note_pending(self, driver: Any, t: Any | None) -> None:
        self.pending_head[id(driver)] = t


def register_input_synchronization_group(
    *columns: ColumnReference, max_difference: Any
) -> InputSynchronizationGroup:
    """Each column names an input table and its time column; the tables' connectors
    then advance in lockstep within ``max_difference``."""
    if len(columns) < 2:
        raise ValueError("a synchronization group needs at least two sources")
    group = InputSynchronizationGroup(max_difference)
    for ref in columns:
        if not isinstance(ref, ColumnReference):
            raise TypeError("pass column references (table.time_column)")
        table = ref.table
        spec = table._spec
        if spec.kind != "input":
            raise ValueError(
                f"synchronization groups apply to connector input tables; "
                f"{table._name} is {spec.kind!r}"
            )
        spec.params["sync_group"] = group
        spec.params["sync_column"] = ref.name
    return group
