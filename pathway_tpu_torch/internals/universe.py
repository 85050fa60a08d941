"""Universe (key-set) tracking: a SAT-based solver.

A copy of ``pathway_tpu/internals/universe.py``: universe relations are propositional
clauses over "a generic element is in universe U" variables, decided by a compact DPLL
with unit propagation.

Encoding (one boolean variable per universe; clauses hold for an arbitrary fixed
element):
- ``A ⊆ B``       →  (¬A ∨ B)
- ``A == B``      →  (¬A ∨ B), (¬B ∨ A)
- ``U = A ∪ B``   →  (¬A ∨ U), (¬B ∨ U), (¬U ∨ A ∨ B)   (concat)
- ``I = A ∩ B``   →  (¬I ∨ A), (¬I ∨ B), (¬A ∨ ¬B ∨ I)  (intersect)
- ``D = A ∖ B``   →  (¬D ∨ A), (¬D ∨ ¬B), (¬A ∨ B ∨ D)  (difference)

``A ⊆ B`` holds iff clauses ∧ A ∧ ¬B is UNSAT; equality is subset both ways.
"""

from __future__ import annotations

import itertools

_counter = itertools.count(1)  # DPLL literals are ±id; 0 is reserved


class Universe:
    __slots__ = ("id",)

    def __init__(self) -> None:
        self.id = next(_counter)

    def __repr__(self) -> str:
        return f"Universe({self.id})"

    def subset(self) -> "Universe":
        u = Universe()
        solver.register_subset(u, self)
        return u

    def superset(self) -> "Universe":
        u = Universe()
        solver.register_subset(self, u)
        return u


def _dpll(clauses: list[tuple[int, ...]], init: dict[int, bool]) -> bool:
    """Satisfiability of CNF ``clauses`` (literals ±var) given the ``init``
    assumptions. Iterative DPLL: a trail with assign/undo backtracking (no
    recursion, no dict copies) and per-variable occurrence lists so unit
    propagation only visits clauses touched by new assignments — a
    negative subset query on a graph-sized clause set costs one
    propagation sweep, not O(clauses^2)."""
    occurs: dict[int, list[int]] = {}
    for ci, clause in enumerate(clauses):
        for lit in clause:
            occurs.setdefault(abs(lit), []).append(ci)

    assignment: dict[int, bool] = {}
    trail: list[int] = []  # assignment order, for undo
    #: open decisions: (trail length at decision, decided var)
    decisions: list[tuple[int, int]] = []

    def assign(var: int, value: bool) -> bool:
        """Assign + propagate; False on conflict (trail keeps additions
        for the caller to undo via backtrack)."""
        queue = [(var, value)]
        while queue:
            v, val = queue.pop()
            seen = assignment.get(v)
            if seen is not None:
                if seen != val:
                    return False
                continue
            assignment[v] = val
            trail.append(v)
            for ci in occurs.get(v, ()):
                clause = clauses[ci]
                free = None
                n_free = 0
                satisfied = False
                for lit in clause:
                    lv, want = abs(lit), lit > 0
                    cur = assignment.get(lv)
                    if cur is None:
                        n_free += 1
                        free = lit
                    elif cur == want:
                        satisfied = True
                        break
                if satisfied:
                    continue
                if n_free == 0:
                    return False
                if n_free == 1:
                    queue.append((abs(free), free > 0))
        return True

    def backtrack() -> bool:
        """Flip the most recent decision still holding its first phase;
        False when no decision remains (exhausted -> UNSAT)."""
        while decisions:
            mark, var = decisions.pop()
            first = assignment[var]
            while len(trail) > mark:
                del assignment[trail.pop()]
            # second phase is not a decision: it is forced
            if assign(var, not first):
                return True
            # conflict again: keep unwinding
            while len(trail) > mark:
                del assignment[trail.pop()]
        return False

    for var, value in init.items():
        if not assign(var, value):
            return False

    scan = 0  # moving pointer over clauses; satisfied ones are skipped
    while scan < len(clauses):
        clause = clauses[scan]
        satisfied = False
        free = None
        for lit in clause:
            lv, want = abs(lit), lit > 0
            cur = assignment.get(lv)
            if cur is None:
                free = lit
            elif cur == want:
                satisfied = True
                break
        if satisfied:
            scan += 1
            continue
        if free is None:  # falsified without any open decision left
            if not backtrack():
                return False
            scan = 0
            continue
        # decide: try the phase that satisfies this clause first
        decisions.append((len(trail), abs(free)))
        if assign(abs(free), free > 0):
            # propagation caught every falsified/unit consequence, so
            # clauses behind the pointer stay satisfied: keep moving
            # (rescanning from 0 here made scans O(clauses^2))
            scan += 1
        else:
            if not backtrack():
                return False
            scan = 0  # assignments were removed: earlier clauses may reopen
    return True


class UniverseSolver:
    """SAT-backed subset/equality reasoning with memoized queries."""

    def __init__(self) -> None:
        self._clauses: list[tuple[int, ...]] = []
        self._unions: dict[tuple[int, ...], Universe] = {}
        self._intersections: dict[tuple[int, ...], Universe] = {}
        self._differences: dict[tuple[int, int], Universe] = {}
        # clause sets only grow, and subset=True means UNSAT — which more
        # clauses can never undo: positive answers cache forever, negative
        # answers are dropped (O(1)) whenever clauses are added
        self._cache_true: set[tuple[int, int]] = set()
        self._cache_false: set[tuple[int, int]] = set()

    def _add(self, *clauses: tuple[int, ...]) -> None:
        self._clauses.extend(clauses)
        self._cache_false.clear()

    # -- axioms ------------------------------------------------------------

    def register_equal(self, a: Universe, b: Universe) -> None:
        self._add((-a.id, b.id), (-b.id, a.id))

    def register_subset(self, sub: Universe, sup: Universe) -> None:
        self._add((-sub.id, sup.id))

    def register_union(self, result: Universe, *parts: Universe) -> None:
        self._add(
            *((-p.id, result.id) for p in parts),
            (-result.id, *(p.id for p in parts)),
        )

    def register_intersection(self, result: Universe, *parts: Universe) -> None:
        self._add(
            *((-result.id, p.id) for p in parts),
            (*(-p.id for p in parts), result.id),
        )

    def register_difference(
        self, result: Universe, a: Universe, b: Universe
    ) -> None:
        self._add(
            (-result.id, a.id),
            (-result.id, -b.id),
            (-a.id, b.id, result.id),
        )

    # -- derived universes (memoized, reference get_union etc.) ------------

    def get_union(self, *parts: Universe) -> Universe:
        key = tuple(sorted(p.id for p in parts))
        got = self._unions.get(key)
        if got is None:
            got = self._unions[key] = Universe()
            self.register_union(got, *parts)
        return got

    def get_intersection(self, *parts: Universe) -> Universe:
        key = tuple(sorted(p.id for p in parts))
        got = self._intersections.get(key)
        if got is None:
            got = self._intersections[key] = Universe()
            self.register_intersection(got, *parts)
        return got

    def get_difference(self, a: Universe, b: Universe) -> Universe:
        key = (a.id, b.id)
        got = self._differences.get(key)
        if got is None:
            got = self._differences[key] = Universe()
            self.register_difference(got, a, b)
        return got

    # -- queries -----------------------------------------------------------

    def query_is_subset(self, sub: Universe, sup: Universe) -> bool:
        """True iff the axioms force every element of ``sub`` into
        ``sup``: clauses ∧ sub ∧ ¬sup must be unsatisfiable."""
        if sub.id == sup.id:
            return True
        key = (sub.id, sup.id)
        if key in self._cache_true:
            return True
        if key in self._cache_false:
            return False
        got = not _dpll(self._clauses, {sub.id: True, sup.id: False})
        (self._cache_true if got else self._cache_false).add(key)
        return got

    def query_are_equal(self, a: Universe, b: Universe) -> bool:
        return self.query_is_subset(a, b) and self.query_is_subset(b, a)

    def query_related(self, a: Universe, b: Universe) -> bool:
        return self.query_is_subset(a, b) or self.query_is_subset(b, a)


solver = UniverseSolver()
