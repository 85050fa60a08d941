"""Measurement-driven host/device placement of the device operators.

Counterpart of ``pathway_tpu/optimize/placement.py``. The optimizer's fourth pass, but
it rewrites nothing: it *annotates* the eligible operators (groupby, join, external KNN
index) and seeds the process-wide :data:`POLICY`, which then decides host or card per
operator and per batch at run time from observed cost.

Why at run time: the right placement depends on the batch size and the device (a
200-row commit loses to the launch and the upload; a 1M-row commit may win), which the
plan cannot know. The policy keeps an EMA of ns/row for each side of each operator,
probes both sides first, then follows the cheaper side with hysteresis (a side must win
by 20% to flip the decision) and re-probes the losing side every 256 calls, so a
placement can recover when batch shapes drift.

Chain-aware placement: the pass links adjacent eligible operators
(:meth:`PlacementPolicy.link`); the residency plane reports what each host
materialization at a consumer's seam cost (:meth:`PlacementPolicy.record_seam`), and
``choose()`` credits that cost to the device side when a linked neighbour sits on the
card and residency is on. Nothing stays resident between operators yet (the resident
batches come with the collective exchange, ROADMAP queue 1 item 14, slice c), so no
seam is recorded and the credit is 0; the machinery is kept whole.

The pass is annotation-only on purpose: it runs even on graphs the rewriting passes
skip, and it costs one cached environment check when ``PATHWAY_TPU_DEVICE_OPS=0``.
"""

from __future__ import annotations

import os
import threading

__all__ = ["PlacementPolicy", "POLICY", "min_rows", "run_pass"]

#: EMA smoothing for observed ns/row
_ALPHA = 0.3


def min_rows() -> int:
    """Batches below this row count stay on the host in auto mode: the launch and the
    upload dominate tiny commits (forced mode ignores it, so tests reach the device
    operators on small batches). ``PATHWAY_TPU_DEVICE_OPS_MIN_ROWS``, default 512."""
    try:
        return max(0, int(os.environ.get("PATHWAY_TPU_DEVICE_OPS_MIN_ROWS", "512")))
    except ValueError:
        return 512


class PlacementPolicy:
    """Per-operator host/device arbitration from observed cost.

    Keyed by ``(op kind, operator position)``. The enabled / forced / min-rows gates are
    pluggable so another device plane can reuse the EMA and hysteresis against its own
    environment contract; the default instance (:data:`POLICY`) gates on
    ``PATHWAY_TPU_DEVICE_OPS`` through ``engine/device_ops.py``."""

    #: calls of each side to observe before judging
    PROBE_CALLS = 3
    #: a side must be this factor cheaper to flip the decision
    HYSTERESIS = 1.2
    #: re-probe the losing side every this many calls
    REPROBE_EVERY = 256

    def __init__(self, enabled_fn=None, forced_fn=None, min_rows_fn=None) -> None:
        self._lock = threading.Lock()
        self._stats: dict = {}  # guarded-by: _lock
        self._links: dict = {}  # guarded-by: _lock; key -> set of adjacent keys
        self._enabled_fn = enabled_fn
        self._forced_fn = forced_fn
        self._min_rows_fn = min_rows_fn

    def _gates(self):
        """The (enabled, forced, min_rows) gates, bound to device_ops on first use
        for the default instance, so importing this module pulls no engine in."""
        if self._enabled_fn is None:
            from pathway_tpu_torch.engine import device_ops as _dops

            self._enabled_fn = _dops.enabled
            self._forced_fn = _dops.forced
            self._min_rows_fn = min_rows
        return self._enabled_fn, self._forced_fn, self._min_rows_fn

    def _entry_locked(self, key) -> dict:
        st = self._stats.get(key)
        if st is None:
            st = self._stats[key] = {
                "host_calls": 0,
                "device_calls": 0,
                "host_ns_per_row": None,
                "device_ns_per_row": None,
                "seam_ns_per_row": None,
                "seam_events": 0,
                "rows": 0,
                "device": False,
            }
        return st

    def seed(self, kind: str, index: int, device: bool | None = None) -> None:
        """Register an eligible operator, so ``decisions()`` lists every candidate
        before the first batch."""
        with self._lock:
            st = self._entry_locked((kind, index))
            if device is not None:
                st["device"] = device

    def link(self, kind_a: str, index_a: int, kind_b: str, index_b: int) -> None:
        """Declare two eligible operators adjacent (the producer feeds the consumer
        through a seam). Links are symmetric: either end on the card makes residency
        possible across the seam."""
        a, b = (kind_a, index_a), (kind_b, index_b)
        if a == b:
            return
        with self._lock:
            self._entry_locked(a)
            self._entry_locked(b)
            self._links.setdefault(a, set()).add(b)
            self._links.setdefault(b, set()).add(a)

    def record_seam(self, kind: str, index: int, n_rows: int, ns: int) -> None:
        """Fold one observed seam materialization (a resident batch fetched to the
        host at this consumer) into the seam-cost EMA."""
        per_row = float(ns) / max(1, n_rows)
        with self._lock:
            st = self._entry_locked((kind, index))
            st["seam_events"] += 1
            prev = st["seam_ns_per_row"]
            st["seam_ns_per_row"] = (
                per_row if prev is None else (1.0 - _ALPHA) * prev + _ALPHA * per_row
            )

    def is_device(self, kind: str, index: int) -> bool:
        """The operator's current placement (False for unknown keys)."""
        with self._lock:
            st = self._stats.get((kind, index))
            return bool(st and st["device"])

    def _chain_credit(self, key: tuple, st: dict) -> float:
        """ns/row credited to the device side of ``key`` for the seam transfers
        residency would save: this operator's own seam EMA, when residency is on and a
        linked neighbour sits on the card. Caller holds ``self._lock``."""
        links = self._links.get(key)
        if not links:
            return 0.0
        seam = st["seam_ns_per_row"]
        if not seam:
            return 0.0
        if not any(n in self._stats and self._stats[n]["device"] for n in links):
            return 0.0
        if not _residency_on():
            return 0.0
        return float(seam)

    def choose(self, kind: str, index: int, n_rows: int) -> bool:
        """True: run this batch on the card. On the batch hot path, so the disabled
        case stays one cached environment check."""
        enabled_fn, forced_fn, min_rows_fn = self._gates()
        if not enabled_fn():
            return False
        if forced_fn():
            return True
        if n_rows < min_rows_fn():
            return False
        with self._lock:
            st = self._entry_locked((kind, index))
            # bootstrap: measure both sides before judging
            if st["device_calls"] < self.PROBE_CALLS:
                return True
            if st["host_calls"] < self.PROBE_CALLS:
                return False
            total = st["host_calls"] + st["device_calls"]
            if total % self.REPROBE_EVERY == 0:
                return not st["device"]  # refresh the losing side's EMA
            d = st["device_ns_per_row"]
            h = st["host_ns_per_row"]
            if d is not None:
                # next to a neighbour on the card, the card saves the seam's
                # materialization: score it in
                d = max(0.0, d - self._chain_credit((kind, index), st))
            if st["device"]:
                if d is not None and h is not None and h * self.HYSTERESIS < d:
                    st["device"] = False
            else:
                if d is not None and h is not None and d * self.HYSTERESIS < h:
                    st["device"] = True
            return st["device"]

    def record(self, kind: str, index: int, device: bool, n_rows: int, ns: int) -> None:
        """Fold one observed execution into the EMA of its side."""
        per_row = float(ns) / max(1, n_rows)
        with self._lock:
            st = self._entry_locked((kind, index))
            side = "device" if device else "host"
            st[side + "_calls"] += 1
            key = side + "_ns_per_row"
            prev = st[key]
            st[key] = per_row if prev is None else (1.0 - _ALPHA) * prev + _ALPHA * per_row
            st["rows"] += int(n_rows)
            if device and not st["device"] and st["host_calls"] == 0:
                # forced and bootstrap runs on the card count as a device placement
                st["device"] = True

    def decisions(self) -> dict:
        """Snapshot for a run's report: ``{"kind:index": {...}}``."""
        out = {}
        with self._lock:
            for (kind, index), st in sorted(
                self._stats.items(), key=lambda kv: (kv[0][0], kv[0][1])
            ):
                out[f"{kind}:{index}"] = {
                    "device": bool(st["device"]),
                    "host_calls": st["host_calls"],
                    "device_calls": st["device_calls"],
                    "host_ns_per_row": _round(st["host_ns_per_row"]),
                    "device_ns_per_row": _round(st["device_ns_per_row"]),
                    "seam_ns_per_row": _round(st["seam_ns_per_row"]),
                    "seam_events": st["seam_events"],
                    "links": sorted(
                        f"{k}:{i}" for (k, i) in self._links.get((kind, index), ())
                    ),
                    "rows": st["rows"],
                }
        return out

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
            self._links.clear()


def _round(v: float | None) -> float | None:
    return None if v is None else round(v, 1)


def _residency_on() -> bool:
    """The residency plane's gate, imported here: residency imports this module's
    POLICY inside functions only."""
    from pathway_tpu_torch.engine import device_residency as _dres

    return _dres.enabled()


#: the process-wide policy every operator consults
POLICY = PlacementPolicy()


def run_pass(scopes: list) -> tuple[int, int]:
    """The optimizer's placement pass: annotate the eligible operators and seed the
    policy. Returns ``(eligible, placed_on_device)`` for the optimizer's stats; one
    cached environment check when the device operators are off."""
    from pathway_tpu_torch.engine import device_ops as _dops

    if not _dops.enabled():
        return 0, 0
    from pathway_tpu_torch.engine.graph import GroupbyNode, JoinNode

    force = _dops.forced()
    eligible = 0
    placed = 0
    seen: set = set()
    for scope in scopes:
        for pos, node in enumerate(scope.nodes):
            kind = None
            if isinstance(node, GroupbyNode):
                kind = "groupby"
            elif isinstance(node, JoinNode) and getattr(node, "_columnar_ok", False):
                kind = "join"
            elif type(node).__name__ == "ExternalIndexNode":
                kind = "knn"
            if kind is None:
                continue
            node._device_ops_eligible = kind
            if (kind, pos) in seen:
                continue  # a replica of an operator already counted
            seen.add((kind, pos))
            eligible += 1
            # KNN indexes are placed by their factory; groupby and join start on the
            # card only when forced
            device = force or (
                kind == "knn"
                and type(getattr(node, "ext_index", None)).__name__ == "DeviceKnnIndex"
            )
            POLICY.seed(kind, pos, device=device or None)
            if device:
                placed += 1
    # second walk, once every operator is annotated: link each eligible operator to
    # the next eligible one downstream (through non-eligible nodes, bounded, since
    # seams are local), and mark each node walked upstream with the eligible operator
    # it feeds (``_device_residency_downstream``, the residency plane's seam key).
    # Fusion later mutates a chain tail's ``__class__`` in place, so the mark
    # survives onto the FusedChainNode.
    for scope in scopes:
        for node in scope.nodes:
            kind = getattr(node, "_device_ops_eligible", None)
            if kind is None:
                continue
            up = [(inp, 0) for inp in node.inputs]
            seen_up: set = set()
            while up:
                prev, depth = up.pop()
                if id(prev) in seen_up or depth > 4:
                    continue
                seen_up.add(id(prev))
                if getattr(prev, "_device_ops_eligible", None) is not None:
                    continue
                if getattr(prev, "_device_residency_downstream", None) is None:
                    prev._device_residency_downstream = (kind, node.index)
                up.extend((i, depth + 1) for i in prev.inputs)
            frontier = [(c, 0) for c, _port in node.consumers]
            visited: set = set()
            while frontier:
                nxt, depth = frontier.pop()
                if id(nxt) in visited or depth > 4:
                    continue
                visited.add(id(nxt))
                ckind = getattr(nxt, "_device_ops_eligible", None)
                if ckind is not None:
                    POLICY.link(kind, node.index, ckind, nxt.index)
                    continue
                frontier.extend((c, depth + 1) for c, _port in nxt.consumers)
    return eligible, placed
