"""Immutable per-commit read snapshots of stateful operator state.

Counterpart of ``pathway_tpu/serving/snapshot.py``. The runners' commit loops call
:meth:`SnapshotStore.publish` at every commit boundary, after
``device_pipeline.drain_until``, so a published view holds only completed device work
(the seam operator persistence cuts its checkpoints on). Readers (the query server in
:mod:`pathway_tpu_torch.serving.server`, or any in-process consumer) acquire a
refcounted :class:`ReadSnapshot` and query it while ingest goes on: the dataflow never
waits on a reader, and a reader never sees a half-applied commit.

What a publication costs:

- **KNN state.** ``HostKnnIndex.read_view`` shares the live NumPy arrays and flags the
  index, so its next in-place scatter clones first. ``DeviceKnnIndex.read_view`` clones
  the index's tensors on the card (``knn_update`` writes the live buffers in place): a
  device-to-device copy of the whole capacity at every commit, on the default stream,
  so a search on a serving thread is ordered after the clone it reads.
- **Table state** is a shallow dict copy of the operator's ``current`` map (groupby,
  join and external-index outputs); row tuples are immutable and shared.
- **Reclamation is refcounted.** The store keeps the last
  ``PATHWAY_TPU_SNAPSHOT_DEPTH`` snapshots (default 3); eviction drops the store's own
  pin, and a view's tensors are released when the last in-flight query finishes.

Every snapshot is stamped with its commit time and the graph optimizer's fingerprint.
A payload restored into a process whose graph was rewritten differently is refused, as
operator persistence refuses its checkpoints across optimizer plans.
:meth:`SnapshotStore.restore` rebuilds each KNN view as a ``HostKnnIndex``, as the
reference does: a replica searches on the host (exact f32), never on a card.
"""

from __future__ import annotations

import os
import threading
import time as _time
from typing import Any, Iterable

import numpy as np
import torch

from pathway_tpu_torch.engine.external_index import ExternalIndexNode, HostKnnIndex
from pathway_tpu_torch.engine.graph import GroupbyNode, JoinNode
from pathway_tpu_torch.engine.persistence import STATE_FORMAT
from pathway_tpu_torch.internals import metrics as _metrics

__all__ = ["ReadSnapshot", "SnapshotStore", "STORE", "StaleReadError"]


class StaleReadError(RuntimeError):
    """A read-tier store's freshest consistent view is older than the
    configured staleness bound.  The HTTP layer maps this to ``503`` +
    ``Retry-After`` — a replica that has fallen too far behind refuses
    to answer rather than silently serving unboundedly stale rows (the
    plane's contract is stale-*within-bound*-but-never-wrong)."""

#: how many published snapshots the store pins (readers can pin more)
DEFAULT_DEPTH = 3

_PUBLISHED = _metrics.REGISTRY.counter(
    "pathway_serving_snapshots_published_total",
    "read snapshots published at commit boundaries",
)
_PUBLISH_S = _metrics.REGISTRY.histogram(
    "pathway_serving_publish_seconds",
    "wall time spent publishing one read snapshot (ingest-side cost)",
    buckets=(
        0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
        0.05, 0.1, 0.25, 0.5, 1.0,
    ),
)


def _depth() -> int:
    try:
        return max(1, int(os.environ.get("PATHWAY_TPU_SNAPSHOT_DEPTH", "")))
    except ValueError:
        return DEFAULT_DEPTH


class ReadSnapshot:
    """One commit's immutable read view: per-worker, per-node state.

    ``views`` is one dict per worker scope, keyed by node position,
    each entry ``{"node": class name, "table": {key: row}, "knn": view}``
    (``knn`` only on external-index nodes).  Access goes through
    :meth:`search` / :meth:`table` / :meth:`lookup`, which merge across
    worker shards with a deterministic order.

    Lifetime is refcounted: the publishing store holds one pin; every
    concurrent reader takes another via :meth:`acquire` and must
    :meth:`release`.  The view's state is dropped only when the count
    reaches zero — never mid-query.
    """

    __slots__ = (
        "commit_time",
        "seq",
        "fingerprint",
        "published_wall",
        "views",
        "_refs",
        "_lock",
    )

    def __init__(
        self,
        commit_time: int,
        seq: int,
        fingerprint: tuple,
        views: list[dict[int, dict]],
        published_wall: float | None = None,
    ) -> None:
        self.commit_time = int(commit_time)
        self.seq = int(seq)
        self.fingerprint = tuple(fingerprint)
        self.published_wall = (
            _time.time() if published_wall is None else float(published_wall)
        )
        self.views: list[dict[int, dict]] | None = views
        # the store's retention pin
        self._refs = 1  # guarded-by: self._lock
        self._lock = threading.Lock()

    # -- lifetime ------------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self.views is None

    def acquire(self) -> bool:
        """Pin the snapshot for a read; False if already reclaimed."""
        with self._lock:
            if self._refs <= 0 or self.views is None:
                return False
            self._refs += 1
            return True

    def release(self) -> None:
        with self._lock:
            self._refs -= 1
            if self._refs <= 0:
                # last reference gone: drop the (possibly large) state so
                # the arrays and row dicts are collectable
                self.views = None

    def __enter__(self) -> "ReadSnapshot":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    # -- reads ---------------------------------------------------------------

    def _entries(self, kinds: tuple | None = None) -> Iterable[tuple[int, dict]]:
        views = self.views
        if views is None:
            raise RuntimeError("read snapshot used after reclamation")
        for worker in views:
            for pos, entry in worker.items():
                if kinds is None or entry["node"] in kinds:
                    yield pos, entry

    def knn_positions(self) -> list[int]:
        return sorted({pos for pos, e in self._entries() if "knn" in e})

    def table_positions(self) -> list[int]:
        return sorted({pos for pos, _ in self._entries()})

    def search(
        self, queries: list, k: int, node: int | None = None
    ) -> list[list[tuple]]:
        """As-of-snapshot KNN: merge per-worker shard results per query.

        Each shard's ``search`` already orders hits highest score first, ties by the
        lower slot; the merge is a stable sort of
        the concatenated per-shard lists on descending score, so ties
        resolve by worker order then within-shard order —
        deterministic, and identical to running the same merge against
        the live indexes at the same commit."""
        if len(queries) == 0:
            return []
        positions = self.knn_positions()
        if node is None:
            if not positions:
                raise LookupError("snapshot contains no KNN index state")
            node = positions[0]
        shard_results = [
            entry["knn"].search(queries, k)
            for pos, entry in self._entries()
            if pos == node and "knn" in entry
        ]
        if not shard_results:
            raise LookupError(f"no KNN index state at node position {node}")
        out: list[list[tuple]] = []
        for qi in range(len(queries)):
            merged: list[tuple] = []
            for shard in shard_results:
                merged.extend(shard[qi])
            merged.sort(key=lambda hit: -hit[1])  # stable: shard order ties
            out.append(merged[:k])
        return out

    def table(self, node: int | None = None) -> dict:
        """Merged ``{key: row}`` view of one stateful operator across
        worker shards (shards partition the key space, so the union is
        the synchronous read)."""
        positions = self.table_positions()
        if node is None:
            if not positions:
                raise LookupError("snapshot contains no table state")
            node = positions[0]
        merged: dict = {}
        found = False
        for pos, entry in self._entries():
            if pos == node:
                found = True
                merged.update(entry["table"])
        if not found:
            raise LookupError(f"no operator state at node position {node}")
        return merged

    def lookup(self, key: Any, node: int | None = None) -> Any:
        return self.table(node).get(key)

    def staleness_s(self, now: float | None = None) -> float:
        return max(0.0, (now or _time.time()) - self.published_wall)

    def cache_stamp(self) -> tuple:
        """This snapshot's result-cache identity — the same shape
        :meth:`SnapshotStore.stamp` peeks, so the handler can detect a
        publication racing between its stamp peek and the batcher's
        dispatch (insert only when they agree)."""
        return (self.commit_time, self.seq, self.fingerprint)

    # -- handoff -------------------------------------------------------------

    def payload(self) -> dict:
        """Picklable handoff payload (worker kill / failover / rescale:
        a restarted process adopts the survivor's last view so queries
        keep answering before its first commit). A view on the card is
        fetched whole to the host: its whole capacity, live slots or not."""
        views = self.views
        if views is None:
            raise RuntimeError("read snapshot used after reclamation")
        workers = []
        for worker in views:
            out: dict[int, dict] = {}
            for pos, entry in worker.items():
                item: dict = {"node": entry["node"], "table": entry["table"]}
                knn = entry.get("knn")
                if knn is not None:
                    item["knn"] = {
                        "vectors": _host_array(knn.state.vectors),
                        "valid": _host_array(knn.state.valid),
                        "norms": _host_array(knn.state.norms),
                        "key_to_slot": dict(knn.key_to_slot),
                        "free": [],
                        "capacity": knn.capacity,
                        "dim": knn.dim,
                        "metric": knn.metric,
                    }
                out[pos] = item
            workers.append(out)
        return {
            "format": STATE_FORMAT,
            "optimize": list(self.fingerprint),
            "time": self.commit_time,
            "seq": self.seq,
            "published": self.published_wall,
            "workers": workers,
        }


def _host_array(x: Any) -> np.ndarray:
    """A view's state as a host array (bf16 vectors widen to f32, as the host index
    keeps them)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.to("cpu").numpy()
    return np.asarray(x)


def _capture_scope(scope: Any) -> dict[int, dict]:
    """One worker's stateful-operator views at the current (drained)
    commit boundary."""
    out: dict[int, dict] = {}
    for pos, node in enumerate(scope.nodes):
        if isinstance(node, ExternalIndexNode):
            entry: dict = {
                "node": type(node).__name__,
                "table": dict(node.current),
            }
            read_view = getattr(node.ext_index, "read_view", None)
            if read_view is not None:
                entry["knn"] = read_view()
            out[pos] = entry
        elif isinstance(node, (GroupbyNode, JoinNode)):
            out[pos] = {
                "node": type(node).__name__,
                "table": dict(node.current),
            }
    return out


class SnapshotStore:
    """Ring of the last N published snapshots with refcounted eviction.

    One store per process (module singleton :data:`STORE`); in a TCP
    mesh every process publishes its own shard views and serves them on
    its own port — the same per-process layout as the monitoring
    endpoint."""

    def __init__(self, depth: int | None = None) -> None:
        self._lock = threading.Lock()
        self._ring: list[ReadSnapshot] = []  # guarded-by: self._lock
        self._seq = 0  # guarded-by: self._lock
        self.depth = depth
        #: called with the truncation time whenever published commits
        #: are dropped (rollback / republication): the result cache
        #: invalidates its stamps, the snapshot stream fans the command
        #: out to replicas.  Registration happens at import/startup.
        self._truncate_hooks: list = []

    def register_truncate_hook(self, fn) -> None:
        if fn not in self._truncate_hooks:
            self._truncate_hooks.append(fn)

    def _fire_truncate_hooks(self, time: int) -> None:
        # called AFTER self._lock is released: hooks take their own
        # locks (cache, stream subscriber registry) and must not nest
        # under the store's
        for fn in list(self._truncate_hooks):
            try:
                fn(int(time))
            except Exception:  # noqa: BLE001 — an observer must not break publish
                pass

    # -- write side ----------------------------------------------------------

    def publish(self, scopes: list, time: int) -> ReadSnapshot:
        """Publish the commit-``time`` read view of ``scopes`` (one per
        worker).  A publication at or below an already-published commit
        time is a rollback (mesh recovery re-drives commits) or a fresh
        run reusing the process: stale future views are truncated first,
        so readers can never observe a commit the scheduler has rolled
        back past."""
        t0 = _time.perf_counter()
        fingerprint = tuple(getattr(scopes[0], "_pw_opt_fingerprint", ()))
        views = [_capture_scope(scope) for scope in scopes]
        with self._lock:
            dropped = self._truncate_locked(int(time) - 1)
            self._seq += 1
            snap = ReadSnapshot(time, self._seq, fingerprint, views)
            self._ring.append(snap)
            depth = self.depth or _depth()
            while len(self._ring) > depth:
                self._ring.pop(0).release()
        if dropped:
            # a republication below an existing commit is a rollback in
            # disguise — cached answers stamped past it must go too
            self._fire_truncate_hooks(int(time) - 1)
        _PUBLISHED.inc()
        _PUBLISH_S.observe(_time.perf_counter() - t0)
        return snap

    def truncate(self, time: int) -> None:
        """Drop every snapshot with ``commit_time > time`` (recovery
        rolled the scheduler back to ``time``)."""
        with self._lock:
            dropped = self._truncate_locked(time)
        if dropped:
            self._fire_truncate_hooks(time)

    def _truncate_locked(self, time: int) -> int:
        keep, drop = [], []
        for snap in self._ring:
            (drop if snap.commit_time > time else keep).append(snap)
        self._ring = keep
        for snap in drop:
            snap.release()
        return len(drop)

    def clear(self) -> None:
        with self._lock:
            ring, self._ring = self._ring, []
            for snap in ring:
                snap.release()
            self._seq = 0

    # -- read side -----------------------------------------------------------

    def latest(self) -> ReadSnapshot | None:
        """Most recent snapshot WITHOUT pinning (metadata peeks only —
        query paths must use :meth:`acquire_latest`)."""
        with self._lock:
            return self._ring[-1] if self._ring else None

    def acquire_latest(self) -> ReadSnapshot | None:
        """Most recent snapshot, pinned; caller must ``release()`` (or
        use it as a context manager)."""
        with self._lock:
            for snap in reversed(self._ring):
                if snap.acquire():
                    return snap
        return None

    def stamp(self) -> tuple | None:
        """Identity of the newest live snapshot for result-cache keying:
        ``(commit_time, seq, fingerprint)``.  Two equal stamps always
        name the same immutable bytes (the rollback seam, where commit
        times are re-used, is covered by the truncate hooks)."""
        with self._lock:
            for snap in reversed(self._ring):
                if not snap.closed:
                    return (snap.commit_time, snap.seq, snap.fingerprint)
        return None

    def acquire_at(self, time: int) -> ReadSnapshot | None:
        """Newest snapshot with ``commit_time <= time``, pinned."""
        with self._lock:
            for snap in reversed(self._ring):
                if snap.commit_time <= time and snap.acquire():
                    return snap
        return None

    def snapshots(self) -> list[ReadSnapshot]:
        with self._lock:
            return list(self._ring)

    def stats(self) -> dict:
        with self._lock:
            ring = list(self._ring)
        latest = ring[-1] if ring else None
        return {
            "depth": len(ring),
            "seq": latest.seq if latest else 0,
            "commit_time": latest.commit_time if latest else None,
            "staleness_s": (
                round(latest.staleness_s(), 6) if latest else None
            ),
            "retained_commits": [s.commit_time for s in ring],
        }

    # -- handoff -------------------------------------------------------------

    def restore(
        self, payload: dict, expected_fingerprint: Iterable | None = None
    ) -> ReadSnapshot:
        """Adopt a handed-off snapshot payload (see
        :meth:`ReadSnapshot.payload`), refusing format and optimizer-
        fingerprint mismatches with the same semantics operator
        persistence applies to checkpoints. Each KNN view becomes a
        ``HostKnnIndex``: the restored snapshot searches on the host."""
        fmt = payload.get("format", 1)
        if fmt != STATE_FORMAT:
            raise ValueError(
                f"read snapshot has state format {fmt}; this build writes "
                f"format {STATE_FORMAT}: serving it would answer queries "
                "under stale keys — republish from a live commit"
            )
        got = list(payload.get("optimize", []))
        if expected_fingerprint is not None:
            want = list(expected_fingerprint)
            if want != got:
                raise ValueError(
                    "read snapshot was written under a different graph-"
                    f"optimizer plan (snapshot applied {len(got)} rewrites, "
                    f"this run applies {len(want)}): its rows have a "
                    "different column layout or fusion boundary — refuse "
                    "and keep serving the local view until the next commit"
                )
        views: list[dict[int, dict]] = []
        for worker in payload.get("workers", []):
            out: dict[int, dict] = {}
            for pos, item in worker.items():
                entry: dict = {"node": item["node"], "table": item["table"]}
                knn = item.get("knn")
                if knn is not None:
                    index = HostKnnIndex(
                        knn["dim"], knn["metric"], knn["capacity"]
                    )
                    index.restore_op_state(knn)
                    entry["knn"] = index.read_view()
                out[int(pos)] = entry
            views.append(out)
        snap = ReadSnapshot(
            payload.get("time", 0),
            payload.get("seq", 0),
            tuple(got),
            views,
            published_wall=payload.get("published"),
        )
        with self._lock:
            dropped = self._truncate_locked(snap.commit_time - 1)
            self._ring.append(snap)
            self._seq = max(self._seq, snap.seq)
            depth = self.depth or _depth()
            while len(self._ring) > depth:
                self._ring.pop(0).release()
        if dropped:
            self._fire_truncate_hooks(snap.commit_time - 1)
        return snap


#: the process-wide store the runners publish into and the server reads
STORE = SnapshotStore()


def _collect_staleness():
    snap = STORE.latest()
    if snap is None:
        return
    yield (
        "pathway_serving_snapshot_staleness_seconds",
        "gauge",
        "age of the newest published read snapshot",
        {},
        snap.staleness_s(),
    )
    yield (
        "pathway_serving_snapshot_seq",
        "gauge",
        "sequence number of the newest published read snapshot",
        {},
        float(snap.seq),
    )
    yield (
        "pathway_serving_snapshot_commit_time",
        "gauge",
        "commit time of the newest published read snapshot",
        {},
        float(snap.commit_time),
    )


_metrics.REGISTRY.register_collector(_collect_staleness)
