"""Commit-stamped LRU result cache for the serving read tier.

Counterpart of ``pathway_tpu/serving/result_cache.py``, the same keys, budget and
knobs.

Every cache key embeds the identity of the immutable
:class:`~pathway_tpu_torch.serving.snapshot.ReadSnapshot` the answer was
computed against::

    (endpoint, commit_time, seq, rewrite-fingerprint, query-digest)

which makes the cache *correct by construction*: snapshots are
immutable, so a key can never map to two different answers.  A new
publication changes the store's stamp, so every lookup after it misses
and recomputes — "invalidation by publication" falls out of the keying
rather than requiring an invalidation protocol.  The one seam where a
stamp CAN be reused with different content is mesh rollback (recovery
re-drives commit times), so :meth:`ResultCache.invalidate_above` is
hooked into ``SnapshotStore.truncate`` and drops every entry stamped
past the rollback point (the cache may only ever serve bytes that a fresh
recompute would produce bit-identically).

Bounded LRU by **bytes**, not entries — cached values are serialized
response bodies whose sizes vary by orders of magnitude between a
point lookup and a fat KNN answer.

Env knobs (both live — re-read per lookup/insert, so operators can flip
the cache or resize it mid-run):

- ``PATHWAY_TPU_RESULT_CACHE`` — 0 disables lookups AND inserts
- ``PATHWAY_TPU_RESULT_CACHE_BYTES`` — byte budget (default 64 MiB)
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import Any, Hashable

from pathway_tpu_torch.internals import metrics as _metrics
from pathway_tpu_torch.serving import snapshot as _snapshot

__all__ = ["ResultCache", "CACHE", "enabled", "byte_budget", "query_digest"]

DEFAULT_BYTES = 64 << 20

_EVENTS = {
    kind: _metrics.REGISTRY.counter(
        "pathway_serving_cache_events_total",
        "result-cache events by kind (hit/miss/evict/invalidate)",
        kind=kind,
    )
    for kind in ("hit", "miss", "evict", "invalidate")
}
_HIT_LATENCY = _metrics.REGISTRY.histogram(
    "pathway_serving_cache_hit_latency_seconds",
    "request latency when the answer was served from the result cache",
    buckets=(
        0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
        0.01, 0.025, 0.05, 0.1,
    ),
)


def enabled() -> bool:
    """Live per lookup: flipping PATHWAY_TPU_RESULT_CACHE=0 takes effect
    on the next request, not the next process."""
    return os.environ.get("PATHWAY_TPU_RESULT_CACHE", "1").lower() not in (
        "0",
        "false",
        "no",
    )


def byte_budget() -> int:
    """Live per insert, so the bound can be tightened mid-run."""
    try:
        return max(0, int(os.environ.get("PATHWAY_TPU_RESULT_CACHE_BYTES", "")))
    except ValueError:
        return DEFAULT_BYTES


def query_digest(endpoint: str, material: bytes) -> str:
    """Stable digest of one query's full identity (endpoint + canonical
    request bytes).  SHA-256 so distinct queries cannot collide into one
    cache slot within any realistic keyspace."""
    h = hashlib.sha256()
    h.update(endpoint.encode())
    h.update(b"\x00")
    h.update(material)
    return h.hexdigest()


class ResultCache:
    """Byte-bounded LRU of commit-stamped serialized answers."""

    def __init__(self, max_bytes: int | None = None) -> None:
        self.max_bytes = max_bytes  # None -> live env read per insert
        self._lock = threading.Lock()
        self._entries: OrderedDict[Hashable, tuple[Any, int, int]] = (
            OrderedDict()
        )  # guarded-by: self._lock  (key -> (value, nbytes, commit_time))
        self._bytes = 0  # guarded-by: self._lock

    # -- read side -----------------------------------------------------------

    def get(self, key: Hashable) -> Any:
        """Cached value or None; counts the hit/miss and refreshes LRU
        position on hit."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                hit = False
            else:
                self._entries.move_to_end(key)
                hit = True
        if hit:
            _EVENTS["hit"].inc()
            return entry[0]
        _EVENTS["miss"].inc()
        return None

    def observe_hit_latency(self, seconds: float) -> None:
        _HIT_LATENCY.observe(seconds)

    # -- write side ----------------------------------------------------------

    def put(
        self, key: Hashable, value: Any, nbytes: int, commit_time: int
    ) -> None:
        if not enabled():
            return
        budget = self.max_bytes if self.max_bytes is not None else byte_budget()
        nbytes = max(1, int(nbytes))
        if nbytes > budget:
            return  # one oversized answer must not wipe the whole cache
        evicted = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, nbytes, int(commit_time))
            self._bytes += nbytes
            while self._bytes > budget and self._entries:
                _k, (_v, n, _t) = self._entries.popitem(last=False)
                self._bytes -= n
                evicted += 1
        if evicted:
            _EVENTS["evict"].inc(evicted)
            # recorded on the inserting request's handler thread, so the
            # event carries that request's trace id when it is sampled
            _metrics.FLIGHT.record(
                "cache_evict", evicted=evicted, bytes=self._bytes
            )

    def invalidate_above(self, commit_time: int) -> int:
        """Drop every entry stamped with ``commit_time > time`` — the
        rollback seam where the mesh re-uses commit times with
        different content.  Returns the number of entries dropped."""
        dropped = 0
        with self._lock:
            for key in list(self._entries):
                if self._entries[key][2] > commit_time:
                    _value, n, _t = self._entries.pop(key)
                    self._bytes -= n
                    dropped += 1
        if dropped:
            _EVENTS["invalidate"].inc(dropped)
        return dropped

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    # -- accounting ----------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            entries = len(self._entries)
            nbytes = self._bytes
        hits = _EVENTS["hit"].value
        misses = _EVENTS["miss"].value
        total = hits + misses
        return {
            "entries": entries,
            "bytes": nbytes,
            "max_bytes": (
                self.max_bytes if self.max_bytes is not None else byte_budget()
            ),
            "hits": hits,
            "misses": misses,
            "evictions": _EVENTS["evict"].value,
            "invalidations": _EVENTS["invalidate"].value,
            "hit_rate": round(hits / total, 4) if total else None,
            "enabled": enabled(),
        }


#: process-wide cache: the query server, replica server, and federation
#: front all insert under disjoint endpoint prefixes in the key
CACHE = ResultCache()


def _collect_cache():
    with CACHE._lock:
        entries = len(CACHE._entries)
        nbytes = CACHE._bytes
    yield (
        "pathway_serving_cache_bytes",
        "gauge",
        "bytes pinned by the serving result cache",
        {},
        float(nbytes),
    )
    yield (
        "pathway_serving_cache_entries",
        "gauge",
        "entries pinned by the serving result cache",
        {},
        float(entries),
    )


_metrics.REGISTRY.register_collector(_collect_cache)

# rollback seam: SnapshotStore.truncate (driven by
# DistributedScheduler.rollback) must also invalidate every cached
# answer stamped past the rollback point — commit times are re-used
# with different content afterwards, and the cache's contract is
# bit-identical-to-recompute
_snapshot.STORE.register_truncate_hook(CACHE.invalidate_above)
