"""Read-only replica: scale query capacity independently of ingest width.

Counterpart of ``pathway_tpu/serving/replica.py``. A replica holds the restored
snapshots of :meth:`SnapshotStore.restore`, whose KNN views are ``HostKnnIndex``
instances: it searches on the host (exact f32) and needs no card. Its answers equal the
worker's on a host index bit for bit; against a worker whose index is on the card they
agree outside ties, with ``dist`` within the card's rounding.

A replica process subscribes to every mesh worker's snapshot stream
(:mod:`pathway_tpu_torch.serving.stream`), keeps one
:class:`~pathway_tpu_torch.serving.snapshot.SnapshotStore` per source worker,
and serves the standard ``/serving/*`` endpoints (same
:class:`~pathway_tpu_torch.serving.server.QueryServer`, same result cache)
over a **consistent cut at the minimum common commit** across sources.
Mesh commits are driven synchronously by the coordinator, so every
worker shares one commit clock — the min common commit is a real
consistent state of the whole dataflow, and answers from it are
bit-identical to a client-side fan-out merge of the workers' own
snapshots at that commit.

Bounded staleness, never wrong:

- Frames are epoch-fenced (:class:`~pathway_tpu_torch.engine.distributed.
  EpochFence`): a ``snap`` frame stamped below the fence floor is a
  zombie publisher's and is dropped; ``snap-rollback`` commands are
  admitted exactly once per epoch and truncate the per-source store
  (which also invalidates the result cache above the rollback point).
- A query whose freshest consistent cut is older than
  ``PATHWAY_TPU_REPLICA_MAX_STALENESS_S`` (live, default 5 s) is
  refused with ``503`` + ``Retry-After`` — through leader failover and
  rescale the replica keeps answering 200s while its cut is within
  bound and degrades to 503s (never 5xx, never wrong rows) beyond it.
- Rescale adaptation: ``snap-hello`` frames carry the mesh width; a
  replica built on the port-scheme source set subscribes to new workers
  and drops vanished ones automatically.

Start one with ``pathway replica --port 24000`` (CLI) or
:func:`serve` in-process.  Query ports default to
``24000 + replica_id`` (``PATHWAY_TPU_REPLICA_PORT_BASE``).
"""

from __future__ import annotations

import os
import socket
import threading
import time as _time
from typing import Any, Iterable

from pathway_tpu_torch.internals import metrics as _metrics
from pathway_tpu_torch.serving import result_cache as _result_cache
from pathway_tpu_torch.serving import snapshot as _snapshot
from pathway_tpu_torch.serving import stream as _stream
from pathway_tpu_torch.serving.snapshot import StaleReadError

__all__ = [
    "Replica",
    "ReplicaStore",
    "StaleReadError",
    "replica_port",
    "parse_sources",
    "max_staleness_s",
    "main",
]

BASE_PORT = 24000

_FRAMES = {
    kind: _metrics.REGISTRY.counter(
        "pathway_serving_replica_frames_total",
        "snapshot-stream frames processed by this replica, by kind",
        kind=kind,
    )
    for kind in ("snap", "snap-rollback", "snap-hello", "fenced", "refused")
}
_RECONNECTS = _metrics.REGISTRY.counter(
    "pathway_serving_replica_reconnects_total",
    "source-stream reconnect attempts (failover/rescale churn)",
)
_STALE_503 = _metrics.REGISTRY.counter(
    "pathway_serving_replica_stale_total",
    "queries refused with 503 because the consistent cut exceeded "
    "the staleness bound",
)

#: live replicas in this process, for the lag/source collectors
_ACTIVE: list["Replica"] = []
_ACTIVE_LOCK = threading.Lock()


def replica_port(replica_id: int = 0) -> int:
    base = int(os.environ.get("PATHWAY_TPU_REPLICA_PORT_BASE", BASE_PORT))
    return base + int(replica_id)


def max_staleness_s() -> float:
    """Live per query: tightening the bound mid-run takes effect on the
    next request."""
    try:
        return float(
            os.environ.get("PATHWAY_TPU_REPLICA_MAX_STALENESS_S", "")
        )
    except ValueError:
        return 5.0


def parse_sources(spec: str) -> list[tuple[str, int]]:
    """``"host:port,host:port"`` (bare ports imply 127.0.0.1)."""
    out: list[tuple[str, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            host, _, port = part.rpartition(":")
            out.append((host or "127.0.0.1", int(port)))
        else:
            out.append(("127.0.0.1", int(part)))
    return out


class _ReplicaSnapshot:
    """A pinned consistent cut: one ReadSnapshot per source worker, all
    at the same commit time.  Exposes the subset of the ReadSnapshot
    surface the query server uses; ``release`` unpins every part."""

    __slots__ = ("parts", "commit_time", "seq", "fingerprint")

    def __init__(self, parts: list[tuple[int, "_snapshot.ReadSnapshot"]]):
        self.parts = sorted(parts, key=lambda p: p[0])
        self.commit_time = min(s.commit_time for _sid, s in self.parts)
        self.seq = max(s.seq for _sid, s in self.parts)
        self.fingerprint = self.parts[0][1].fingerprint

    def search(
        self, queries: list, k: int, node: int | None = None
    ) -> list[list[tuple]]:
        """Same merge contract as :meth:`ReadSnapshot.search`: stable
        sort of the concatenated per-source hit lists on descending
        score, sources in ascending worker order — bit-identical to a
        client-side per-worker fan-out merge at this commit."""
        if len(queries) == 0:
            return []
        per_source = [s.search(queries, k, node) for _sid, s in self.parts]
        out: list[list[tuple]] = []
        for qi in range(len(queries)):
            merged: list[tuple] = []
            for rows in per_source:
                merged.extend(rows[qi])
            merged.sort(key=lambda hit: -hit[1])  # stable: source order ties
            out.append(merged[:k])
        return out

    def table(self, node: int | None = None) -> dict:
        merged: dict = {}
        for _sid, s in self.parts:
            merged.update(s.table(node))
        return merged

    def staleness_s(self, now: float | None = None) -> float:
        return max(s.staleness_s(now) for _sid, s in self.parts)

    def cache_stamp(self) -> tuple:
        return (
            self.commit_time,
            tuple((sid, s.commit_time, s.seq) for sid, s in self.parts),
            self.fingerprint,
        )

    def release(self) -> None:
        for _sid, s in self.parts:
            s.release()


class ReplicaStore:
    """Composite over per-source stores, presenting the SnapshotStore
    read surface (``acquire_latest``/``stamp``/``stats``) at the min
    common commit so :class:`QueryServer` serves it unchanged."""

    def __init__(self, max_staleness: float | None = None) -> None:
        self.max_staleness = max_staleness  # None -> live env read
        self._lock = threading.Lock()
        self._stores: dict[int, _snapshot.SnapshotStore] = (
            {}
        )  # guarded-by: self._lock

    def store_for(self, source_id: int) -> _snapshot.SnapshotStore:
        with self._lock:
            store = self._stores.get(source_id)
            if store is None:
                store = self._stores[source_id] = _snapshot.SnapshotStore()
                # rollback seam: truncating any source store invalidates
                # every cached cut stamped past the rollback point
                store.register_truncate_hook(
                    _result_cache.CACHE.invalidate_above
                )
            return store

    def drop_source(self, source_id: int) -> None:
        with self._lock:
            store = self._stores.pop(source_id, None)
        if store is not None:
            store.clear()

    def source_ids(self) -> list[int]:
        with self._lock:
            return sorted(self._stores)

    def _stores_snapshot(self) -> dict[int, _snapshot.SnapshotStore]:
        with self._lock:
            return dict(self._stores)

    def _bound(self) -> float:
        return (
            self.max_staleness
            if self.max_staleness is not None
            else max_staleness_s()
        )

    def acquire_latest(self) -> _ReplicaSnapshot | None:
        """Pin the freshest consistent cut.  None before the first full
        set of source snapshots exists (the server answers 200-empty);
        :class:`StaleReadError` when the cut exceeds the staleness
        bound (the server answers 503 + Retry-After)."""
        stores = self._stores_snapshot()
        if not stores:
            return None
        heads = {}
        for sid, store in stores.items():
            head = store.latest()
            if head is None:
                return None  # a source has never published: not ready
            heads[sid] = head
        cut_time = min(h.commit_time for h in heads.values())
        parts: list[tuple[int, _snapshot.ReadSnapshot]] = []
        fingerprint = None
        for sid, store in sorted(stores.items()):
            snap = store.acquire_at(cut_time)
            if snap is None:
                for _s, pinned in parts:
                    pinned.release()
                return None  # cut raced a truncate; next publish heals
            if fingerprint is None:
                fingerprint = snap.fingerprint
            elif snap.fingerprint != fingerprint:
                # mixed optimizer plans mid-upgrade: serving a merged
                # view would mix column layouts — refuse the cut
                snap.release()
                for _s, pinned in parts:
                    pinned.release()
                _FRAMES["refused"].inc()
                return None
            parts.append((sid, snap))
        cut = _ReplicaSnapshot(parts)
        staleness = cut.staleness_s()
        bound = self._bound()
        if staleness > bound:
            cut.release()
            _STALE_503.inc()
            # cut-level detail; the request-side 503 (with the refused
            # request's trace id) is recorded by the server's _stale
            _metrics.FLIGHT.record(
                "replica_stale_cut",
                commit_time=cut.commit_time,
                staleness_s=round(staleness, 6),
                bound_s=bound,
            )
            raise StaleReadError(
                f"replica cut at commit {cut.commit_time} is "
                f"{staleness:.3f}s stale (bound {bound:g}s) — refusing "
                "to answer beyond the staleness contract"
            )
        return cut

    def stamp(self) -> tuple | None:
        stores = self._stores_snapshot()
        if not stores:
            return None
        per_source = []
        for sid, store in sorted(stores.items()):
            st = store.stamp()
            if st is None:
                return None
            per_source.append((sid, st[0], st[1]))
        commit = min(c for _sid, c, _s in per_source)
        fingerprint = None
        head = stores[per_source[0][0]].latest()
        if head is not None:
            fingerprint = head.fingerprint
        return (commit, tuple(per_source), fingerprint)

    def lag_s(self) -> float | None:
        """Age of the freshest consistent cut (the replica-lag gauge)."""
        stores = self._stores_snapshot()
        if not stores:
            return None
        oldest = None
        for store in stores.values():
            head = store.latest()
            if head is None:
                return None
            age = head.staleness_s()
            oldest = age if oldest is None else max(oldest, age)
        return oldest

    def stats(self) -> dict:
        stores = self._stores_snapshot()
        per_source = {str(sid): s.stats() for sid, s in sorted(stores.items())}
        commits = [
            st["commit_time"]
            for st in per_source.values()
            if st["commit_time"] is not None
        ]
        lag = self.lag_s()
        return {
            "replica": True,
            "sources": len(stores),
            "cut_commit_time": (
                min(commits) if len(commits) == len(per_source) and commits
                else None
            ),
            "lag_s": round(lag, 6) if lag is not None else None,
            "max_staleness_s": self._bound(),
            "per_source": per_source,
            # QueryServer /serving/health parity fields
            "depth": sum(st["depth"] for st in per_source.values()),
            "seq": max(
                (st["seq"] for st in per_source.values()), default=0
            ),
            "commit_time": (
                min(commits) if len(commits) == len(per_source) and commits
                else None
            ),
            "staleness_s": round(lag, 6) if lag is not None else None,
        }


class _SourceSub:
    """Subscriber thread for one worker's snapshot stream: dial,
    handshake, ingest frames into the per-source store, reconnect with
    backoff through failover and rescale."""

    def __init__(
        self, replica: "Replica", source_id: int, host: str, port: int
    ) -> None:
        self.replica = replica
        self.source_id = source_id
        self.host = host
        self.port = port
        self.store = replica.store.store_for(source_id)
        self._sock: socket.socket | None = None
        self._stop = threading.Event()
        self._fence_obj = None  # EpochFence, built lazily (heavy import)
        self._last_stats_push = 0.0
        self._thread = threading.Thread(
            target=self._run,
            name=f"pw-replica-sub-{source_id}",
            daemon=True,
        )

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        sock = self._sock
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)

    # -- wire helpers --------------------------------------------------------

    def _send(self, frame: tuple) -> None:
        from pathway_tpu_torch.engine.distributed import send_stream_frame

        send_stream_frame(self._sock, frame, self.replica.secret)

    def _recv(self) -> Any:
        from pathway_tpu_torch.engine.distributed import recv_stream_frame

        return recv_stream_frame(self._sock, self.replica.secret)

    def _fence(self):
        if self._fence_obj is None:
            from pathway_tpu_torch.engine.distributed import EpochFence

            self._fence_obj = EpochFence()
        return self._fence_obj

    # -- subscription loop ---------------------------------------------------

    def _run(self) -> None:
        backoff = 0.2
        while not self._stop.is_set():
            try:
                sock = socket.create_connection(
                    (self.host, self.port), timeout=2.0
                )
                sock.settimeout(1.0)
                self._sock = sock
                last = self.store.latest()
                self._send(
                    (
                        "snap-sub",
                        self._fence().floor("snap"),
                        last.seq if last is not None else 0,
                        self.replica.replica_id,
                    )
                )
                backoff = 0.2
                while not self._stop.is_set():
                    try:
                        frame = self._recv()
                    except socket.timeout:
                        self._maybe_push_stats()
                        continue
                    self._handle_frame(frame)
            except (ConnectionError, OSError, EOFError, ValueError):
                pass
            finally:
                sock = self._sock
                self._sock = None
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
            if self._stop.is_set():
                return
            _RECONNECTS.inc()
            # bounded backoff, polled so stop() never waits long
            self._stop.wait(backoff)
            backoff = min(backoff * 2.0, 2.0)

    def _handle_frame(self, frame: Any) -> None:
        kind, epoch, a, b = frame
        if kind == "snap":
            fence = self._fence()
            floor = fence.floor("snap")
            if epoch > floor:
                fence.admit("snap", epoch)
            elif epoch < floor:
                _FRAMES["fenced"].inc()
                return  # zombie publisher from before the fence rose
            try:
                self.store.restore(b)
            except ValueError:
                _FRAMES["refused"].inc()  # format/fingerprint mismatch
                return
            _FRAMES["snap"].inc()
            self.replica.mark_frame()
        elif kind == "snap-rollback":
            fence = self._fence()
            if not fence.admit("snap-rollback", epoch):
                return  # duplicated/zombie command: already executed
            self._handle_rollback(int(a))
        elif kind == "snap-hello":
            _FRAMES["snap-hello"].inc()
            self.replica.on_width(int(a))

    def _handle_rollback(self, to_time: int) -> None:
        # truncate fires the result-cache invalidation hook; the next
        # admitted snap frame republishes past this point
        self.store.truncate(to_time)
        _FRAMES["snap-rollback"].inc()

    def _maybe_push_stats(self) -> None:
        """Piggyback this replica's registry snapshot upstream (to the
        leader only) so the mesh ``/metrics`` exposition carries
        ``worker="r<id>"`` label sets while we are connected."""
        if self.source_id != 0:
            return
        now = _time.monotonic()
        if now - self._last_stats_push < 1.5:
            return
        self._last_stats_push = now
        snap = _metrics.full_snapshot(None)
        self._send(
            (
                "snap-stats",
                self._fence().floor("snap"),
                self.replica.replica_id,
                snap,
            )
        )


class Replica:
    """Lifecycle wrapper: per-source subscribers + a QueryServer over
    the consistent cut."""

    def __init__(
        self,
        sources: list[tuple[str, int]] | None = None,
        port: int | None = None,
        replica_id: int = 0,
        max_staleness: float | None = None,
        width: int | None = None,
        host: str = "127.0.0.1",
    ) -> None:
        from pathway_tpu_torch.engine.distributed import _mesh_secret
        from pathway_tpu_torch.serving.server import QueryServer

        self.replica_id = int(replica_id)
        self.secret = _mesh_secret()
        self._port_scheme = sources is None
        self._scheme_host = host
        if sources is None:
            if width is None:
                width = int(os.environ.get("PATHWAY_PROCESSES", "1"))
            sources = [
                (host, _stream.stream_port(pid)) for pid in range(width)
            ]
        self.store = ReplicaStore(max_staleness=max_staleness)
        self.port = port if port is not None else replica_port(replica_id)
        self.server = QueryServer(
            store=self.store, port=self.port, batch_window_ms=0.0
        )
        self._lock = threading.Lock()
        self._subs: dict[int, _SourceSub] = {}  # guarded-by: self._lock
        self._last_frame_wall = 0.0
        for sid, (src_host, src_port) in enumerate(sources):
            self._subs[sid] = _SourceSub(self, sid, src_host, src_port)

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "Replica":
        self.server.start()
        with self._lock:
            subs = list(self._subs.values())
        for sub in subs:
            sub.start()
        with _ACTIVE_LOCK:
            if self not in _ACTIVE:
                _ACTIVE.append(self)
        _metrics.FLIGHT.record(
            "replica_start", replica=self.replica_id, port=self.port
        )
        return self

    def stop(self) -> None:
        with _ACTIVE_LOCK:
            if self in _ACTIVE:
                _ACTIVE.remove(self)
        with self._lock:
            subs = list(self._subs.values())
            self._subs = {}
        for sub in subs:
            sub.stop()
        self.server.stop()
        _metrics.FLIGHT.record("replica_stop", replica=self.replica_id)

    def mark_frame(self) -> None:
        self._last_frame_wall = _time.time()

    def on_width(self, width: int) -> None:
        """Rescale adaptation (port-scheme source sets only): subscribe
        to new workers, drop sources beyond the new width."""
        if not self._port_scheme or width < 1:
            return
        added: list[_SourceSub] = []
        dropped: list[_SourceSub] = []
        with self._lock:
            for sid in list(self._subs):
                if sid >= width:
                    dropped.append(self._subs.pop(sid))
            for sid in range(width):
                if sid not in self._subs:
                    sub = _SourceSub(
                        self,
                        sid,
                        self._scheme_host,
                        _stream.stream_port(sid),
                    )
                    self._subs[sid] = sub
                    added.append(sub)
        for sub in dropped:
            sub.stop()
            self.store.drop_source(sub.source_id)
        for sub in added:
            sub.start()
        if added or dropped:
            _metrics.FLIGHT.record(
                "replica_rescale",
                replica=self.replica_id,
                width=width,
            )

    def wait_ready(self, timeout: float = 10.0) -> bool:
        """Block until a full consistent cut exists (bench/test helper)."""
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            try:
                cut = self.store.acquire_latest()
            except StaleReadError:
                cut = None
            if cut is not None:
                cut.release()
                return True
            _time.sleep(0.05)
        return False


def _collect_replica():
    with _ACTIVE_LOCK:
        replicas = list(_ACTIVE)
    for rep in replicas:
        lag = rep.store.lag_s()
        labels = {"replica": str(rep.replica_id)}
        if lag is not None:
            yield (
                "pathway_serving_replica_lag_seconds",
                "gauge",
                "age of this replica's freshest consistent cut",
                labels,
                float(lag),
            )
        yield (
            "pathway_serving_replica_sources",
            "gauge",
            "worker snapshot streams this replica subscribes to",
            labels,
            float(len(rep.store.source_ids())),
        )


_metrics.REGISTRY.register_collector(_collect_replica)


def main(argv: Iterable[str] | None = None) -> int:
    """``pathway replica`` entry point: run one replica until killed."""
    import argparse
    import json as _json
    import signal

    parser = argparse.ArgumentParser(
        prog="pathway replica",
        description="read-only serving replica over the snapshot stream",
    )
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--replica-id", type=int, default=0)
    parser.add_argument(
        "--sources",
        default=os.environ.get("PATHWAY_TPU_REPLICA_SOURCES", ""),
        help="host:port list of worker stream endpoints "
        "(default: derive from --width and the stream port scheme)",
    )
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument(
        "--max-staleness-s", type=float, default=None,
        help="override PATHWAY_TPU_REPLICA_MAX_STALENESS_S",
    )
    args = parser.parse_args(list(argv) if argv is not None else None)

    sources = parse_sources(args.sources) if args.sources else None
    rep = Replica(
        sources=sources,
        port=args.port,
        replica_id=args.replica_id,
        max_staleness=args.max_staleness_s,
        width=args.width,
        host=args.host,
    ).start()
    print(
        _json.dumps(
            {
                "event": "replica-ready",
                "replica_id": rep.replica_id,
                "port": rep.port,
                "sources": rep.store.source_ids(),
            }
        ),
        flush=True,
    )
    stop = threading.Event()

    def _on_signal(_signum, _frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    try:
        while not stop.wait(0.5):
            pass
    finally:
        rep.stop()
    return 0
