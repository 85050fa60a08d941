"""Worker-side publisher of the commit-stamped ReadSnapshot stream.

Counterpart of ``pathway_tpu/serving/stream.py``: the same port scheme, frames
(``SNAP_STREAM_KINDS``), drop-oldest subscribers and ``snap-stats`` piggyback. A
snapshot whose KNN view lives on the card is fetched whole to the host by its
``payload()`` on the subscriber's sender thread (its whole capacity, ~1.6 GB at 2^20
slots x 384 f32), never on the commit path.

Each worker process that has serving enabled also listens on
``22000 + PATHWAY_PROCESS_ID`` (``PATHWAY_TPU_SERVING_STREAM_PORT_BASE``
overrides the base) for read-only replicas
(:mod:`pathway_tpu_torch.serving.replica`).  A replica subscribes with a
``snap-sub`` frame and from then on receives every published
:class:`~pathway_tpu_torch.serving.snapshot.ReadSnapshot` as an epoch-stamped
``snap`` frame, plus ``snap-rollback`` commands when mesh recovery
truncates the store.  The wire format and frame kinds live in
:mod:`pathway_tpu_torch.engine.distributed` (same length-prefix + HMAC +
pickle contract as exchange frames; see ``SNAP_STREAM_KINDS``).

Ingest isolation: the publish hook only *pins* the snapshot and hands it
to per-subscriber sender threads — serialization (``payload()`` +
pickle) happens off the commit path, so attaching replicas costs the
ingest loop an enqueue, not a pickle.  Slow subscribers get drop-oldest
semantics: a replica that cannot keep up skips intermediate snapshots
and converges on the newest (bounded staleness, never backpressure on
ingest).

Replicas piggyback their own metrics-registry snapshots upstream as
``snap-stats`` frames; the leader's ``/metrics`` exposition renders them
under ``worker="r<replica-id>"`` labels and prunes them — along with the
timeseries ring's matching label sets — the moment the replica
disconnects (the same lifecycle mesh workers get from
``prune_mesh_metrics``).
"""

from __future__ import annotations

import os
import queue
import socket
import threading

from pathway_tpu_torch.internals import metrics as _metrics
from pathway_tpu_torch.internals import timeseries as _timeseries
from pathway_tpu_torch.serving import snapshot as _snapshot

__all__ = ["SnapshotStreamServer", "BASE_PORT", "stream_port"]

BASE_PORT = 22000

_FRAMES = {
    kind: _metrics.REGISTRY.counter(
        "pathway_serving_stream_frames_total",
        "snapshot-stream frames sent by this worker, by kind",
        kind=kind,
    )
    for kind in ("snap", "snap-hello", "snap-rollback")
}
_DROPPED = _metrics.REGISTRY.counter(
    "pathway_serving_stream_dropped_total",
    "snapshots skipped for slow subscribers (drop-oldest, newest wins)",
)


def stream_port(process_id: int | None = None) -> int:
    base = int(
        os.environ.get("PATHWAY_TPU_SERVING_STREAM_PORT_BASE", BASE_PORT)
    )
    if process_id is None:
        process_id = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
    return base + process_id


class _Subscriber:
    """One replica connection: a bounded drop-oldest queue drained by a
    dedicated sender thread, so a stalled replica never blocks publish
    or any other subscriber."""

    def __init__(self, sock: socket.socket, replica_id: int, secret: bytes):
        self.sock = sock
        self.replica_id = replica_id
        self._secret = secret
        self._queue: queue.Queue = queue.Queue(maxsize=4)
        self._stop = False
        self._thread = threading.Thread(
            target=self._sender, name=f"pw-snapstream-r{replica_id}",
            daemon=True,
        )

    def start(self) -> None:
        self._thread.start()

    def send(self, frame: tuple) -> None:
        from pathway_tpu_torch.engine.distributed import send_stream_frame

        send_stream_frame(self.sock, frame, self._secret)

    def enqueue(self, item: tuple) -> None:
        while True:
            try:
                self._queue.put_nowait(item)
                return
            except queue.Full:
                try:
                    old = self._queue.get_nowait()
                except queue.Empty:
                    continue
                if old[0] == "publish":
                    old[1].release()
                    _DROPPED.inc()

    def stop(self) -> None:
        self._stop = True
        try:
            self.sock.close()
        except OSError:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)
        # unpin anything still queued
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item[0] == "publish":
                item[1].release()

    def _sender(self) -> None:
        while not self._stop:
            try:
                item = self._queue.get(timeout=0.25)
            except queue.Empty:
                continue
            try:
                if item[0] == "publish":
                    snap, epoch = item[1], item[2]
                    try:
                        payload = snap.payload()
                    finally:
                        snap.release()
                    self.send(("snap", epoch, payload["seq"], payload))
                    _FRAMES["snap"].inc()
                elif item[0] == "trunc":
                    to_time, epoch, pid = item[1], item[2], item[3]
                    self.send(("snap-rollback", epoch, to_time, pid))
                    _FRAMES["snap-rollback"].inc()
            except (OSError, RuntimeError):
                # socket died or the snapshot was reclaimed: the reader
                # side observes the close and runs the cleanup
                return


class SnapshotStreamServer:
    """Accepts replica subscriptions and fans published snapshots out."""

    def __init__(
        self,
        store: "_snapshot.SnapshotStore" | None = None,
        port: int | None = None,
        process_id: int | None = None,
    ) -> None:
        from pathway_tpu_torch.engine.distributed import _mesh_secret

        self.store = store if store is not None else _snapshot.STORE
        self.port = port if port is not None else stream_port(process_id)
        self.process_id = (
            process_id
            if process_id is not None
            else int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
        )
        self._secret = _mesh_secret()
        self._lock = threading.Lock()
        self._subs: list[_Subscriber] = []  # guarded-by: self._lock
        self._replica_metrics: dict[int, dict] = {}  # guarded-by: self._lock
        self._epoch = 0  # guarded-by: self._lock
        self._stop = False
        self._listener: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "SnapshotStreamServer":
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("127.0.0.1", self.port))
        listener.listen(16)
        listener.settimeout(0.5)
        self._listener = listener
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="pw-snapstream-accept", daemon=True
        )
        self._accept_thread.start()
        _metrics.FLIGHT.record("snapstream_start", port=self.port)
        return self

    def stop(self) -> None:
        self._stop = True
        listener = self._listener
        if listener is not None:
            try:
                listener.close()
            except OSError:
                pass
        with self._lock:
            subs, self._subs = list(self._subs), []
            self._replica_metrics = {}
        for sub in subs:
            sub.stop()
        thread = self._accept_thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=2.0)
        _metrics.FLIGHT.record("snapstream_stop", port=self.port)

    # -- epoch + publication -------------------------------------------------

    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def set_epoch(self, epoch: int) -> None:
        with self._lock:
            self._epoch = max(self._epoch, int(epoch))

    def publish(self, snap: "_snapshot.ReadSnapshot") -> None:
        """Hand a freshly-published snapshot to every subscriber.  Cost
        on the commit path: one pin + one enqueue per subscriber; the
        sender threads do the serialization."""
        with self._lock:
            subs = list(self._subs)
            epoch = self._epoch
        for sub in subs:
            if snap.acquire():
                sub.enqueue(("publish", snap, epoch))

    def on_truncate(self, to_time: int) -> None:
        """Fan a store truncation out as an epoch-fenced command.  Each
        truncation incident bumps the stream epoch so the replica-side
        fence admits it exactly once (a zombie publisher's re-send of an
        older incident is rejected)."""
        with self._lock:
            self._epoch += 1
            epoch = self._epoch
            subs = list(self._subs)
        for sub in subs:
            sub.enqueue(("trunc", int(to_time), epoch, self.process_id))

    # -- replica-side observability ------------------------------------------

    def replica_metrics_snapshot(self) -> dict[int, dict]:
        with self._lock:
            return dict(self._replica_metrics)

    def subscriber_count(self) -> int:
        with self._lock:
            return len(self._subs)

    # -- connection handling -------------------------------------------------

    def _accept_loop(self) -> None:
        listener = self._listener
        while not self._stop and listener is not None:
            try:
                sock, _addr = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn,
                args=(sock,),
                name="pw-snapstream-conn",
                daemon=True,
            ).start()

    def _serve_conn(self, sock: socket.socket) -> None:
        from pathway_tpu_torch.engine.distributed import recv_stream_frame

        sub: _Subscriber | None = None
        try:
            sock.settimeout(30.0)
            frame = recv_stream_frame(sock, self._secret)
            kind, epoch, _from_seq, replica_id = frame
            if kind != "snap-sub":
                sock.close()
                return
            sub = _Subscriber(sock, int(replica_id), self._secret)
            with self._lock:
                self._subs.append(sub)
                my_epoch = self._epoch
            sub.start()
            width = int(os.environ.get("PATHWAY_PROCESSES", "1"))
            sub.send(("snap-hello", my_epoch, width, self.process_id))
            _FRAMES["snap-hello"].inc()
            _metrics.FLIGHT.record(
                "snapstream_subscribe",
                replica=int(replica_id),
                port=self.port,
            )
            # late joiner catch-up: the newest live snapshot, if any
            snap = self.store.acquire_latest()
            if snap is not None:
                sub.enqueue(("publish", snap, my_epoch))
            # reader side: replica stats piggyback + disconnect detection
            sock.settimeout(1.0)
            while not self._stop:
                try:
                    stats = recv_stream_frame(sock, self._secret)
                except socket.timeout:
                    continue
                kind2, _epoch2, rid2, payload = stats
                if kind2 == "snap-stats" and isinstance(payload, dict):
                    with self._lock:
                        self._replica_metrics[int(rid2)] = payload
        except (ConnectionError, OSError, EOFError, ValueError):
            pass
        finally:
            if sub is not None:
                self._drop_subscriber(sub)
            else:
                try:
                    sock.close()
                except OSError:
                    pass

    def _drop_subscriber(self, sub: _Subscriber) -> None:
        """Replica disconnect: deregister, then prune its ``worker=``
        label sets from the aggregated exposition and the timeseries
        ring — the replica twin of ``prune_mesh_metrics``."""
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)
            had_metrics = self._replica_metrics.pop(sub.replica_id, None)
        sub.stop()
        if had_metrics is not None:
            _timeseries.STORE.prune_workers(
                dead=(f"r{sub.replica_id}",)
            )
        _metrics.FLIGHT.record(
            "snapstream_unsubscribe", replica=sub.replica_id
        )
