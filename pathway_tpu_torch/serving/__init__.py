"""Snapshot read plane: serve queries off-dataflow from per-commit views.

Counterpart of ``pathway_tpu/serving/__init__.py``. Opt-in via
``PATHWAY_TPU_SERVING=1``: every runner (one worker, ``threads=N``, and each process of
a TCP mesh, leader and followers) then publishes an immutable
:class:`~pathway_tpu_torch.serving.snapshot.ReadSnapshot` of groupby, join and KNN
operator state into the process-wide :data:`STORE` at each commit boundary, after
``device_pipeline.drain_until`` (so a view sits on the exactly-once seam), and
``pw.run`` starts a :class:`~pathway_tpu_torch.serving.server.QueryServer` on
``21000 + PATHWAY_PROCESS_ID``.

The read tier scales past the worker processes themselves:

- each worker also streams its published snapshots to read-only **replicas**
  (:mod:`pathway_tpu_torch.serving.stream` publisher on ``22000 + pid``,
  :mod:`pathway_tpu_torch.serving.replica` consumers on ``24000 + replica_id``);
- the leader can front the whole mesh with one **federation** endpoint
  (:mod:`pathway_tpu_torch.serving.federation` on ``23000``) that scatters, merges and
  round-robins across replicas;
- all of them answer through the commit-stamped
  :mod:`result cache <pathway_tpu_torch.serving.result_cache>`.

A bind failure raises: :func:`start_server` lets the ``OSError`` of the query server,
the stream publisher or the federation front reach the caller's thread (``pw.run``),
after stopping what it had started, as ``io/http.py``'s ``PathwayWebserver.start``
does. The reference records ``serving_bind_failed`` (or ``snapstream_bind_failed``,
``federation_bind_failed``) and runs on with no server, so a run with serving on would
answer nothing (ROADMAP: deliberate differences).

Env knobs:

- ``PATHWAY_TPU_SERVING`` — enable the plane (default off)
- ``PATHWAY_TPU_SNAPSHOT_DEPTH`` — retained snapshots (default 3)
- ``PATHWAY_TPU_SERVING_PORT_BASE`` — port base (default 21000)
- ``PATHWAY_TPU_SERVING_QUEUE`` — admission queue bound (default 256)
- ``PATHWAY_TPU_SERVING_THREADS`` — worker pool size (default 8)
- ``PATHWAY_TPU_SERVING_BATCH_WINDOW_MS`` — KNN micro-batch packing
  window (default 2 ms)
- ``PATHWAY_TPU_SERVING_STREAM_PORT_BASE`` — snapshot-stream base
  (default 22000)
- ``PATHWAY_TPU_SERVING_FEDERATION`` / ``PATHWAY_TPU_FEDERATION_PORT``
  — leader federation front (default off / 23000)
- ``PATHWAY_TPU_REPLICAS`` / ``PATHWAY_TPU_REPLICA_PORT_BASE`` /
  ``PATHWAY_TPU_REPLICA_MAX_STALENESS_S`` — replica pool for the front
  (count or host:port list), replica port base (24000), staleness
  bound (5 s, live)
- ``PATHWAY_TPU_RESULT_CACHE`` / ``PATHWAY_TPU_RESULT_CACHE_BYTES`` —
  result cache toggle (on) and byte budget (64 MiB), both live
"""

from __future__ import annotations

import os
import threading
from typing import Any

from pathway_tpu_torch.serving.snapshot import (
    STORE,
    ReadSnapshot,
    SnapshotStore,
    StaleReadError,
)

__all__ = [
    "STORE",
    "ReadSnapshot",
    "SnapshotStore",
    "StaleReadError",
    "enabled",
    "publish_on_commit",
    "start_server",
    "stop_server",
    "query_server",
    "stream_server",
    "federation_front",
    "set_stream_epoch",
    "stream_truncate",
]

_lock = threading.Lock()
_server: Any = None
_stream: Any = None
_front: Any = None


def enabled() -> bool:
    return os.environ.get("PATHWAY_TPU_SERVING", "").lower() in (
        "1",
        "true",
        "yes",
    )


def publish_on_commit(scopes: list, time: int) -> None:
    """Runner-side publication hook (call only when :func:`enabled`,
    after the device pipeline drained through ``time``).  Also fans the
    fresh snapshot out to any subscribed replicas — a pin + enqueue per
    subscriber, serialization happens on their sender threads."""
    snap = STORE.publish(scopes, time)
    stream = _stream
    if stream is not None:
        stream.publish(snap)


def start_server() -> Any:
    """Start (or return) this process's query server, the snapshot
    stream publisher for replicas, and — on the leader, when
    ``PATHWAY_TPU_SERVING_FEDERATION=1`` — the federation front. A bind
    failure raises its ``OSError`` here, with nothing left listening."""
    global _server, _stream, _front
    with _lock:
        if _server is not None:
            return _server
        from pathway_tpu_torch.serving import federation as _federation
        from pathway_tpu_torch.serving.server import QueryServer
        from pathway_tpu_torch.serving.stream import SnapshotStreamServer

        started: list = []
        try:
            server = QueryServer().start()
            started.append(server)
            stream = SnapshotStreamServer().start()
            started.append(stream)
            front = None
            process_id = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
            if process_id == 0 and _federation.enabled():
                front = _federation.FederationFront().start()
        except BaseException:
            for part in reversed(started):
                part.stop()
            raise
        _server, _stream, _front = server, stream, front
        return _server


def stop_server() -> None:
    global _server, _stream, _front
    with _lock:
        srv, _server = _server, None
        stream, _stream = _stream, None
        front, _front = _front, None
    if front is not None:
        front.stop()
    if stream is not None:
        stream.stop()
    if srv is not None:
        srv.stop()


def query_server() -> Any:
    """The live :class:`QueryServer` or None.  (Named to avoid the
    package attribute ``serving.server`` — the submodule — which Python
    binds on first import.)"""
    return _server


def stream_server() -> Any:
    """The live :class:`SnapshotStreamServer` or None."""
    return _stream


def federation_front() -> Any:
    """The live :class:`FederationFront` or None (leader only)."""
    return _front


def set_stream_epoch(epoch: int) -> None:
    """Mesh resync hook: raise the snapshot stream's epoch floor so
    frames from a pre-resync publisher are fenced at the replicas."""
    stream = _stream
    if stream is not None:
        stream.set_epoch(epoch)


def stream_truncate(to_time: int) -> None:
    """Mesh rollback hook: fan the truncation out to replicas as an
    epoch-fenced ``snap-rollback`` command (the local store's own
    truncation — and the result cache's — ride the truncate hooks)."""
    stream = _stream
    if stream is not None:
        stream.on_truncate(to_time)
