"""Workers in several processes: a TCP exchange mesh between worker processes.

Counterpart of ``pathway_tpu/engine/distributed.py``. Every process runs the same
program and builds the same graph; total workers = processes x threads, and worker
``w`` lives on process ``w // threads``. Rows are partitioned by the same rules as the
in-process exchange (``engine/sharded.py::partition_rule``, ``engine/routing.py``), so
a row lands on the same worker whichever transport carries it.

- Process 0 is the coordinator: it owns the connector drivers (inputs are read on one
  worker and re-sharded) and every sink, and it drives commits by broadcasting
  control frames.
- A commit settles in synchronous exchange rounds: each round every process drains
  its local operators to quiescence, then swaps one frame with every peer carrying
  (busy bit, deliveries). The commit is done after a round in which no process was
  busy and nothing was exchanged: nothing can then be in flight.
- Frames are length-prefixed pickles authenticated by HMAC-SHA256
  (``PATHWAY_EXCHANGE_SECRET``); per-peer receive threads drain the sockets
  continuously, so bulk sends cannot deadlock the mesh. Columnar batches of clean
  dtypes travel as PWCF frames (:func:`encode_columns_frame`), byte for byte the JAX
  package's; object columns (embeddings, Json, tuples) travel as pickled row entries.

Not ported here: the device collective that the JAX package tries before the host
gather when every destination worker is in this process (ROADMAP queue 1 item 14,
slice c; ``EXCHANGE_STATS["collective_deliveries"]`` stays 0), and the serving tier's
hooks in :meth:`DistributedScheduler.resync` and :meth:`DistributedScheduler.rollback`
(the snapshot stream's epoch and the read store's truncation, ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import hashlib
import hmac
import os
import pickle
import queue
import socket
import struct
import threading
import time as _walltime
import warnings
from typing import Any, Sequence

import numpy as np

from pathway_tpu_torch.engine.batch import Columns, DeltaBatch, columnarize_entries
from pathway_tpu_torch.engine.device import VECTOR_THRESHOLD
from pathway_tpu_torch.engine.graph import (
    ErrorLogNode,
    InputSession,
    Node,
    Scope,
    StaticSource,
    SubscribeNode,
)
from pathway_tpu_torch.engine.routing import (
    columnar_shards,
    entry_shards,
    shards_of_values,
)
from pathway_tpu_torch.engine.sharded import (
    _assert_colocated,
    _verify_elision,
    partition_rule,
    partitioner,
)
from pathway_tpu_torch.engine.value import Pointer

_LEN = struct.Struct(">Q")
_MAC_LEN = hashlib.sha256().digest_size
#: refuse frames beyond this size BEFORE allocating — an unauthenticated
#: sender must not be able to drive unbounded buffering via the length
#: prefix (the MAC also covers the length, so a tampered prefix fails)
_MAX_FRAME = int(
    os.environ.get("PATHWAY_EXCHANGE_MAX_FRAME", str(1 << 31))
)


def _mesh_secret() -> bytes:
    """Shared frame-authentication key for the exchange mesh.

    Frames are pickles, so an unauthenticated peer that can reach an
    exchange port could otherwise execute arbitrary code. Every frame
    carries an HMAC-SHA256 over its payload; frames that fail
    verification tear the connection down before ``pickle.loads`` ever
    sees the bytes. ``pathway spawn`` generates a fresh secret per run
    (cli.py); multi-host deployments must set PATHWAY_EXCHANGE_SECRET to
    the same value on every host."""
    secret = os.environ.get("PATHWAY_EXCHANGE_SECRET") or os.environ.get(
        "PATHWAY_RUN_ID"
    )
    return secret.encode() if secret else b""

def _validated_float(name: str, default: float, minimum: float) -> float:
    """Parse a float env knob with a clear startup error for nonsense."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        value = float(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not a number (expected seconds, e.g. "
            f"{name}={default:g})"
        ) from None
    if not value >= minimum or value != value or value == float("inf"):
        raise ValueError(
            f"{name}={raw!r} out of range: must be a finite number "
            f">= {minimum:g} seconds"
        )
    return value


def _validated_int(name: str, default: int, minimum: int) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not an integer (e.g. {name}={default})"
        ) from None
    if value < minimum:
        raise ValueError(
            f"{name}={raw!r} out of range: must be >= {minimum}"
        )
    return value


#: how long a process waits for a peer frame before declaring the run
#: dead. ``PATHWAY_TPU_MESH_TIMEOUT`` is the canonical knob; the legacy
#: ``PATHWAY_EXCHANGE_TIMEOUT`` spelling is honoured as a fallback.
RECV_TIMEOUT = _validated_float(
    "PATHWAY_TPU_MESH_TIMEOUT",
    _validated_float("PATHWAY_EXCHANGE_TIMEOUT", 600.0, 0.001),
    0.001,
)
#: a peer silent this long while the mesh is otherwise alive is declared
#: hung (same recovery path as a dead socket); derived from the mesh
#: timeout unless pinned explicitly
SUSPICION_TIMEOUT = _validated_float(
    "PATHWAY_TPU_MESH_SUSPICION", RECV_TIMEOUT, 0.001
)
#: per-peer receive-queue high-water mark — a flooding or stalled peer
#: blocks (TCP backpressure) instead of growing leader memory unboundedly
QUEUE_HWM = _validated_int("PATHWAY_TPU_MESH_QUEUE_HWM", 512, 1)
_CONNECT_DEADLINE = 60.0


class MeshConfigWarning(UserWarning):
    """Structured warning for contradictory mesh knob combinations, in the
    analyzer's PW-code style (``PWF`` = pathway fault-tolerance)."""

    def __init__(self, code: str, message: str) -> None:
        super().__init__(f"{code}: {message}")
        self.code = code


def retry_backoff_ceiling_s(retries: int) -> float:
    """Worst-case wall time the bounded send-retry path can spend before
    giving up: per attempt, the jittered backoff sleep (delay starts at
    50ms, doubles, caps at 1s, jitter factor <= 1.5) plus the 2s
    ``_repair_link`` dial deadline."""
    total = 0.0
    delay = 0.05
    for _ in range(max(0, retries)):
        total += delay * 1.5 + 2.0
        delay = min(delay * 2, 1.0)
    return total


_KNOBS_VALIDATED = False


def validate_mesh_knobs(*, _force: bool = False) -> list[MeshConfigWarning]:
    """Cross-check independently tuned mesh knobs at startup (once per
    process; tests pass ``_force=True`` after monkeypatching the env).

    PWF001: the send-retry backoff ceiling must stay below the suspicion
    timeout — otherwise a sender can still be inside its retry loop when
    the peer declares *it* hung, turning one transient link glitch into a
    mutual-suspicion recovery storm.  Recomputed from the environment (not
    the module constants) so tests can exercise contradictory settings
    without reloading the module."""
    global _KNOBS_VALIDATED
    if _KNOBS_VALIDATED and not _force:
        return []
    _KNOBS_VALIDATED = True
    recv_timeout = _validated_float(
        "PATHWAY_TPU_MESH_TIMEOUT",
        _validated_float("PATHWAY_EXCHANGE_TIMEOUT", 600.0, 0.001),
        0.001,
    )
    suspicion = _validated_float(
        "PATHWAY_TPU_MESH_SUSPICION", recv_timeout, 0.001
    )
    retries = _validated_int("PATHWAY_TPU_MESH_SEND_RETRIES", 2, 0)
    found: list[MeshConfigWarning] = []
    ceiling = retry_backoff_ceiling_s(retries)
    if ceiling >= suspicion:
        found.append(
            MeshConfigWarning(
                "PWF001",
                f"mesh send-retry backoff ceiling ({ceiling:.2f}s for "
                f"PATHWAY_TPU_MESH_SEND_RETRIES={retries}) is not below "
                f"the suspicion timeout (PATHWAY_TPU_MESH_SUSPICION="
                f"{suspicion:g}s) — a retrying sender can be declared "
                f"hung mid-retry; raise the suspicion timeout or lower "
                f"the retry count",
            )
        )
    for w in found:
        warnings.warn(w, stacklevel=2)
    return found


def elect_leader(survivors: set[int] | list[int]) -> int:
    """Deterministic leader election: the lowest-rank live worker wins.
    Every survivor computes the same answer locally from the same
    membership view, so no voting round is needed — the epoch stamp on
    the election command is what serialises concurrent views."""
    if not survivors:
        raise ValueError("cannot elect a leader from an empty mesh")
    return min(survivors)


class EpochFence:
    """Per-command-kind epoch fencing.

    Recovery-control frames (``recover``, ``rollback``, ``elect``, …)
    carry the mesh epoch that issued them.  A frame whose epoch is not
    newer than the last one *processed* for that kind is stale — either a
    zombie ex-leader flushing its socket buffer after being fenced out,
    or a fault-injected duplicate of a command we already executed — and
    must be ignored rather than re-executed (re-running a rollback would
    deadlock the resync barrier).  Startup commands are stamped epoch 0
    and pass against the initial floor of -1."""

    def __init__(self) -> None:
        self._last: dict[str, int] = {}

    def admit(self, kind: str, epoch: int) -> bool:
        """True (and advances the fence) when the frame is fresh."""
        if epoch <= self._last.get(kind, -1):
            _metrics.REGISTRY.counter(
                "pathway_mesh_fenced_frames_total",
                "stale epoch-stamped control frames rejected by fencing",
            ).inc(1)
            _metrics.FLIGHT.record(
                "fenced_frame", frame_kind=kind, epoch=epoch,
                fence=self._last.get(kind, -1),
            )
            return False
        self._last[kind] = epoch
        return True

    def floor(self, kind: str) -> int:
        return self._last.get(kind, -1)


# -- snapshot-stream wire protocol (read tier) -----------------------------
#
# The serving read tier (its replicas come with ROADMAP queue 1 item 8)
# ships commit-stamped ReadSnapshot payloads from each worker to read-
# only replica processes over the SAME wire format as exchange frames:
# length prefix, HMAC-SHA256 over (length || payload), pickled body.
# Frame kinds (all fixed 4-tuples, epoch-stamped for fencing):
#
# - ``("snap-sub",      epoch, from_seq,  replica_id)`` replica -> worker
# - ``("snap-hello",    epoch, width,     process_id)`` worker  -> replica
# - ``("snap",          epoch, seq,       payload)``    worker  -> replica
# - ``("snap-rollback", epoch, to_time,   process_id)`` worker  -> replica
# - ``("snap-stats",    epoch, replica_id, snapshot)``  replica -> worker
#
# Replicas run an :class:`EpochFence` over the stream: ``snap`` frames
# from an epoch below the fence floor are a zombie publisher's and are
# dropped; ``snap-rollback`` is a control command admitted exactly once
# per epoch (re-running a truncate is harmless, but the fence keeps the
# duplicate/zombie semantics identical to the mesh control plane).

#: snapshot-stream frame kinds (subset of the mesh frame namespace)
SNAP_STREAM_KINDS = (
    "snap-sub",
    "snap-hello",
    "snap",
    "snap-rollback",
    "snap-stats",
)


def send_stream_frame(
    sock: socket.socket, frame: Any, secret: bytes | None = None
) -> None:
    """Authenticated frame write for the snapshot stream (same wire
    format as :meth:`MeshTransport._send`, usable without a mesh)."""
    if secret is None:
        secret = _mesh_secret()
    payload = pickle.dumps(frame, protocol=pickle.HIGHEST_PROTOCOL)
    len_bytes = _LEN.pack(len(payload))
    mac = hmac.new(secret, len_bytes + payload, hashlib.sha256).digest()
    sock.sendall(len_bytes + mac + payload)


def recv_stream_frame(
    sock: socket.socket, secret: bytes | None = None
) -> Any:
    """Authenticated frame read for the snapshot stream.  Verifies the
    HMAC BEFORE deserializing — a forged frame must never reach
    ``pickle.loads`` (same contract as :meth:`MeshTransport._read_frame`)."""
    if secret is None:
        secret = _mesh_secret()

    def read_exact(n: int) -> bytes:
        chunks = []
        while n:
            chunk = sock.recv(min(n, 1 << 20))
            if not chunk:
                raise ConnectionError("stream peer closed")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    len_bytes = read_exact(_LEN.size)
    (length,) = _LEN.unpack(len_bytes)
    if length > _MAX_FRAME:
        raise ConnectionError(
            f"snapshot-stream frame of {length} bytes exceeds "
            f"PATHWAY_EXCHANGE_MAX_FRAME={_MAX_FRAME}"
        )
    mac = read_exact(_MAC_LEN)
    payload = read_exact(length)
    expected = hmac.new(
        secret, len_bytes + payload, hashlib.sha256
    ).digest()
    if not hmac.compare_digest(mac, expected):
        raise ConnectionError(
            "snapshot-stream frame failed HMAC authentication "
            "(PATHWAY_EXCHANGE_SECRET mismatch or foreign traffic)"
        )
    return pickle.loads(payload)


class PeerLostError(RuntimeError):
    """A peer's socket died, its frames timed out, or it announced an
    abort mid-round.  Recoverable when a MeshSupervisor + operator
    snapshots are configured; fail-stop otherwise."""

    def __init__(self, message: str, peer: int | None = None) -> None:
        super().__init__(message)
        self.peer = peer


# ---------------------------------------------------------------------------
# Columnar wire frames
# ---------------------------------------------------------------------------

#: kill-switch (and the bench's row-pickle baseline): "0" forces every
#: exchange back onto pickled row entries
COLUMNAR_EXCHANGE = os.environ.get(
    "PATHWAY_EXCHANGE_COLUMNAR", "1"
).lower() not in ("0", "false")

#: probe counters for tests/benchmarks: columnar frames this process
#: encoded for / decoded from remote peers, row-entry deliveries that took
#: the pickle fallback, and optimizer-elided exchanges.  The dict now
#: lives in engine/routing.py (shared with the in-process scheduler); the
#: import below keeps every historical access path
#: (``distributed.EXCHANGE_STATS``) pointing at the same object.
from pathway_tpu_torch.engine.routing import EXCHANGE_STATS  # noqa: E402
from pathway_tpu_torch.internals import metrics as _metrics  # noqa: E402
from pathway_tpu_torch.internals import profiling as _profiling  # noqa: E402
from pathway_tpu_torch.internals import timeseries as _timeseries  # noqa: E402
from pathway_tpu_torch.internals import tracing as _tracing  # noqa: E402

_FRAME_MAGIC = b"PWCF"
_FRAME_VERSION = 1
_U8 = struct.Struct("<B")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


def _frame_encodable(columns: Columns) -> bool:
    """True when every data column is a fixed-width clean dtype whose raw
    C-order buffer round-trips (bool/int/uint/float/unicode/datetime).
    Object columns (mixed types, tuples, Json) take the pickled-entry
    fallback instead."""
    return all(c.dtype.kind not in "OV" for c in columns.cols)


def encode_columns_frame(columns: Columns) -> bytes | None:
    """Dtype-tagged columnar frame — the wire form of a ``Columns``
    payload; no row is ever materialised or pickled.

    Layout (integers little-endian; every variable block length-prefixed):

        magic b"PWCF" | version u8 | flags u8 | n_rows u32 | n_cols u32
        key block: n_rows x 16 raw little-endian key bytes
        diff block (flags & 1): n_rows x int64
        per column: u8 tag length + ascii numpy ``dtype.str`` tag,
                    u64 buffer length + raw C-order column buffer

    Returns ``None`` when the payload cannot be represented (object-dtype
    column, key derivation failure) — callers fall back to row entries.
    The transport length-prefixes and HMACs the enclosing mesh frame, so
    this buffer needs no own authentication.
    """
    if not _frame_encodable(columns):
        return None
    trace = _tracing.current()
    if trace is not None:
        t0 = _walltime.perf_counter()
        frame = _encode_columns_frame(columns)
        trace.span(
            "pwcf-encode",
            "exchange",
            t0,
            _walltime.perf_counter(),
            rows=columns.n,
            cols=len(columns.cols),
            bytes=0 if frame is None else len(frame),
        )
        return frame
    return _encode_columns_frame(columns)


def _encode_columns_frame(columns: Columns) -> bytes | None:
    try:
        kb = np.ascontiguousarray(columns.kbytes(), np.uint8)
    except Exception:  # lazy key thunk failed: row path derives the keys
        return None
    diffs = columns.diffs
    parts = [
        _FRAME_MAGIC,
        _U8.pack(_FRAME_VERSION),
        _U8.pack(1 if diffs is not None else 0),
        _U32.pack(columns.n),
        _U32.pack(len(columns.cols)),
        kb.tobytes(),
    ]
    if diffs is not None:
        parts.append(np.ascontiguousarray(diffs, np.int64).tobytes())
    for col in columns.cols:
        tag = col.dtype.str.encode("ascii")
        buf = np.ascontiguousarray(col).tobytes()
        parts.append(_U8.pack(len(tag)))
        parts.append(tag)
        parts.append(_U64.pack(len(buf)))
        parts.append(buf)
    return b"".join(parts)


def decode_columns_frame(frame: bytes) -> Columns:
    """Inverse of :func:`encode_columns_frame`; arrays are zero-copy views
    into the frame buffer (batch payloads are immutable downstream)."""
    if frame[:4] != _FRAME_MAGIC:
        raise ValueError("bad columnar frame magic")
    version = frame[4]
    if version != _FRAME_VERSION:
        raise ValueError(f"unsupported columnar frame version {version}")
    flags = frame[5]
    (n,) = _U32.unpack_from(frame, 6)
    (ncols,) = _U32.unpack_from(frame, 10)
    pos = 14
    kb = np.frombuffer(frame, np.uint8, n * 16, pos).reshape(n, 16)
    pos += n * 16
    diffs = None
    if flags & 1:
        diffs = np.frombuffer(frame, np.int64, n, pos)
        pos += n * 8
    cols = []
    for _ in range(ncols):
        tlen = frame[pos]
        pos += 1
        dt = np.dtype(frame[pos : pos + tlen].decode("ascii"))
        pos += tlen
        (blen,) = _U64.unpack_from(frame, pos)
        pos += 8
        cols.append(np.frombuffer(frame, dt, n, pos))
        pos += blen
    return Columns(n, cols, kbytes=kb, diffs=diffs)


def default_addresses(n_processes: int, first_port: int) -> list[tuple[str, int]]:
    """Static address book (127.0.0.1, first_port+i). Multi-host deployments override via
    PATHWAY_PROCESS_ADDRESSES="host1:port1;host2:port2;..."."""
    spec = os.environ.get("PATHWAY_PROCESS_ADDRESSES")
    if spec:
        out = []
        for part in spec.split(";"):
            host, _, port = part.strip().rpartition(":")
            out.append((host, int(port)))
        if len(out) != n_processes:
            raise ValueError(
                f"PATHWAY_PROCESS_ADDRESSES lists {len(out)} hosts for "
                f"{n_processes} processes"
            )
        return out
    return [("127.0.0.1", first_port + i) for i in range(n_processes)]


class MeshTransport:
    """Full TCP mesh; one duplex socket per process pair.

    Process ``i`` accepts connections from peers ``j > i`` and dials peers
    ``j < i``; a HELLO frame identifies the dialer. One receiver thread per
    peer parses frames into a FIFO queue (per-peer streams are totally
    ordered, and the round protocol is globally sequenced per peer, so a
    plain queue is a sufficient demultiplexer)."""

    def __init__(
        self,
        process_id: int,
        n_processes: int,
        first_port: int = 10000,
        addresses: Sequence[tuple[str, int]] | None = None,
    ) -> None:
        self.process_id = process_id
        self.n = n_processes
        addrs = list(addresses or default_addresses(n_processes, first_port))
        self._addrs = addrs
        self._socks: dict[int, socket.socket] = {}
        # bounded per-peer queues: a flooding or stalled peer exerts TCP
        # backpressure at the high-water mark instead of growing this
        # process's memory without limit (frames are NEVER dropped — the
        # round protocol cannot survive a missing frame)
        self._queues: dict[int, queue.Queue] = {
            p: queue.Queue(maxsize=QUEUE_HWM)
            for p in range(n_processes)
            if p != process_id
        }
        self._send_locks: dict[int, threading.Lock] = {}
        self._threads: list[threading.Thread] = []
        self._closed = False
        #: serializes the liveness state below — written by every recv
        #: loop and by the pump thread's suspicion scan
        self._peer_lock = threading.Lock()
        #: peers whose socket closed/errored (set by the recv loops)
        self.dead_peers: set[int] = set()  # guarded-by: self._peer_lock
        #: per-peer monotonic arrival time of the most recent frame
        #: (heartbeats included) — the liveness signal suspicion reads
        # guarded-by: self._peer_lock
        self.last_seen: dict[int, float] = {
            p: _walltime.monotonic()
            for p in range(n_processes)
            if p != process_id
        }
        self._secret = _mesh_secret()
        self._backpressure = _metrics.REGISTRY.gauge(
            "pathway_mesh_recv_backpressure",
            "receiver threads currently blocked on a full peer queue",
        )
        self._fault_plan = None
        if os.environ.get("PATHWAY_TPU_FAULT_PLAN"):
            from pathway_tpu_torch.engine.faults import active_plan

            self._fault_plan = active_plan()
        validate_mesh_knobs()
        if n_processes == 1:
            return
        # bind only the configured interface (127.0.0.1 by default) — not
        # 0.0.0.0 — so single-host meshes are unreachable off-box. NAT'd
        # deployments whose advertised address is not locally bindable
        # (Docker bridge) set PATHWAY_EXCHANGE_BIND (e.g. to 0.0.0.0).
        bind_host = os.environ.get(
            "PATHWAY_EXCHANGE_BIND", addrs[process_id][0]
        )
        self._bind_host = bind_host
        loopback = ("127.0.0.1", "localhost", "::1")
        exposed = bind_host not in loopback or any(
            host not in loopback for host, _port in addrs
        )
        if exposed and not os.environ.get("PATHWAY_EXCHANGE_SECRET"):
            # an off-loopback listener with a missing/guessable key would
            # hand pickle.loads to anyone who can reach the port
            raise RuntimeError(
                "a non-loopback exchange listener requires "
                "PATHWAY_EXCHANGE_SECRET (the same value on every host) "
                "to authenticate peer frames"
            )
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((bind_host, addrs[process_id][1]))
        listener.listen(n_processes)
        listener.settimeout(_CONNECT_DEADLINE)
        try:
            for peer in range(process_id):  # dial lower ids
                self._socks[peer] = self._dial(addrs[peer])
                self._send(peer, ("hello", process_id))
            for _ in range(process_id + 1, n_processes):  # accept higher ids
                conn, _addr = listener.accept()
                conn.settimeout(None)
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                frame = self._read_frame(conn)
                if (
                    not isinstance(frame, tuple)
                    or len(frame) != 2
                    or frame[0] != "hello"
                    or not isinstance(frame[1], int)
                    or not 0 <= frame[1] < n_processes
                ):
                    raise RuntimeError(
                        f"process {process_id}: bad handshake on exchange "
                        f"port: {frame!r}"
                    )
                self._socks[frame[1]] = conn
        finally:
            listener.close()
        for peer, sock in self._socks.items():
            self._start_recv(peer, sock)

    def _start_recv(self, peer: int, sock: socket.socket) -> None:
        self._send_locks[peer] = threading.Lock()
        t = threading.Thread(
            target=self._recv_loop, args=(peer, sock), daemon=True
        )
        t.start()
        self._threads.append(t)

    @staticmethod
    def _dial(addr: tuple[str, int]) -> socket.socket:
        deadline = _walltime.monotonic() + _CONNECT_DEADLINE
        delay = 0.02
        while True:
            try:
                sock = socket.create_connection(addr, timeout=_CONNECT_DEADLINE)
                # the connect timeout must not linger: receiver threads
                # block in recv indefinitely between commits (quiet
                # follower-follower links would otherwise fake-EOF at 60s)
                sock.settimeout(None)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                return sock
            except OSError:
                if _walltime.monotonic() > deadline:
                    raise
                _walltime.sleep(delay)
                delay = min(delay * 2, 0.5)

    @staticmethod
    def _read_exact(sock: socket.socket, n: int) -> bytes:
        chunks = []
        while n:
            chunk = sock.recv(min(n, 1 << 20))
            if not chunk:
                raise ConnectionError("peer closed")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def _read_frame(self, sock: socket.socket) -> Any:
        len_bytes = self._read_exact(sock, _LEN.size)
        (length,) = _LEN.unpack(len_bytes)
        if length > _MAX_FRAME:
            raise ConnectionError(
                f"exchange frame of {length} bytes exceeds "
                f"PATHWAY_EXCHANGE_MAX_FRAME={_MAX_FRAME}"
            )
        mac = self._read_exact(sock, _MAC_LEN)
        payload = self._read_exact(sock, length)
        # authenticate BEFORE deserializing: a forged frame must never
        # reach pickle.loads (an unauthenticated pickle runs arbitrary code)
        expected = hmac.new(
            self._secret, len_bytes + payload, hashlib.sha256
        ).digest()
        if not hmac.compare_digest(mac, expected):
            raise ConnectionError(
                "exchange frame failed HMAC authentication "
                "(PATHWAY_EXCHANGE_SECRET mismatch or foreign traffic)"
            )
        return pickle.loads(payload)

    def _recv_loop(self, peer: int, sock: socket.socket) -> None:
        q = self._queues[peer]
        try:
            while True:
                frame = self._read_frame(sock)
                with self._peer_lock:
                    self.last_seen[peer] = _walltime.monotonic()
                if (
                    isinstance(frame, tuple)
                    and frame
                    and frame[0] == "hb"
                ):
                    # transport-level heartbeat: liveness recorded above,
                    # never surfaced to the round protocol
                    continue
                self._put(q, frame)
        except (ConnectionError, OSError, EOFError, pickle.PickleError):
            # mark BEFORE enqueueing: a coordinator that never recv()s
            # from this peer still observes the death via
            # raise_if_peer_dead() at its next pump tick — send-side
            # detection alone needs TWO sends after the RST (the first
            # one buffers), which stalls fail-stop for idle streams.
            # A loop whose socket was replaced by reestablish() must not
            # poison the fresh link.
            if self._socks.get(peer) is sock and not self._closed:
                with self._peer_lock:
                    self.dead_peers.add(peer)
                self._put(q, ("__eof__", peer))

    def _put(self, q: queue.Queue, frame: Any) -> None:
        """Blocking put with a backpressure gauge: at the high-water mark
        the receiver thread stalls, which stops reading the socket, which
        pushes back on the sender via TCP flow control."""
        try:
            q.put_nowait(frame)
            return
        except queue.Full:
            pass
        self._backpressure.value += 1
        try:
            q.put(frame)
        finally:
            self._backpressure.value -= 1

    def raise_if_peer_dead(self) -> None:
        """Fail-stop promptly when any peer's socket closed (teardown on
        worker loss).  A peer silent
        past the suspicion timeout (hung, not dead) raises the same way —
        its socket is torn down first so the two paths converge."""
        if self._closed:
            return
        if not self.dead_peers:
            now = _walltime.monotonic()
            with self._peer_lock:
                seen_snapshot = dict(self.last_seen)
            for peer, seen in seen_snapshot.items():
                if peer in self._socks and now - seen > SUSPICION_TIMEOUT:
                    # a hung peer holds its socket open: close it so the
                    # recv loop marks it dead like any other lost peer
                    try:
                        self._socks[peer].close()
                    except OSError:
                        pass
                    with self._peer_lock:
                        self.dead_peers.add(peer)
                    raise PeerLostError(
                        f"process {self.process_id}: peer {peer} silent "
                        f"for {now - seen:.1f}s (suspicion timeout "
                        f"{SUSPICION_TIMEOUT:g}s) — suspected hung",
                        peer=peer,
                    )
        if self.dead_peers:
            dead = sorted(self.dead_peers)
            raise PeerLostError(
                f"process {self.process_id}: peer(s) {dead} disconnected",
                peer=dead[0],
            )

    def _send(self, peer: int, frame: Any) -> None:
        payload = pickle.dumps(frame, protocol=pickle.HIGHEST_PROTOCOL)
        lock = self._send_locks.get(peer)
        len_bytes = _LEN.pack(len(payload))
        mac = hmac.new(
            self._secret, len_bytes + payload, hashlib.sha256
        ).digest()
        data = len_bytes + mac + payload
        if lock is None:
            self._socks[peer].sendall(data)
        else:
            with lock:
                # the per-peer lock serializes socket writers
                self._socks[peer].sendall(data)

    def send(self, peer: int, frame: Any) -> None:
        plan = self._fault_plan
        if plan is not None:
            action = plan.on_send(self.process_id, peer, frame)
            if action == "drop":
                return
            if action == "reset":
                # synthetic RST: hard-close the socket mid-stream, then
                # fall through so the send fails like a real reset would
                try:
                    self._socks[peer].close()
                except OSError:
                    pass
            elif action == "dup":
                try:
                    self._send(peer, frame)
                except OSError:
                    pass
        try:
            self._send(peer, frame)
        except OSError as exc:
            if self._retry_send(peer, frame):
                return
            raise PeerLostError(
                f"process {self.process_id}: lost connection to peer "
                f"{peer}",
                peer=peer,
            ) from exc

    def _retry_send(self, peer: int, frame: Any) -> bool:
        """Bounded retry for transient send failures: redial the link with
        exponential backoff + jitter (``PATHWAY_TPU_MESH_SEND_RETRIES``,
        default 2; 0 disables).  A peer the recv loop already declared
        dead is NOT retried — in-flight frames were lost, so transparent
        resending would corrupt the round protocol; the rollback-based
        recovery path owns that case."""
        retries = _validated_int("PATHWAY_TPU_MESH_SEND_RETRIES", 2, 0)
        if retries == 0 or self._closed or peer in self.dead_peers:
            return False
        import random as _random

        delay = 0.05
        for _attempt in range(retries):
            _walltime.sleep(delay * (0.5 + _random.random()))
            delay = min(delay * 2, 1.0)
            try:
                self._repair_link(peer, deadline=2.0)
                self._send(peer, frame)
            except (OSError, RuntimeError):
                continue
            _metrics.REGISTRY.counter(
                "pathway_mesh_send_retries_total",
                "mesh sends recovered by the bounded retry path",
            ).inc(1)
            return True
        return False

    def _repair_link(self, peer: int, deadline: float) -> None:
        """Re-create the duplex socket to ``peer`` (dial-lower/accept-
        higher, same as startup) and restart its receiver thread."""
        old = self._socks.get(peer)
        if peer < self.process_id:
            sock = socket.create_connection(
                self._addrs[peer], timeout=deadline
            )
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._socks[peer] = sock
            self._send(peer, ("hello", self.process_id))
        else:
            listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            listener.bind(
                (self._bind_host, self._addrs[self.process_id][1])
            )
            listener.listen(self.n)
            listener.settimeout(deadline)
            try:
                conn, _addr = listener.accept()
                conn.settimeout(None)
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                frame = self._read_frame(conn)
                if (
                    not isinstance(frame, tuple)
                    or len(frame) != 2
                    or frame[0] != "hello"
                    or frame[1] != peer
                ):
                    conn.close()
                    raise RuntimeError(
                        f"process {self.process_id}: expected hello from "
                        f"peer {peer} on repair, got {frame!r}"
                    )
                self._socks[peer] = conn
            finally:
                listener.close()
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        self._start_recv(peer, self._socks[peer])

    def reestablish(self, peer: int, deadline: float = 30.0) -> None:
        """Reconnect to a restarted ``peer``: fresh socket, fresh (empty)
        frame queue, fresh receiver thread, liveness state reset.  The
        restarted process runs its normal constructor (bind, dial lower
        ids, accept higher ids), so survivors mirror that from the other
        side: lower ids accept the dial-in, higher ids dial its listener."""
        self._queues[peer] = queue.Queue(maxsize=QUEUE_HWM)
        end = _walltime.monotonic() + deadline
        delay = 0.05
        while True:
            try:
                self._repair_link(
                    peer, deadline=max(0.1, end - _walltime.monotonic())
                )
                break
            except (OSError, RuntimeError):
                if _walltime.monotonic() > end:
                    raise PeerLostError(
                        f"process {self.process_id}: could not "
                        f"re-establish the link to restarted peer {peer} "
                        f"within {deadline:g}s",
                        peer=peer,
                    )
                _walltime.sleep(delay)
                delay = min(delay * 2, 0.5)
        with self._peer_lock:
            self.dead_peers.discard(peer)
            self.last_seen[peer] = _walltime.monotonic()

    def heartbeat(self, peer: int) -> None:
        """Best-effort idle-time liveness frame; absorbed by the peer's
        receiver thread (never enters its protocol queue)."""
        try:
            self._send(peer, ("hb", self.process_id, _walltime.time()))
        except OSError:
            pass  # the recv loop / send path owns failure detection

    def broadcast(self, frame: Any) -> None:
        for peer in self._queues:
            self.send(peer, frame)

    def recv(self, peer: int, timeout: float = RECV_TIMEOUT) -> Any:
        try:
            frame = self._queues[peer].get(timeout=timeout)
        except queue.Empty:
            raise PeerLostError(
                f"process {self.process_id}: no frame from peer {peer} "
                f"within {timeout}s — a peer likely crashed",
                peer=peer,
            ) from None
        if isinstance(frame, tuple) and frame and frame[0] == "__eof__":
            raise PeerLostError(
                f"process {self.process_id}: peer {peer} disconnected",
                peer=peer,
            )
        return frame

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for sock in self._socks.values():
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


class DistributedScheduler:
    """The per-process commit pump of the multi-process runtime.

    Mirrors engine/sharded.py ShardedScheduler over ``threads`` local scope
    replicas, with remote workers reached through the mesh. Process 0's
    scope 0 is the primary replica: sources flush there, sinks and
    globally-stateful operators are pinned there."""

    def __init__(
        self,
        local_scopes: Sequence[Scope],
        process_id: int,
        n_processes: int,
        transport: MeshTransport,
        n_shared: int | None = None,
        probe: bool = False,
    ) -> None:
        self.scopes = list(local_scopes)
        for scope in self.scopes:
            # replica `current` holds key shards (see ShardedScheduler)
            scope.sharded = True
        self.threads = len(self.scopes)
        self.process_id = process_id
        self.n_processes = n_processes
        self.n_workers = self.threads * n_processes
        self.transport = transport
        self.time = 0
        self.probe = probe
        #: node index -> OperatorStats aggregated across LOCAL replicas
        #: (populated by _drain_local under probe; same read surface as
        #: Scheduler/ShardedScheduler for the monitor + mesh snapshots)
        self.stats: dict[int, Any] = {}
        #: peer process id -> last piggybacked metrics snapshot (leader
        #: only; followers attach theirs to round frames bound for 0)
        self.mesh_metrics: dict[int, dict] = {}
        #: peer process id -> spans piggybacked for the in-flight sampled
        #: trace (leader only; the runner assembles + clears per commit)
        self.trace_peer_spans: dict[int, list] = {}
        if probe:
            self._queue_gauge = _metrics.REGISTRY.gauge(
                "pathway_queue_depth",
                "operators with pending delta batches (backpressure)",
            )
        #: shared graph length: nodes with index >= n_shared exist only on
        #: process 0 / scope 0 (sink-side chains attached there). The
        #: runner measures it before attaching sink drivers; guessing it
        #: here (e.g. min over local scopes) silently desynchronizes
        #: routing when every local scope carries sink-side nodes,
        #: so it is required.
        if n_shared is None:
            raise ValueError(
                "n_shared is required: pass the shared graph length "
                "measured before sink drivers are attached "
                "(DistributedGraphRunner.attach_sinks records it)"
            )
        self.n_shared = n_shared
        #: producer index -> [(consumer index, port)] for process-0-only
        #: consumers, learned from the coordinator's topology broadcast
        self.extra_consumers: dict[int, list[tuple[int, int]]] = {}
        # local replicas must carry the identical shared operator sequence
        # (ShardedScheduler's divergence check, applied per process)
        sig0 = self._shared_signature()
        for idx, scope in enumerate(self.scopes[1:], start=1):
            sig = [type(n).__name__ for n in scope.nodes[: self.n_shared]]
            if sig != sig0:
                raise ValueError(
                    f"local worker {idx} scope diverged: the graph logic "
                    "must build the identical operator sequence on every "
                    "worker"
                )
        self._parts: dict[tuple[int, int], Any] = {}
        #: optimizer-proven redundant exchange edges; populated lazily by
        #: _ensure_optimized AFTER the topology handshake, so the type-name
        #: signatures above compare pre-rewrite graphs on every process
        self._elided: set = set()
        self._optimized = False
        #: deliveries queued for each remote process this round
        self._outbox: dict[int, list[tuple]] = {
            p: [] for p in range(n_processes) if p != process_id
        }
        #: peer process id -> wall-clock heartbeat stamp piggybacked on
        #: its most recent round frame (liveness evidence for post-mortems;
        #: the transport's monotonic ``last_seen`` drives suspicion)
        self.peer_heartbeats: dict[int, float] = {}
        #: a leader recover command that arrived MID-ROUND on a follower
        #: (stashed by _recv_round for the runner's park loop to consume)
        self._pending_recover: tuple | None = None
        #: per-kind epoch fence: rejects control frames from fenced-out
        #: zombie leaders and fault-injected duplicates (see EpochFence)
        self.fence = EpochFence()

    # -- topology ----------------------------------------------------------

    def _shared_signature(self) -> list[str]:
        return [
            type(n).__name__ for n in self.scopes[0].nodes[: self.n_shared]
        ]

    def announce_topology(self) -> None:
        """Process 0: tell peers about sink-side consumers so their
        producer replicas route output here (the sharded scheduler reads
        worker 0's superset scope directly; remote processes can't)."""
        assert self.process_id == 0
        scope0 = self.scopes[0]
        extra: list[tuple[int, int, int]] = []
        for node in scope0.nodes[: self.n_shared]:
            for consumer, port in node.consumers:
                if consumer.index >= self.n_shared:
                    extra.append((node.index, consumer.index, port))
        # rebuilt from scratch: announce may run again after a leader
        # restart, and appending twice would double-deliver to sinks
        self.extra_consumers = {}
        for prod, cons, port in extra:
            self.extra_consumers.setdefault(prod, []).append((cons, port))
        # kept verbatim for recovery: a restarted follower re-runs the
        # topology handshake against the SAME frame the originals saw
        self._topology_frame = (
            "topology", self.n_shared, self._shared_signature(), extra
        )
        self.transport.broadcast(self._topology_frame)
        self._ensure_optimized()

    def reannounce_to(self, peer: int) -> None:
        """Re-send the stored topology frame to one restarted peer (its
        fresh ``receive_topology`` runs the same divergence +
        ``_ensure_optimized`` fingerprint checks the original did)."""
        assert self.process_id == 0
        self.transport.send(peer, self._topology_frame)

    def receive_topology(self) -> None:
        frame = self.transport.recv(0)
        if not isinstance(frame, tuple) or len(frame) != 4 or frame[0] != "topology":
            raise RuntimeError(
                f"process {self.process_id}: expected the coordinator's "
                f"topology frame, got {frame!r}"
            )
        _kind, n_shared, signature, extra = frame
        if n_shared != self.n_shared or signature != self._shared_signature():
            raise RuntimeError(
                "graph divergence: the program must build the identical "
                f"operator graph in every process (coordinator has "
                f"{n_shared} shared nodes {signature[:6]}..., process "
                f"{self.process_id} has {self.n_shared} "
                f"{self._shared_signature()[:6]}...)"
            )
        # rebuilt, not appended: survivors re-run this handshake against a
        # restarted or newly elected leader, and duplicate consumer edges
        # would double-deliver every sink row
        self.extra_consumers = {}
        for prod, cons, port in extra:
            self.extra_consumers.setdefault(prod, []).append((cons, port))
        self._ensure_optimized()

    def _ensure_optimized(self) -> None:
        """Run the pre-execution rewriter once, after the topology
        handshake: the decision inputs (shared region + producers with
        off-process sink consumers) are then identical on every process,
        so every replica graph mutates the same way."""
        if self._optimized:
            return
        self._optimized = True
        from pathway_tpu_torch.optimize import optimize_scopes

        self._elided = optimize_scopes(
            self.scopes,
            n_shared=self.n_shared,
            protected=set(self.extra_consumers),
        )

    # -- worker placement --------------------------------------------------

    def _owner(self, worker: int) -> tuple[int, int]:
        """worker -> (process, local scope idx)."""
        return worker // self.threads, worker % self.threads

    def _partition_fn(self, consumer: Node, port: int):
        key = (consumer.index, port)
        fn = self._parts.get(key, False)
        if fn is False:
            fn = partitioner(consumer, port, self.n_workers)
            self._parts[key] = fn
        return fn

    def _push_remote(
        self,
        process: int,
        kind: str,
        index: int,
        port_or_worker: int,
        worker: int,
        entries: list,
        consolidated: bool,
        insert_only: bool = False,
    ) -> None:
        if kind == "push":
            EXCHANGE_STATS["row_batches_sent"] += 1
        self._outbox[process].append(
            (kind, index, port_or_worker, worker, entries, consolidated,
             insert_only)
        )

    def _push_remote_columnar(
        self,
        process: int,
        kind: str,
        index: int,
        port_or_worker: int,
        worker: int,
        frame: bytes,
        consolidated: bool,
        insert_only: bool,
        raw_insert_only: bool,
    ) -> None:
        EXCHANGE_STATS["columnar_frames_sent"] += 1
        self._outbox[process].append(
            (kind, index, port_or_worker, worker, frame, consolidated,
             insert_only, raw_insert_only)
        )

    def _push_remote_batch(
        self,
        process: int,
        cons_idx: int,
        port: int,
        worker: int,
        out: DeltaBatch,
    ) -> None:
        """Ship a WHOLE batch to one remote worker: a columnar frame when
        the payload allows it, pickled row entries otherwise."""
        if (
            COLUMNAR_EXCHANGE
            and out._entries is None
            and out.columns is not None
        ):
            frame = encode_columns_frame(out.columns)
            if frame is not None:
                self._push_remote_columnar(
                    process, "cpush", cons_idx, port, worker, frame,
                    out._consolidated, out._insert_only,
                    out._raw_insert_only,
                )
                return
        self._push_remote(
            process, "push", cons_idx, port, worker, out.entries,
            out._consolidated, out._insert_only,
        )

    def _local_push(
        self, scope_idx: int, consumer_index: int, port: int, entries: list,
        consolidated: bool, insert_only: bool = False,
    ) -> None:
        batch = DeltaBatch(entries)
        batch._consolidated = consolidated
        batch._insert_only = insert_only
        self.scopes[scope_idx].nodes[consumer_index].push(port, batch)

    # -- exchange ----------------------------------------------------------

    def _deliver(
        self, producer: Node, out: DeltaBatch, scope_idx: int = 0
    ) -> None:
        """Split ``out`` per consumer; push each part to the consumer's
        replica on the owning worker (local) or queue it for the owning
        process (remote).  ``scope_idx`` is the local replica that produced
        ``out`` — elided edges stay on that worker."""
        elided = self._elided
        for consumer, port in self.scopes[0].nodes[producer.index].consumers:
            if (producer.index, consumer.index, port) in elided:
                # optimizer-proven redundant exchange: skip the routing
                # digests AND the PWCF encode/decode round-trip — the
                # whole batch already lives on this worker's replica
                if _verify_elision():
                    _assert_colocated(
                        consumer, port, out,
                        self.process_id * self.threads + scope_idx,
                        self.n_workers,
                    )
                EXCHANGE_STATS["elided"] += 1
                EXCHANGE_STATS["repartitions"] += 1
                self.scopes[scope_idx].nodes[consumer.index].push(port, out)
                continue
            self._route_part(consumer.index, port, consumer, out)
        # sink-side consumers exist only on process 0 / scope 0. Process 0
        # reads them from its own superset consumer lists above (for every
        # local replica); remote processes route from the broadcast topology.
        if self.process_id != 0:
            for cons_idx, port in self.extra_consumers.get(producer.index, ()):
                EXCHANGE_STATS["host_deliveries"] += 1
                EXCHANGE_STATS["repartitions"] += 1
                self._push_remote_batch(0, cons_idx, port, 0, out)

    def _route_part(
        self,
        cons_idx: int,
        port: int,
        consumer: Node,
        out: DeltaBatch,
    ) -> None:
        if cons_idx >= self.n_shared or self._partition_fn(consumer, port) is None:
            # pinned whole to worker 0 (sink chain / globally-stateful op):
            # push the batch object itself, no copy (ShardedScheduler does
            # the same — consumers never mutate received batches)
            EXCHANGE_STATS["host_deliveries"] += 1
            EXCHANGE_STATS["repartitions"] += 1
            if self.process_id == 0:
                self.scopes[0].nodes[cons_idx].push(port, out)
            else:
                self._push_remote_batch(0, cons_idx, port, 0, out)
            return
        if (
            COLUMNAR_EXCHANGE
            and out._entries is None
            and out.columns is not None
        ):
            shards = columnar_shards(
                partition_rule(consumer, port), out.columns, self.n_workers
            )
            if shards is not None and self._route_columnar(
                cons_idx, port, out, shards, consumer=consumer
            ):
                return
        EXCHANGE_STATS["host_deliveries"] += 1
        EXCHANGE_STATS["repartitions"] += 1
        parts: list[list] = [[] for _ in range(self.n_workers)]
        shards = entry_shards(
            partition_rule(consumer, port), out.entries, self.n_workers
        )
        if shards is not None:
            # batched worker assignment (one digest kernel call), same
            # per-row definition as the partitioner closures
            for e, w in zip(out.entries, shards):
                parts[w].append(e)
        else:
            fn = self._partition_fn(consumer, port)
            for key, row, diff in out:
                parts[fn(key, row)].append((key, row, diff))
        for worker, entries in enumerate(parts):
            if not entries:
                continue
            process, scope_idx = self._owner(worker)
            if process == self.process_id:
                self._local_push(
                    scope_idx, cons_idx, port, entries,
                    out._consolidated, out._insert_only,
                )
            else:
                self._push_remote(
                    process, "push", cons_idx, port, worker, entries,
                    out._consolidated, out._insert_only,
                )

    def _route_columnar(
        self,
        cons_idx: int,
        port: int,
        out: DeltaBatch,
        shards: np.ndarray,
        consumer: "Node | None" = None,
    ) -> bool:
        """Route a columnar batch by a precomputed shard vector: local
        shards push gathered ``Columns`` (no serialization at all), remote
        shards ship dtype-tagged frames. Returns False — with NO pushes
        performed — when some shard must go remote but the payload cannot
        frame-encode, so the caller's row path handles the whole batch.

        The JAX package first offers a batch whose destinations are all in
        this process to its device collective; that plane is ROADMAP queue 1
        item 14, slice c, so every batch takes the host gather here."""
        cols = out.columns
        workers = np.unique(shards).tolist()
        any_remote = any(
            self._owner(w)[0] != self.process_id for w in workers
        )
        if any_remote:
            if not _frame_encodable(cols):
                return False
            try:
                cols.kbytes()  # force lazy keys BEFORE any local push
            except Exception:  # noqa: BLE001 — the row path derives the keys
                return False
        EXCHANGE_STATS["host_deliveries"] += 1
        EXCHANGE_STATS["repartitions"] += 1
        for worker in workers:
            idx = np.flatnonzero(shards == worker)
            part = cols.gather(idx)
            process, scope_idx = self._owner(worker)
            if process == self.process_id:
                batch = DeltaBatch.from_columns(
                    part,
                    consolidated=out._consolidated,
                    insert_only=out._insert_only,
                )
                batch._raw_insert_only = out._raw_insert_only
                self.scopes[scope_idx].nodes[cons_idx].push(port, batch)
            else:
                frame = encode_columns_frame(part)
                assert frame is not None  # encodability proven above
                self._push_remote_columnar(
                    process, "cpush", cons_idx, port, worker, frame,
                    out._consolidated, out._insert_only,
                    out._raw_insert_only,
                )
        return True

    def _apply_remote(self, deliveries: list[tuple]) -> bool:
        got = False
        for delivery in deliveries:
            got = True
            kind = delivery[0]
            if kind in ("cpush", "cstate"):
                (
                    _kind, index, port_or_worker, worker, frame,
                    consolidated, insert_only, raw_insert_only,
                ) = delivery
                EXCHANGE_STATS["columnar_frames_received"] += 1
                _process, scope_idx = self._owner(worker)
                batch = DeltaBatch.from_columns(
                    decode_columns_frame(frame),
                    consolidated=consolidated,
                    insert_only=insert_only,
                )
                batch._raw_insert_only = raw_insert_only
                if kind == "cstate":
                    # lazy replica-state apply: rows materialise only if a
                    # state-peeking consumer actually reads this replica
                    self.scopes[scope_idx].nodes[index]._defer_state(batch)
                else:
                    self.scopes[scope_idx].nodes[index].push(
                        port_or_worker, batch
                    )
                continue
            (
                kind, index, port_or_worker, worker, entries, consolidated,
                insert_only,
            ) = delivery
            _process, scope_idx = self._owner(worker)
            if kind == "state":
                self.scopes[scope_idx].nodes[index]._defer_state(
                    DeltaBatch(entries)
                )
            else:
                self._local_push(
                    scope_idx, index, port_or_worker, entries, consolidated,
                    insert_only,
                )
        return got

    def _stats_of(self, node: Node):
        from pathway_tpu_torch.engine.graph import OperatorStats

        st = self.stats.get(node.index)
        if st is None:
            st = self.stats[node.index] = OperatorStats()
        return st

    def _metrics_snapshot(self) -> dict:
        """This process's registry snapshot plus its per-operator series —
        the payload followers piggyback on round frames bound for the
        leader (the mesh stats protocol).  When the sampling profiler is
        running, its payload rides along under the reserved
        ``"__profile__"`` key (popped by the leader at absorption, never
        rendered as a metrics family) — the frame arity stays at 8."""
        snap = _metrics.full_snapshot(self)
        if _profiling.PROFILER.running:
            snap["__profile__"] = _profiling.PROFILER.payload()
        return snap

    # -- commit ------------------------------------------------------------

    def _drain_local(self, time: int) -> bool:
        """Process local pending work to quiescence (including same-time
        error-log feedback); remote parts accumulate in the outbox.
        Returns True if anything was processed."""
        busy = False
        probe = self.probe
        trace = _tracing.current()
        while True:
            did = False
            busy_nodes = 0
            for scope_idx, scope in enumerate(self.scopes):
                for node in scope.nodes:
                    if not node.has_pending():
                        continue
                    did = True
                    busy_nodes += 1
                    if probe or trace is not None:
                        t0 = _walltime.perf_counter()
                    out = node.process(time)
                    if out is None:
                        out = DeltaBatch()
                    out = out.consolidate() if out else out
                    # defer like the sharded scheduler: an eager apply
                    # would materialise columnar batches into rows before
                    # the vectorized exchange ships them
                    node._defer_state(out)
                    if trace is not None:
                        trace.span(
                            getattr(node, "name", None)
                            or type(node).__name__,
                            "sink"
                            if isinstance(node, SubscribeNode)
                            else "op",
                            t0,
                            _walltime.perf_counter(),
                            node=node.index,
                            scope=scope_idx,
                        )
                    if probe:
                        st = self._stats_of(node)
                        st.time_spent += _walltime.perf_counter() - t0
                        st.batches += 1
                        st.last_time = time
                        cols = out.columns
                        if cols is not None:
                            if cols.diffs is None:
                                st.insertions += cols.n
                            else:
                                pos = int((cols.diffs > 0).sum())
                                st.insertions += pos
                                st.deletions += cols.n - pos
                        else:
                            for _k, _r, d in out.consolidate():
                                if d > 0:
                                    st.insertions += 1
                                else:
                                    st.deletions += 1
                    if out:
                        self._deliver(node, out, scope_idx)
            if probe:
                self._queue_gauge.value = float(busy_nodes)
            if did:
                busy = True
                continue
            flushed = False
            for scope in self.scopes:
                for node in scope.nodes:
                    if isinstance(node, ErrorLogNode):
                        batch = node.flush_buffer()
                        if batch:
                            node.push(0, batch)
                            flushed = True
            if not flushed:
                return busy
            busy = True

    def _flush_sources(self) -> None:
        """Coordinator: flush static sources + input sessions of the
        primary replica; maintain the sharded source-state invariant
        (sharded.py _route_source) and route downstream parts."""
        scope0 = self.scopes[0]
        for node in scope0.nodes:
            if isinstance(node, StaticSource):
                batch = node.initial_batch()
            elif isinstance(node, InputSession):
                batch = node.flush()
                if batch:
                    batch = batch.consolidate()  # flush may return raw diffs
            else:
                continue
            if not batch:
                continue
            # full state on the primary replica (lazily — the property
            # drains before anything reads it; sharded.py defers the same)
            node._defer_state(batch)
            if (
                COLUMNAR_EXCHANGE
                and batch._entries is not None
                and len(batch) >= VECTOR_THRESHOLD
            ):
                # bulk source commits enter the exchange as arrays: the
                # replica sharding and every consumer route below then run
                # the vectorized kernel + wire frames, not per-row hashing
                # (static sources arrive raw — consolidate first, since
                # the columnar twin asserts unique-key +1 invariants)
                cbatch = columnarize_entries(batch.consolidate())
                if cbatch is not None:
                    batch = cbatch
            # key-shard parts maintain replica state on workers > 0
            if self.n_workers > 1 and not self._replicate_source_columnar(
                node, batch
            ):
                parts: list[list] = [[] for _ in range(self.n_workers)]
                key_shards = shards_of_values(
                    [e[0] for e in batch.entries], self.n_workers
                )
                for e, w in zip(batch.entries, key_shards):
                    parts[w].append(e)
                for worker in range(1, self.n_workers):
                    if not parts[worker]:
                        continue
                    process, scope_idx = self._owner(worker)
                    if process == self.process_id:
                        self.scopes[scope_idx].nodes[
                            node.index
                        ]._defer_state(DeltaBatch(parts[worker]))
                    else:
                        self._push_remote(
                            process, "state", node.index, 0, worker,
                            parts[worker], batch._consolidated,
                        )
            self._deliver(node, batch)

    def _replicate_source_columnar(
        self, node: Node, batch: DeltaBatch
    ) -> bool:
        """Key-shard the source batch for replica state WITHOUT building
        per-row entries: same routing kernel, ``("key",)`` rule, state
        frames on the wire. False = caller runs the row loop."""
        if not (
            COLUMNAR_EXCHANGE
            and batch._entries is None
            and batch.columns is not None
        ):
            return False
        shards = columnar_shards(("key",), batch.columns, self.n_workers)
        if shards is None:
            return False
        cols = batch.columns
        workers = [w for w in np.unique(shards).tolist() if w != 0]
        if any(
            self._owner(w)[0] != self.process_id for w in workers
        ) and not _frame_encodable(cols):
            return False
        for worker in workers:
            part = cols.gather(np.flatnonzero(shards == worker))
            process, scope_idx = self._owner(worker)
            if process == self.process_id:
                self.scopes[scope_idx].nodes[node.index]._defer_state(
                    DeltaBatch.from_columns(
                        part, consolidated=batch._consolidated
                    )
                )
            else:
                frame = encode_columns_frame(part)
                assert frame is not None  # encodability proven above
                self._push_remote_columnar(
                    process, "cstate", node.index, 0, worker, frame,
                    batch._consolidated, False, False,
                )
        return True

    def _mark_replica_sources(self) -> None:
        """Non-primary replicas never emit static rows themselves
        (sharded.py: `if w != 0: node._emitted = True`)."""
        for scope_idx, scope in enumerate(self.scopes):
            if self.process_id == 0 and scope_idx == 0:
                continue
            for node in scope.nodes:
                if isinstance(node, StaticSource):
                    node._emitted = True

    def _recv_round(self, peer: int, time: int, round_no: int) -> tuple:
        """Receive one round frame from ``peer``, absorbing duplicated
        frames of the previous round (fault injection / resent links) and
        converting a peer's abort announcement into :class:`PeerLostError`
        so this process parks for recovery instead of deadlocking on a
        frame that will never come."""
        while True:
            frame = self.transport.recv(peer)
            kind = frame[0]
            if kind == "abort":
                raise PeerLostError(
                    f"process {self.process_id}: peer {peer} aborted "
                    f"commit {frame[1]} round {frame[2]} (its own peer "
                    "loss)",
                    peer=peer,
                )
            if kind == "cmd" and len(frame) >= 3 and frame[1] == "recover":
                if (
                    len(frame) >= 4
                    and frame[3] <= self.fence.floor("recover")
                ):
                    # fault-injected duplicate of a recovery we already
                    # ran: fenced, not re-triggered
                    self.fence.admit("recover", frame[3])
                    continue
                # the leader started recovery while this follower was
                # still waiting out the doomed round: stash the command
                # for the park loop and leave the round
                self._pending_recover = frame
                raise PeerLostError(
                    f"process {self.process_id}: leader announced "
                    f"recovery of peer {frame[2]} mid-round",
                    peer=frame[2],
                )
            if kind in ("sync", "rejoin", "elect", "elect-ack"):
                # recovery-era debris: a duplicated sync barrier frame or
                # a late election frame that survived the resync drain is
                # never legitimate inside a round — absorb it
                continue
            if kind == "round" and (
                frame[1] < time
                or (frame[1] == time and frame[2] < round_no)
            ):
                continue  # duplicate of a frame already applied
            return frame

    def _announce_abort(self, time: int, round_no: int) -> None:
        """Tell every still-reachable peer this process is leaving the
        round: survivors unblock immediately instead of waiting out the
        mesh timeout on a frame that will never arrive."""
        for peer in sorted(self._outbox):
            if peer in self.transport.dead_peers:
                continue
            try:
                self.transport._send(peer, ("abort", time, round_no))
            except OSError:
                pass

    def _exchange_rounds(self, time: int, notify_time_end: bool = True) -> bool:
        transport = self.transport
        peers = sorted(self._outbox)
        round_no = 0
        any_work = False
        try:
            while True:
                # re-fetched per round: a follower adopts the leader's
                # trace context from the round-0 frame, so rounds >= 1
                # (and the drain they gate) see it active
                ctx = _tracing.current()
                busy = self._drain_local(time)
                my_bit = busy or any(self._outbox.values())
                # mesh stats protocol: once this process goes quiet for the
                # round, piggyback its metrics snapshot on the frame bound
                # for the leader — no extra frames, no extra round-trips
                snap = None
                spans = None
                if self.process_id != 0 and not my_bit:
                    snap = self._metrics_snapshot()
                    # trace protocol, same shape: a quiet follower ships
                    # its span list to the leader; the last quiescent
                    # round carries the complete set (leader keeps the
                    # latest copy per peer)
                    if ctx is not None:
                        spans = ("spans", _tracing.TRACER.take_spans())
                trace_out = _tracing.TRACER.ctx_frame()
                hb = _walltime.time()
                for peer in peers:
                    transport.send(
                        peer,
                        (
                            "round", time, round_no, my_bit,
                            self._outbox[peer],
                            snap if peer == 0 else None,
                            hb,
                            trace_out if self.process_id == 0
                            else (spans if peer == 0 else None),
                        ),
                    )
                    self._outbox[peer] = []
                global_busy = my_bit
                for peer in peers:
                    if ctx is not None:
                        t0 = _walltime.perf_counter()
                    frame = self._recv_round(peer, time, round_no)
                    if ctx is not None:
                        # blocking on a peer's round frame is wire-exchange
                        # latency, not ingest queueing: it lands in the
                        # critical path's exchange bucket
                        ctx.span(
                            f"recv-wait:p{peer}",
                            "exchange",
                            t0,
                            _walltime.perf_counter(),
                            round=round_no,
                        )
                    (
                        kind, f_time, f_round, bit, deliveries, peer_snap,
                        peer_hb, trace_el,
                    ) = frame
                    if (
                        kind != "round"
                        or f_time != time
                        or f_round != round_no
                    ):
                        raise RuntimeError(
                            f"process {self.process_id}: protocol desync "
                            f"with peer {peer}: got {frame[:3]}, expected "
                            f"round ({time}, {round_no})"
                        )
                    if trace_el is not None:
                        if trace_el[0] == "ctx" and self.process_id != 0:
                            ctx = _tracing.TRACER.adopt(trace_el)
                        elif trace_el[0] == "spans" and self.process_id == 0:
                            self.trace_peer_spans[peer] = trace_el[1]
                    if ctx is not None and deliveries:
                        t0 = _walltime.perf_counter()
                        self._apply_remote(deliveries)
                        ctx.span(
                            f"apply:p{peer}",
                            "exchange",
                            t0,
                            _walltime.perf_counter(),
                            deliveries=len(deliveries),
                            round=round_no,
                        )
                    else:
                        self._apply_remote(deliveries)
                    if peer_snap is not None:
                        profile = peer_snap.pop("__profile__", None)
                        if profile is not None:
                            _profiling.PROFILER.absorb(peer, profile)
                        self.mesh_metrics[peer] = peer_snap
                    self.peer_heartbeats[peer] = peer_hb
                    global_busy = global_busy or bit
                round_no += 1
                any_work = any_work or global_busy
                if not global_busy:
                    break
        except PeerLostError:
            self._announce_abort(time, round_no)
            raise
        _metrics.FLIGHT.record("exchange", time=time, rounds=round_no)
        if notify_time_end or any_work:
            for scope in self.scopes:
                for node in scope.nodes:
                    node.on_time_end(time)
        from pathway_tpu_torch.engine import device_pipeline

        device_pipeline.commit_boundary(time)
        return any_work

    def commit_local(self) -> int:
        """One commit: coordinator flushes sources, then all processes run
        exchange rounds to global quiescence."""
        self._ensure_optimized()  # no-op after the topology handshake
        self._mark_replica_sources()
        if self.process_id == 0:
            self._flush_sources()
        time = self.time
        self._exchange_rounds(time)
        self.time += 1
        _metrics.FLIGHT.record(
            "commit", time=time, process=self.process_id
        )
        if self.process_id != 0:
            # adopted context ends with the commit; its spans already
            # rode the final quiescent round's frame to the leader
            _tracing.TRACER.drop()
        return time

    def finish_local(self) -> None:
        """Final commit + on_end hooks + one settling commit
        (ShardedScheduler.finish)."""
        self.commit_local()
        for scope in self.scopes:
            for node in scope.nodes:
                node.on_end()
        # on_end may inject final batches (buffer flush) on any process;
        # sinks tear down in close() only after the settlement delivers them
        self._exchange_rounds(self.time, notify_time_end=False)
        self.time += 1
        if self.process_id != 0:
            _tracing.TRACER.drop()
        from pathway_tpu_torch.engine import device_pipeline

        device_pipeline.drain()
        for scope in self.scopes:
            for node in scope.nodes:
                node.close()

    # -- recovery ----------------------------------------------------------

    def discard_inflight(self) -> None:
        """Drop every runtime-queued batch on this process — operator
        pending queues, deferred state lag, unflushed input-session rows,
        and the remote outbox.  Run before a snapshot rollback: anything
        in flight belongs to a commit the rollback un-happens, and the
        restored snapshot (plus re-driven connectors) re-derives it."""
        from pathway_tpu_torch.engine import device_pipeline

        device_pipeline.reset()
        for scope in self.scopes:
            for node in scope.nodes:
                node.pending.clear()
                node._state_lag = []
                node._state_lag_rows = 0
                if isinstance(node, InputSession):
                    node._buffer = []
                    node._has_removals = False
                    node._has_rowless_removals = False
        for peer in self._outbox:
            self._outbox[peer] = []

    def prune_mesh_metrics(self, dead: Sequence[int] = ()) -> None:
        """Drop piggybacked metrics snapshots (and pending trace spans)
        of peers that no longer exist: explicitly named dead peers, the
        transport's dead set, and ids beyond the current mesh width —
        so the aggregated ``/metrics`` exposition stops rendering their
        ``worker=`` label sets."""
        gone = set(dead) | set(self.transport.dead_peers)
        for peer in list(self.mesh_metrics):
            if peer in gone or peer >= self.n_processes:
                self.mesh_metrics.pop(peer, None)
        for peer in list(self.trace_peer_spans):
            if peer in gone or peer >= self.n_processes:
                self.trace_peer_spans.pop(peer, None)
        # same lifecycle for the other observability planes: absorbed
        # profile payloads and the timeseries ring's worker label sets
        # of dead/out-of-width peers must not outlive them
        _profiling.PROFILER.prune(dead=gone, width=self.n_processes)
        _timeseries.STORE.prune_workers(
            dead={str(p) for p in gone}, width=self.n_processes
        )

    def resync(self, epoch: int) -> None:
        """Post-rollback barrier: flush stale frames off every peer link.
        Each process sends ``("sync", epoch)`` to every peer, then drains
        each peer queue until the matching sync arrives — per-peer FIFO
        ordering guarantees everything queued before it (orphaned round
        frames, aborts, old syncs) is gone.  All sends precede all drains,
        so the barrier cannot deadlock even with bounded queues."""
        # raise the trace fence with the mesh epoch: context tuples a
        # fenced-out zombie leader stamped before this barrier are
        # rejected by TraceRecorder.adopt; the profiler fence rises in
        # lockstep so pre-barrier profile payloads are dropped too
        _tracing.TRACER.epoch = max(_tracing.TRACER.epoch, int(epoch))
        _profiling.PROFILER.epoch = max(
            _profiling.PROFILER.epoch, int(epoch)
        )
        # the JAX package also raises the serving tier's snapshot-stream
        # epoch here (ROADMAP queue 1 item 8)
        peers = sorted(self._outbox)
        for peer in peers:
            self.transport.send(peer, ("sync", epoch))
        for peer in peers:
            while True:
                frame = self.transport.recv(peer)
                if (
                    isinstance(frame, tuple)
                    and frame
                    and frame[0] == "sync"
                    and frame[1] == epoch
                ):
                    break

    def rollback(self, to_time: int, snapshot_mgr, drivers: list) -> None:
        """Roll this process back to the snapshot of commit ``to_time``
        (``-1`` = cold state) and resume the clock after it.  The caller
        runs :meth:`resync` afterwards so every peer crosses the same
        epoch boundary before new rounds begin."""
        self.discard_inflight()
        if to_time >= 0:
            restored = snapshot_mgr.restore(
                self.scopes, drivers, at_time=to_time
            )
            self.time = int(restored) + 1
        else:
            self.time = max(self.time, 0)
        _metrics.FLIGHT.record(
            "recovery_rollback",
            process=self.process_id,
            to_time=to_time,
            resumed_time=self.time,
        )
        # the JAX package also truncates the serving tier's read store and
        # fans the rollback out to its replicas here (ROADMAP queue 1 item 8)

    # -- monitoring surface parity ----------------------------------------

    @property
    def scope(self) -> Scope:
        return self.scopes[0]

    def merged_state(self, index: int) -> dict[Pointer, tuple]:
        """Union of one operator's state across LOCAL replicas (cross-
        process captures are not collected; outputs flow through sinks)."""
        out: dict[Pointer, tuple] = {}
        for scope in self.scopes:
            out.update(scope.nodes[index].current)
        return out
