"""The NATS client protocol: a connection, the transport ``pw.io.nats`` reads and
writes through, and an in-process server, over real frames.

Counterpart of ``pathway_tpu/io/_nats_wire.py``, speaking the same lines (the nats.io
protocol docs):

- the server greets with ``INFO {json}\\r\\n``; the client answers
  ``CONNECT {json}\\r\\n``
- ``PING\\r\\n`` / ``PONG\\r\\n`` keepalives (either direction)
- publish:   ``PUB <subject> [reply-to] <#bytes>\\r\\n<payload>\\r\\n``
- subscribe: ``SUB <subject> [queue-group] <sid>\\r\\n``
- delivery:  ``MSG <subject> <sid> [reply-to] <#bytes>\\r\\n<payload>\\r\\n``
- ``+OK`` / ``-ERR 'reason'`` in verbose mode

:class:`FakeNatsServer` routes PUB frames to the matching subscriptions (exact
subjects, ``*`` for one token and ``>`` for the rest), with optional token auth, and
counts the bytes that cross it. A :class:`NatsTransport` reads a subject without end
until it is closed: ``close()`` waits for a poll in flight on another thread, and later
polls read nothing and ``finished()`` holds (the reference's never finishes).
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Any

from pathway_tpu_torch.engine.storage import Message
from pathway_tpu_torch.io._pg_wire import _close_server


class NatsError(Exception):
    """-ERR from the server or a protocol violation."""


class _LineReader:
    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self._buf = b""

    def read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise NatsError("connection closed by peer")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise NatsError("connection closed by peer")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out


def _subject_matches(pattern: str, subject: str) -> bool:
    """NATS subject matching: ``*`` = one token, ``>`` = rest."""
    p_toks = pattern.split(".")
    s_toks = subject.split(".")
    for i, p in enumerate(p_toks):
        if p == ">":
            return len(s_toks) > i  # '>' stands for ONE OR MORE tokens
        if i >= len(s_toks):
            return False
        if p != "*" and p != s_toks[i]:
            return False
    return len(p_toks) == len(s_toks)


class NatsConnection:
    """Wire-level NATS client: INFO/CONNECT handshake, PUB/SUB/MSG."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 4222,
        *,
        token: str | None = None,
        user: str | None = None,
        password: str | None = None,
        verbose: bool = False,
        connect_timeout: float = 10.0,
    ) -> None:
        self.sock = socket.create_connection(
            (host, port), timeout=connect_timeout
        )
        self._reader = _LineReader(self.sock)
        self._lock = threading.Lock()
        self.verbose = verbose
        line = self._reader.read_line()
        if not line.startswith(b"INFO "):
            raise NatsError(f"expected INFO, got {line[:40]!r}")
        self.server_info = json.loads(line[5:])
        options: dict[str, Any] = {
            "verbose": verbose,
            "pedantic": False,
            "lang": "pathway-tpu",
            "version": "1.0",
            "protocol": 0,
        }
        if token is not None:
            options["auth_token"] = token
        if user is not None:
            options["user"] = user
            options["pass"] = password
        self._send(f"CONNECT {json.dumps(options)}\r\n".encode())
        # PING/PONG completes the handshake and surfaces auth errors
        self._send(b"PING\r\n")
        self._await_pong()
        #: messages delivered for our subscriptions: (subject, sid, payload)
        self.inbox: list[tuple[str, int, bytes]] = []

    def _send(self, data: bytes) -> None:
        with self._lock:
            self.sock.sendall(data)

    def _await_pong(self) -> None:
        while True:
            line = self._handle_line(self._reader.read_line())
            if line == b"PONG":
                return

    def _handle_line(self, line: bytes) -> bytes:
        """Process one server line; MSG payloads land in the inbox."""
        if line.startswith(b"-ERR"):
            raise NatsError(line.decode("utf-8", "replace"))
        if line == b"PING":
            self._send(b"PONG\r\n")
            return line
        if line.startswith(b"MSG "):
            parts = line.decode().split(" ")
            # MSG <subject> <sid> [reply-to] <#bytes>
            subject, sid = parts[1], int(parts[2])
            size = int(parts[-1])
            # the header is consumed: the payload MUST follow. A drain()
            # poll timeout firing mid-payload would desync the stream,
            # so the payload read gets its own generous window and a
            # stall is a hard protocol error, not a quiet return
            old_timeout = self.sock.gettimeout()
            if old_timeout is not None and old_timeout < 5.0:
                self.sock.settimeout(5.0)
            try:
                payload = self._reader.read_exact(size)
                self._reader.read_exact(2)  # trailing \r\n
            except (TimeoutError, socket.timeout) as exc:
                raise NatsError(
                    f"MSG payload stalled mid-frame ({size} bytes)"
                ) from exc
            finally:
                self.sock.settimeout(old_timeout)
            self.inbox.append((subject, sid, payload))
        return line

    def publish(self, subject: str, payload: bytes) -> None:
        self._send(
            f"PUB {subject} {len(payload)}\r\n".encode()
            + payload
            + b"\r\n"
        )
        if self.verbose:
            self._await_ok()

    def _await_ok(self) -> None:
        while True:
            if self._handle_line(self._reader.read_line()) == b"+OK":
                return

    def subscribe(self, subject: str, sid: int = 1) -> None:
        self._send(f"SUB {subject} {sid}\r\n".encode())
        if self.verbose:
            self._await_ok()

    def unsubscribe(self, sid: int) -> None:
        self._send(f"UNSUB {sid}\r\n".encode())

    def drain(self, timeout: float = 0.05) -> list[tuple[str, int, bytes]]:
        """Pull whatever the server has delivered into the inbox and
        return it (non-blocking beyond ``timeout``)."""
        self.sock.settimeout(timeout)
        try:
            while True:
                self._handle_line(self._reader.read_line())
        except (TimeoutError, socket.timeout):
            pass
        finally:
            self.sock.settimeout(None)
        out, self.inbox = self.inbox, []
        return out

    def flush(self) -> None:
        """PING/PONG round trip: everything sent before it is processed."""
        self.sock.settimeout(10.0)
        try:
            self._send(b"PING\r\n")
            self._await_pong()
        finally:
            self.sock.settimeout(None)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class NatsTransport:
    """MessageTransport (engine/storage.py contract) over a live NATS
    connection: SUB for reads, PUB for writes, one subject per
    transport."""

    def __init__(
        self,
        host: str,
        port: int,
        subject: str,
        *,
        token: str | None = None,
        user: str | None = None,
        password: str | None = None,
        subscribe: bool = True,
    ) -> None:
        self.subject = subject
        self.conn = NatsConnection(
            host, port, token=token, user=user, password=password
        )
        if subscribe:
            self.conn.subscribe(subject, sid=1)
            self.conn.flush()  # SUB registered before the first poll
        # write-only transports do NOT subscribe: the server would echo
        # every published message back to this connection, and with
        # nobody draining, the TCP buffers eventually deadlock both ends
        self._offset = 0
        self._closed = False
        self._poll_lock = threading.Lock()

    def produce(self, value: Any, key: Any = None) -> None:
        payload = value if isinstance(value, bytes) else str(value).encode()
        self.conn.publish(self.subject, payload)

    def poll_messages(self) -> list[Message]:
        with self._poll_lock:
            if self._closed:
                return []
            delivered = self.conn.drain()
        out = []
        for subject, _sid, payload in delivered:
            try:
                value: Any = payload.decode("utf-8")
            except UnicodeDecodeError:
                value = payload
            out.append(
                Message(
                    value,
                    key=None,
                    topic=subject,
                    partition=0,
                    offset=self._offset,
                )
            )
            self._offset += 1
        return out

    def finished(self) -> bool:
        return self._closed  # a NATS subject is an endless stream until closed

    def close(self) -> None:
        """End the transport: wait for a poll in flight, then close the connection."""
        with self._poll_lock:
            self._closed = True
            self.conn.close()


# -- fake server -------------------------------------------------------------


class FakeNatsServer:
    """In-process NATS server: real INFO/CONNECT/PING/PUB/SUB/MSG frames,
    subject routing with wildcards, optional token auth."""

    def __init__(self, *, token: str | None = None) -> None:
        self.token = token
        #: every (client_id, verb) frame the server parsed, in order
        self.frames: list[tuple[int, str]] = []
        #: all published payloads by subject (independent of routing)
        self.published: dict[str, list[bytes]] = {}
        #: bytes that crossed the server's sockets, both ways
        self.bytes_received = 0
        self.bytes_sent = 0
        self._lock = threading.Lock()
        #: sid registry: (conn, sid, pattern)
        self._subs: list[tuple[Any, int, str]] = []
        #: conn id -> serialized send fn (one writer lock per connection)
        self._sends: dict[int, Any] = {}
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self._closing = False
        self._next_client = [0]
        #: live sessions: (socket, thread)
        self._sessions: list[tuple[socket.socket, threading.Thread]] = []
        self._thread = threading.Thread(target=self._serve, name="fake-nats", daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop accepting, end every session and join the server's threads."""
        if self._closing:
            return
        self._closing = True
        _close_server(self._srv, self._thread, self._sessions, self._lock)

    def _serve(self) -> None:
        while not self._closing:
            try:
                conn, _addr = self._srv.accept()
            except OSError:
                return
            with self._lock:
                self._next_client[0] += 1
                cid = self._next_client[0]
            thread = threading.Thread(
                target=self._handle, args=(conn, cid), name="fake-nats-session", daemon=True
            )
            with self._lock:
                self._sessions.append((conn, thread))
            thread.start()

    def _handle(self, conn: socket.socket, cid: int) -> None:
        try:
            self._session(conn, cid)
        except (NatsError, OSError, ValueError):
            pass  # disconnects mid-frame are a normal client exit
        finally:
            with self._lock:
                self._subs = [s for s in self._subs if s[0] is not conn]
            conn.close()

    def _session(self, conn: socket.socket, cid: int) -> None:
        info = {
            "server_id": "fake-nats",
            "version": "2.10.0-fake",
            "proto": 1,
            "max_payload": 1 << 20,
            "auth_required": self.token is not None,
        }
        send_lock = threading.Lock()

        def send(data: bytes) -> None:
            with send_lock:
                conn.sendall(data)
            with self._lock:
                self.bytes_sent += len(data)

        with self._lock:
            self._sends[id(conn)] = send
        send(f"INFO {json.dumps(info)}\r\n".encode())
        reader = _LineReader(conn)
        authed = self.token is None
        verbose = False
        while True:
            line = reader.read_line()
            verb = line.split(b" ", 1)[0].decode("ascii", "replace")
            with self._lock:
                self.frames.append((cid, verb))
                self.bytes_received += len(line) + 2
            if verb == "CONNECT":
                options = json.loads(line[8:])
                verbose = bool(options.get("verbose"))
                if self.token is not None:
                    authed = options.get("auth_token") == self.token
                if verbose and authed:
                    send(b"+OK\r\n")
            elif verb == "PING":
                if not authed:
                    send(b"-ERR 'Authorization Violation'\r\n")
                    return
                send(b"PONG\r\n")
            elif verb == "PONG":
                pass
            elif verb == "SUB":
                if not authed:
                    send(b"-ERR 'Authorization Violation'\r\n")
                    return
                parts = line.decode().split(" ")
                pattern, sid = parts[1], int(parts[-1])
                with self._lock:
                    self._subs.append((conn, sid, pattern))
                if verbose:
                    send(b"+OK\r\n")
            elif verb == "UNSUB":
                parts = line.decode().split(" ")
                sid = int(parts[1])
                with self._lock:
                    self._subs = [
                        s
                        for s in self._subs
                        if not (s[0] is conn and s[1] == sid)
                    ]
                if verbose:
                    send(b"+OK\r\n")
            elif verb == "PUB":
                parts = line.decode().split(" ")
                subject = parts[1]
                size = int(parts[-1])
                payload = reader.read_exact(size)
                reader.read_exact(2)  # \r\n
                with self._lock:
                    self.bytes_received += size + 2
                if not authed:
                    send(b"-ERR 'Authorization Violation'\r\n")
                    return
                with self._lock:
                    self.published.setdefault(subject, []).append(payload)
                    subs = list(self._subs)
                    sends = dict(self._sends)
                for target, sid, pattern in subs:
                    if _subject_matches(pattern, subject):
                        frame = (
                            f"MSG {subject} {sid} {size}\r\n".encode()
                            + payload
                            + b"\r\n"
                        )
                        sends[id(target)](frame)
                if verbose:
                    send(b"+OK\r\n")
            else:
                send(b"-ERR 'Unknown Protocol Operation'\r\n")
