"""The PostgreSQL frontend/backend protocol v3: a client and an in-process server.

Counterpart of ``pathway_tpu/io/_pg_wire.py``, speaking the same bytes:

- :class:`PgWireConnection` sends the startup message (after an SSLRequest unless
  ``sslmode="disable"``: an ``S`` answer wraps the socket in TLS, an ``N`` falls back to
  plaintext unless the mode requires TLS) and answers cleartext, MD5 and SCRAM-SHA-256
  authentication. ``execute`` is one Parse / Bind / Execute / Sync round trip of the
  extended protocol with text parameters (:func:`encode_text_param`: NULL as length -1,
  booleans ``t``/``f``, bytes in the ``\\x`` hex form, lists as array literals); the
  first statement after a commit opens a transaction with a simple-query ``BEGIN``, and
  ``commit`` sends ``COMMIT``. A statement error rolls the transaction back and raises.
- :class:`FakePostgresServer` answers the same frames on a local port. It runs the three
  statement shapes the Psql formatters emit (the update log's INSERT, the snapshot's
  INSERT .. ON CONFLICT DO UPDATE, and DELETE by key), stages a transaction's changes
  and applies them at ``COMMIT``: nothing is visible before. A failed statement aborts
  the transaction: later statements are refused and its ``COMMIT`` is a rollback.
  ``close`` closes the listening socket and every session's socket and joins the
  server's threads.

Both ends set ``TCP_NODELAY`` (libpq does): the server answers a statement's four
frames in four writes, which Nagle's algorithm would otherwise hold for the client's
delayed ACK, some 40 ms a statement.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import re
import socket
import struct
import threading
from typing import Any

_PROTOCOL_V3 = 196608
_SSL_REQUEST = 80877103


def _scram_salted_password(password: str, salt: bytes, iters: int) -> bytes:
    return hashlib.pbkdf2_hmac("sha256", password.encode(), salt, iters)


def _hmac256(key: bytes, msg: bytes) -> bytes:
    return hmac.new(key, msg, hashlib.sha256).digest()


def _md5_password(user: str, password: str, salt: bytes) -> str:
    inner = hashlib.md5((password + user).encode()).hexdigest()
    return "md5" + hashlib.md5(inner.encode() + salt).hexdigest()


class PgError(Exception):
    """Server-reported error (ErrorResponse frame) or protocol failure."""


def _frame(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack(">I", len(payload) + 4) + payload


def _cstr(b: str) -> bytes:
    return b.encode("utf-8") + b"\0"


def _error_fields(body: bytes) -> str:
    parts = []
    for chunk in body.split(b"\0"):
        if len(chunk) >= 2 and chunk[:1] in (b"S", b"C", b"M"):
            parts.append(chunk[1:].decode("utf-8", "replace"))
    return ": ".join(parts) if parts else body.decode("utf-8", "replace")


def encode_text_param(v: Any) -> bytes | None:
    """Python value -> postgres text-format parameter (None = SQL NULL).
    bytes use the bytea hex form; lists/tuples the array literal form."""
    if v is None:
        return None
    if isinstance(v, bool):
        return b"t" if v else b"f"
    if isinstance(v, (bytes, bytearray)):
        return b"\\x" + bytes(v).hex().encode()
    if isinstance(v, (list, tuple)):
        items = []
        for item in v:
            if item is None:
                items.append("NULL")
            else:
                s = str(item).replace("\\", "\\\\").replace('"', '\\"')
                items.append(f'"{s}"')
        return ("{" + ",".join(items) + "}").encode("utf-8")
    return str(v).encode("utf-8")


def decode_text_param(b: bytes | None) -> Any:
    """Postgres text-format parameter -> Python value (used by the fake
    server so snapshot keys compare the way a typed database would)."""
    if b is None:
        return None
    s = b.decode("utf-8")
    if s == "t":
        return True
    if s == "f":
        return False
    if s.startswith("\\x"):
        try:
            return bytes.fromhex(s[2:])
        except ValueError:
            pass
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


class _FrameReader:
    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self._buf = b""

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise PgError("connection closed by peer")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def read_message(self) -> tuple[bytes, bytes]:
        head = self._read_exact(5)
        tag = head[:1]
        (length,) = struct.unpack(">I", head[1:5])
        return tag, self._read_exact(length - 4)

    def read_startup(self) -> tuple[int, dict[str, str]]:
        (length,) = struct.unpack(">I", self._read_exact(4))
        body = self._read_exact(length - 4)
        (code,) = struct.unpack(">I", body[:4])
        params: dict[str, str] = {}
        items = body[4:].split(b"\0")
        for k, v in zip(items[::2], items[1::2]):
            if k:
                params[k.decode()] = v.decode()
        return code, params


class PgWireConnection:
    """Wire-level connection with the executor contract PsqlWriter
    expects: ``execute(statement, params)`` + ``commit()`` (+ close)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 5432,
        user: str = "pathway",
        password: str | None = None,
        dbname: str = "pathway",
        connect_timeout: float = 10.0,
        sslmode: str = "prefer",
    ) -> None:
        if sslmode not in ("disable", "prefer", "require", "verify-full"):
            raise PgError(f"unsupported sslmode {sslmode!r}")
        self.sock = socket.create_connection(
            (host, port), timeout=connect_timeout
        )
        # as libpq: a statement's frames go out at once, not held for the ACK of the last
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if sslmode != "disable":
            # SSLRequest: 'S' -> wrap in TLS, 'N' -> plaintext (libpq
            # 'require' errors on refusal, 'prefer' falls back)
            self.sock.sendall(struct.pack(">II", 8, _SSL_REQUEST))
            answer = self.sock.recv(1)
            if answer == b"S":
                import ssl

                ctx = ssl.create_default_context()
                if sslmode != "verify-full":
                    # libpq: only verify-full checks the chain AND the
                    # hostname; require accepts any certificate
                    ctx.check_hostname = False
                    ctx.verify_mode = ssl.CERT_NONE
                self.sock = ctx.wrap_socket(self.sock, server_hostname=host)
            elif answer != b"N":
                raise PgError(f"unexpected SSLRequest answer {answer!r}")
            elif sslmode in ("require", "verify-full"):
                raise PgError(f"server refused SSL but sslmode={sslmode}")
        self._reader = _FrameReader(self.sock)
        self._in_txn = False
        params = (
            _cstr("user")
            + _cstr(user)
            + _cstr("database")
            + _cstr(dbname)
            + _cstr("client_encoding")
            + _cstr("UTF8")
            + b"\0"
        )
        payload = struct.pack(">I", _PROTOCOL_V3) + params
        self.sock.sendall(struct.pack(">I", len(payload) + 4) + payload)
        scram: dict[str, Any] = {}
        while True:
            tag, body = self._reader.read_message()
            if tag == b"R":
                (code,) = struct.unpack(">I", body[:4])
                if code == 0:
                    continue  # AuthenticationOk: wait for ReadyForQuery
                if code in (3, 5, 10, 11, 12) and password is None:
                    raise PgError("server requires a password")
                if code == 3:  # CleartextPassword
                    self.sock.sendall(_frame(b"p", _cstr(password)))
                elif code == 5:  # MD5Password
                    salt = body[4:8]
                    self.sock.sendall(
                        _frame(b"p", _cstr(_md5_password(user, password, salt)))
                    )
                elif code == 10:  # AuthenticationSASL
                    mechanisms = body[4:].split(b"\0")
                    if b"SCRAM-SHA-256" not in mechanisms:
                        raise PgError(
                            f"no supported SASL mechanism in {mechanisms!r}"
                        )
                    nonce = base64.b64encode(os.urandom(18)).decode()
                    first_bare = f"n=,r={nonce}"
                    scram = {"nonce": nonce, "first_bare": first_bare}
                    initial = ("n,," + first_bare).encode()
                    self.sock.sendall(
                        _frame(
                            b"p",
                            _cstr("SCRAM-SHA-256")
                            + struct.pack(">i", len(initial))
                            + initial,
                        )
                    )
                elif code == 11:  # SASLContinue: server-first-message
                    server_first = body[4:].decode()
                    fields = dict(
                        item.split("=", 1)
                        for item in server_first.split(",")
                    )
                    full_nonce = fields["r"]
                    if not full_nonce.startswith(scram["nonce"]):
                        raise PgError("SCRAM nonce mismatch")
                    salt = base64.b64decode(fields["s"])
                    iters = int(fields["i"])
                    salted = _scram_salted_password(password, salt, iters)
                    client_key = _hmac256(salted, b"Client Key")
                    stored_key = hashlib.sha256(client_key).digest()
                    final_bare = f"c=biws,r={full_nonce}"
                    auth_message = ",".join(
                        (scram["first_bare"], server_first, final_bare)
                    ).encode()
                    signature = _hmac256(stored_key, auth_message)
                    proof = bytes(
                        a ^ b for a, b in zip(client_key, signature)
                    )
                    scram["server_sig"] = _hmac256(
                        _hmac256(salted, b"Server Key"), auth_message
                    )
                    final = (
                        final_bare
                        + ",p="
                        + base64.b64encode(proof).decode()
                    ).encode()
                    self.sock.sendall(_frame(b"p", final))
                elif code == 12:  # SASLFinal: verify server signature
                    fields = dict(
                        item.split("=", 1)
                        for item in body[4:].decode().split(",")
                    )
                    expected = base64.b64encode(
                        scram["server_sig"]
                    ).decode()
                    if fields.get("v") != expected:
                        raise PgError("SCRAM server signature mismatch")
                else:
                    raise PgError(f"unsupported auth method {code}")
                continue
            if tag in (b"S", b"K", b"N"):
                continue  # ParameterStatus / BackendKeyData / Notice
            if tag == b"Z":
                break  # ReadyForQuery
            if tag == b"E":
                raise PgError(_error_fields(body))
            raise PgError(f"unexpected startup frame {tag!r}")
        # connect_timeout bounds ONLY establishment + handshake; a slow
        # statement on a loaded server must not desync the stream
        self.sock.settimeout(None)

    # -- query paths --------------------------------------------------------

    def _drain_to_ready(self) -> None:
        error: str | None = None
        while True:
            tag, body = self._reader.read_message()
            if tag == b"Z":
                if error is not None:
                    raise PgError(error)
                return
            if tag == b"E":
                error = _error_fields(body)

    def _simple(self, query: str) -> None:
        self.sock.sendall(_frame(b"Q", _cstr(query)))
        self._drain_to_ready()

    def execute(self, statement: str, params: list) -> None:
        """Extended-protocol round trip: Parse/Bind/Execute/Sync. The
        first statement after a commit opens a transaction, matching the
        reference's per-time batches."""
        if not self._in_txn:
            self._simple("BEGIN")
            self._in_txn = True
        parse = _cstr("") + _cstr(statement) + struct.pack(">H", 0)
        bind = _cstr("") + _cstr("") + struct.pack(">H", 0)
        bind += struct.pack(">H", len(params))
        for p in params:
            enc = encode_text_param(p)
            if enc is None:
                bind += struct.pack(">i", -1)
            else:
                bind += struct.pack(">i", len(enc)) + enc
        bind += struct.pack(">H", 0)  # result formats: all text
        execute = _cstr("") + struct.pack(">i", 0)
        self.sock.sendall(
            _frame(b"P", parse)
            + _frame(b"B", bind)
            + _frame(b"E", execute)
            + _frame(b"S", b"")
        )
        try:
            self._drain_to_ready()
        except PgError as exc:
            # the server aborted the transaction: roll it back, so that a later COMMIT is
            # not a silent rollback and the next execute opens a fresh transaction; the
            # statement's error raises, with a failed rollback as its cause
            self._in_txn = False
            try:
                self._simple("ROLLBACK")
            except (PgError, OSError) as rollback_exc:
                raise exc from rollback_exc
            raise

    def commit(self) -> None:
        if self._in_txn:
            self._simple("COMMIT")
            self._in_txn = False

    def close(self) -> None:
        """Send Terminate and close the socket (a peer that already went away is fine)."""
        try:
            self.sock.sendall(_frame(b"X", b""))
        except OSError:
            pass
        self.sock.close()


# -- fake server -------------------------------------------------------------


def _close_server(
    srv: socket.socket,
    accept_thread: threading.Thread,
    sessions: list,
    lock: threading.Lock,
) -> None:
    """Close a socket server's listening socket and every session's socket, then join
    its accept thread and session threads (shared by the fake servers)."""
    try:
        srv.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass  # not connected: a listening socket on some platforms
    srv.close()
    accept_thread.join()
    with lock:
        live = list(sessions)
        sessions.clear()
    for conn, _thread in live:
        try:
            conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # the session already closed it
    for _conn, thread in live:
        thread.join()

_INSERT_RE = re.compile(
    r"INSERT INTO (\w+) \(([^)]*)\) VALUES \(([^)]*)\)"
    r"(?: ON CONFLICT \(([^)]*)\) DO UPDATE SET .*)?$",
    re.DOTALL,
)
_DELETE_RE = re.compile(r"DELETE FROM (\w+) WHERE (.*)$", re.DOTALL)
_COND_RE = re.compile(r"(?:\w+\.)?(\w+)=\$(\d+)")


class FakePostgresServer:
    """Threaded in-process postgres: real v3 frames, in-memory tables,
    transaction staging (rows visible only after COMMIT)."""

    def __init__(
        self, password: str | None = None, auth: str | None = None
    ) -> None:
        self.password = password
        #: "trust" | "password" | "md5" | "scram-sha-256"
        self.auth = auth or ("password" if password is not None else "trust")
        #: table name -> list of row dicts (committed state)
        self.tables: dict[str, list[dict]] = {}
        #: every statement text the server executed, in order
        self.statements: list[str] = []
        #: frame tags seen, for protocol-shape assertions
        self.frames: list[str] = []
        self.commits = 0
        self._lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self._closing = False
        #: live sessions: (socket, thread)
        self._sessions: list[tuple[socket.socket, threading.Thread]] = []
        self._thread = threading.Thread(target=self._serve, name="fake-postgres", daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop accepting, end every session and join the server's threads."""
        self._closing = True
        _close_server(self._srv, self._thread, self._sessions, self._lock)

    # -- serving ------------------------------------------------------------

    def _serve(self) -> None:
        while not self._closing:
            try:
                conn, _addr = self._srv.accept()
            except OSError:
                return
            # the answers to Parse, Bind, Execute and Sync are four writes: without this,
            # Nagle holds the second until the client's delayed ACK, 40 ms a statement
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            thread = threading.Thread(
                target=self._handle, args=(conn,), name="fake-postgres-session", daemon=True
            )
            with self._lock:
                self._sessions.append((conn, thread))
            thread.start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            self._session(conn)
        except (PgError, OSError):
            pass  # the client went away or broke the protocol: the session ends
        finally:
            conn.close()

    def _session(self, conn: socket.socket) -> None:
        reader = _FrameReader(conn)
        code, params_ = reader.read_startup()
        if code == _SSL_REQUEST:
            conn.sendall(b"N")  # SSL refused; client retries plaintext
            code, params_ = reader.read_startup()
        if code != _PROTOCOL_V3:
            raise PgError(f"unsupported protocol {code}")
        if not self._authenticate(conn, reader, params_.get("user", "")):
            return
        conn.sendall(
            _frame(b"R", struct.pack(">I", 0))
            + _frame(b"S", _cstr("server_version") + _cstr("16.0-fake"))
            + _frame(b"K", struct.pack(">II", 1234, 5678))
            + _frame(b"Z", b"I")
        )
        staged: list = []  # (table, op, payload) applied on COMMIT
        last_stmt = ""
        bound: list = []
        failed = False
        aborted = False  # statement error poisons the transaction
        while True:
            tag, body = reader.read_message()
            with self._lock:
                self.frames.append(tag.decode("ascii", "replace"))
            if tag == b"X":
                return
            if tag == b"Q":
                q = body.rstrip(b"\0").decode()
                with self._lock:
                    self.statements.append(q)
                word = q.split()[0].upper() if q.split() else ""
                if word == "BEGIN":
                    staged.clear()
                    aborted = False
                elif word == "COMMIT":
                    if aborted:
                        # real postgres: COMMIT of an aborted txn is a
                        # rollback (reported as such)
                        word = "ROLLBACK"
                    else:
                        self._apply(staged)
                        with self._lock:
                            self.commits += 1
                    staged.clear()
                    aborted = False
                elif word == "ROLLBACK":
                    staged.clear()
                    aborted = False
                else:
                    try:
                        self._run_sql(q, [], staged)
                    except PgError as exc:
                        conn.sendall(self._err(exc))
                        conn.sendall(_frame(b"Z", b"I"))
                        continue
                conn.sendall(
                    _frame(b"C", _cstr(word or "OK")) + _frame(b"Z", b"I")
                )
            elif tag == b"P":
                name_end = body.index(b"\0")
                rest = body[name_end + 1 :]
                q_end = rest.index(b"\0")
                last_stmt = rest[:q_end].decode()
                failed = False
                conn.sendall(_frame(b"1", b""))
            elif tag == b"B":
                i = body.index(b"\0") + 1  # portal name
                i += body[i:].index(b"\0") + 1  # statement name
                (nfmt,) = struct.unpack(">H", body[i : i + 2])
                i += 2 + 2 * nfmt
                (nparams,) = struct.unpack(">H", body[i : i + 2])
                i += 2
                params = []
                for _ in range(nparams):
                    (plen,) = struct.unpack(">i", body[i : i + 4])
                    i += 4
                    if plen < 0:
                        params.append(None)
                    else:
                        params.append(
                            decode_text_param(body[i : i + plen])
                        )
                        i += plen
                bound = params
                conn.sendall(_frame(b"2", b""))
            elif tag == b"D":
                conn.sendall(_frame(b"n", b""))
            elif tag == b"E":
                with self._lock:
                    self.statements.append(last_stmt)
                if aborted:
                    failed = True
                    conn.sendall(
                        self._err(
                            PgError(
                                "current transaction is aborted, commands "
                                "ignored until end of transaction block"
                            )
                        )
                    )
                    continue
                try:
                    self._run_sql(last_stmt, bound, staged)
                    conn.sendall(_frame(b"C", _cstr("INSERT 0 1")))
                except PgError as exc:
                    failed = True
                    aborted = True
                    conn.sendall(self._err(exc))
            elif tag == b"S":
                conn.sendall(_frame(b"Z", b"E" if failed else b"I"))
                failed = False
            else:
                raise PgError(f"unsupported frame {tag!r}")

    @staticmethod
    def _err(exc: PgError) -> bytes:
        return _frame(
            b"E", b"SERROR\0C42601\0M" + str(exc).encode() + b"\0\0"
        )

    def _auth_failed(self, conn: socket.socket) -> bool:
        conn.sendall(
            _frame(
                b"E",
                b"SFATAL\0C28P01\0Mpassword authentication failed\0\0",
            )
        )
        return False

    def _authenticate(
        self, conn: socket.socket, reader: _FrameReader, user: str
    ) -> bool:
        """Run the configured auth exchange; True = authenticated."""
        if self.auth == "trust":
            return True
        if self.auth == "password":
            conn.sendall(_frame(b"R", struct.pack(">I", 3)))
            tag, body = reader.read_message()
            if tag != b"p" or body.rstrip(b"\0").decode() != self.password:
                return self._auth_failed(conn)
            return True
        if self.auth == "md5":
            salt = os.urandom(4)
            conn.sendall(_frame(b"R", struct.pack(">I", 5) + salt))
            tag, body = reader.read_message()
            expected = _md5_password(user, self.password, salt)
            if tag != b"p" or body.rstrip(b"\0").decode() != expected:
                return self._auth_failed(conn)
            return True
        if self.auth == "scram-sha-256":
            conn.sendall(
                _frame(
                    b"R",
                    struct.pack(">I", 10) + _cstr("SCRAM-SHA-256") + b"\0",
                )
            )
            tag, body = reader.read_message()
            if tag != b"p":
                return self._auth_failed(conn)
            i = body.index(b"\0") + 1  # mechanism name
            (ilen,) = struct.unpack(">i", body[i : i + 4])
            client_first = body[i + 4 : i + 4 + ilen].decode()
            first_bare = client_first.split(",", 2)[2]
            client_nonce = dict(
                item.split("=", 1) for item in first_bare.split(",")
            )["r"]
            salt = os.urandom(16)
            iters = 4096
            full_nonce = (
                client_nonce + base64.b64encode(os.urandom(12)).decode()
            )
            server_first = (
                f"r={full_nonce},s={base64.b64encode(salt).decode()},"
                f"i={iters}"
            )
            conn.sendall(
                _frame(
                    b"R", struct.pack(">I", 11) + server_first.encode()
                )
            )
            tag, body = reader.read_message()
            if tag != b"p":
                return self._auth_failed(conn)
            client_final = body.decode()
            final_bare, proof_b64 = client_final.rsplit(",p=", 1)
            salted = _scram_salted_password(self.password, salt, iters)
            client_key = _hmac256(salted, b"Client Key")
            stored_key = hashlib.sha256(client_key).digest()
            auth_message = ",".join(
                (first_bare, server_first, final_bare)
            ).encode()
            signature = _hmac256(stored_key, auth_message)
            expected_proof = bytes(
                a ^ b for a, b in zip(client_key, signature)
            )
            if base64.b64decode(proof_b64) != expected_proof:
                return self._auth_failed(conn)
            server_sig = _hmac256(
                _hmac256(salted, b"Server Key"), auth_message
            )
            conn.sendall(
                _frame(
                    b"R",
                    struct.pack(">I", 12)
                    + b"v="
                    + base64.b64encode(server_sig),
                )
            )
            return True
        raise PgError(f"unknown auth mode {self.auth!r}")

    # -- statement interpretation -------------------------------------------

    def _run_sql(self, stmt: str, params: list, staged: list) -> None:
        def resolve(item: str) -> Any:
            item = item.strip()
            if item.startswith("$"):
                return params[int(item[1:]) - 1]
            return decode_text_param(item.encode())

        m = _INSERT_RE.match(stmt)
        if m is not None:
            table, cols, vals, conflict = m.groups()
            names = [c.strip() for c in cols.split(",")]
            values = [resolve(v) for v in vals.split(",")]
            if len(names) != len(values):
                raise PgError("column/value arity mismatch")
            row = dict(zip(names, values))
            keys = (
                [k.strip() for k in conflict.split(",")]
                if conflict
                else None
            )
            staged.append(("upsert" if keys else "insert", table, row, keys))
            return
        m = _DELETE_RE.match(stmt)
        if m is not None:
            table, conds = m.groups()
            pairs = _COND_RE.findall(conds)
            if not pairs:
                raise PgError(f"cannot parse DELETE condition {conds!r}")
            match = {
                name: params[int(idx) - 1] for name, idx in pairs
            }
            staged.append(("delete", table, match, None))
            return
        raise PgError(f"unsupported statement {stmt.split()[0]!r}")

    def _apply(self, staged: list) -> None:
        with self._lock:
            for op, table, payload, keys in staged:
                rows = self.tables.setdefault(table, [])
                if op == "insert":
                    rows.append(dict(payload))
                elif op == "upsert":
                    for row in rows:
                        if all(row.get(k) == payload[k] for k in keys):
                            row.update(payload)
                            break
                    else:
                        rows.append(dict(payload))
                else:  # delete
                    rows[:] = [
                        row
                        for row in rows
                        if not all(
                            row.get(k) == v for k, v in payload.items()
                        )
                    ]

    def snapshot(self, table: str) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self.tables.get(table, [])]
