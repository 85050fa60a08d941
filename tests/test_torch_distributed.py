"""Workers in several processes: the port's TCP exchange mesh (``engine/distributed.py``),
``DistributedGraphRunner`` and ``cli spawn``, against the JAX package's.

The pure parts run in-process on seeded inputs in both packages: the PWCF columnar
frame must be byte for byte the JAX package's for every clean dtype kind, with and
without diffs, and decode to the same arrays; the stream frames, the address book and
the transport (three meshes on threads of this process, a forged frame, explicit
addresses) follow the JAX package's ``tests/test_distributed.py``. The spawned cases run
the same programs as that file through the port (``python -m pathway_tpu_torch.cli
spawn``, ``PATHWAY_PROCESSES`` or ``pw.run(processes=N)``) with the port's device
operators asked onto the CPU, and compare process 0's sink, consolidated, with the JAX
package's single-process answer computed in this process. Each mesh runs under a
deadline of its own: the helper kills the whole process group and fails the test when
it passes.
"""

from __future__ import annotations

import csv
import hashlib
import hmac
import json
import os
import pickle
import signal
import socket
import struct
import subprocess
import sys
import textwrap
import threading
import time
import uuid
from collections import Counter

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: one mesh's wall-clock budget in these tests (seconds)
MESH_DEADLINE = 120.0


def _free_port_base(n: int) -> int:
    """A base port such that base..base+n-1 are currently bindable."""
    for _ in range(64):
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        base = probe.getsockname()[1]
        probe.close()
        if base + n >= 65535:
            continue
        ok = True
        for i in range(n):
            s = socket.socket()
            try:
                s.bind(("127.0.0.1", base + i))
            except OSError:
                ok = False
                break
            finally:
                s.close()
        if ok:
            return base
    raise RuntimeError("no free port range found")


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for name in ("PATHWAY_PERSISTENT_STORAGE", "PATHWAY_TPU_FAULT_PLAN", "PATHWAY_TPU_RECOVER",
                 "PATHWAY_PROCESSES", "PATHWAY_THREADS", "PATHWAY_PROCESS_ID",
                 "PATHWAY_TPU_DEVICE_OPS"):
        env.pop(name, None)
    env["PATHWAY_TPU_MESH_TIMEOUT"] = "30"
    return env


def _wait(handles: list[subprocess.Popen], deadline: float) -> list[int]:
    """Wait for every process (each in a session of its own) until ``deadline``; past
    it, kill every process group and fail the test."""
    rcs = []
    try:
        for h in handles:
            rcs.append(h.wait(timeout=max(0.1, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        for h in handles:
            try:
                os.killpg(h.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            h.wait()
        pytest.fail(f"mesh passed its {MESH_DEADLINE:g} s deadline and was killed")
    return rcs


CPU_PREAMBLE = """
    from pathway_tpu_torch.engine import device_ops as _device_ops
    _device_ops.configure(device="cpu")
"""


def _spawn_program(tmp_path, code: str, *, processes: int, threads: int = 1,
                   how: str = "cli") -> None:
    """Run ``code`` as a mesh of ``processes`` x ``threads`` through ``how``: ``cli``
    (``python -m pathway_tpu_torch.cli spawn``), ``env`` (each process started with
    ``PATHWAY_PROCESSES`` / ``PATHWAY_PROCESS_ID`` / ``PATHWAY_FIRST_PORT`` and calling
    ``pw.run()``) or ``kwarg`` (``pw.run(processes=N, threads=T)`` with the id and
    port from the environment)."""
    if how == "kwarg":
        code = code.replace("pw.run(", f"pw.run(processes={processes}, threads={threads}, ")
    prog = tmp_path / "prog.py"
    prog.write_text(textwrap.dedent(CPU_PREAMBLE) + textwrap.dedent(code))
    env = _env()
    base = _free_port_base(processes)
    deadline = time.monotonic() + MESH_DEADLINE
    if how == "cli":
        handles = [subprocess.Popen(
            [sys.executable, "-m", "pathway_tpu_torch.cli", "spawn", "-n", str(processes),
             "-t", str(threads), "--first-port", str(base), sys.executable, str(prog)],
            env=env, cwd=REPO, start_new_session=True)]
    else:
        env.update(PATHWAY_FIRST_PORT=str(base), PATHWAY_RUN_ID=str(uuid.uuid4()),
                   PATHWAY_EXCHANGE_SECRET="test-secret")
        if how == "env":
            env.update(PATHWAY_PROCESSES=str(processes), PATHWAY_THREADS=str(threads))
        handles = [subprocess.Popen([sys.executable, str(prog)],
                                    env=dict(env, PATHWAY_PROCESS_ID=str(pid)), cwd=REPO,
                                    start_new_session=True)
                   for pid in range(processes)]
    assert _wait(handles, deadline) == [0] * len(handles)


def _read_csv(path) -> list[dict]:
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def _consolidated(rows: list[dict], key: str, value: str, cast=float) -> dict:
    """The final state of a sink's update stream (insertions and retractions)."""
    state: dict = {}
    for r in rows:
        k, v, diff = r[key], cast(r[value]), int(r["diff"])
        if diff > 0:
            state[k] = v
        elif state.get(k) == v:
            del state[k]
    return state


def _jax_answer(build) -> dict:
    """``build(jpw)`` returns a table of two columns (key, value): the JAX package's
    single-process state of it, as {key: value}."""
    import pathway_tpu as jpw
    from pathway_tpu.internals.parse_graph import G as JG

    JG.clear()
    try:
        rows, names = jpw.debug.table_to_dicts(build(jpw))
    finally:
        JG.clear()
    return {row[names[0]]: row[names[1]] for row in rows.values()}


# -- the PWCF columnar frame ---------------------------------------------------------

_KINDS = {
    "bool": lambda rng, n: rng.integers(0, 2, n).astype(bool),
    "int64": lambda rng, n: rng.integers(-(1 << 40), 1 << 40, n),
    "int32": lambda rng, n: rng.integers(-1000, 1000, n).astype(np.int32),
    "uint8": lambda rng, n: rng.integers(0, 255, n).astype(np.uint8),
    "uint64": lambda rng, n: rng.integers(0, 1 << 62, n).astype(np.uint64),
    "float64": lambda rng, n: rng.standard_normal(n),
    "float32": lambda rng, n: rng.standard_normal(n).astype(np.float32),
    "unicode": lambda rng, n: np.array([f"w{int(i)}é" for i in rng.integers(0, 999, n)]),
    "datetime": lambda rng, n: rng.integers(0, 1 << 50, n).astype("datetime64[ns]"),
    "timedelta": lambda rng, n: rng.integers(0, 1 << 40, n).astype("timedelta64[us]"),
}


@pytest.mark.parametrize("diffs", [False, True])
@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_pwcf_frame_is_the_reference_s_bytes(kind, diffs):
    """A seeded ``Columns`` of each clean dtype kind (and a two-column mix) encodes to
    the JAX package's bytes, decodes back to the same keys, diffs and arrays in both
    packages, and each package decodes the other's frame alike."""
    from pathway_tpu.engine import distributed as jd
    from pathway_tpu.engine.batch import Columns as JColumns
    from pathway_tpu_torch.engine import distributed as td
    from pathway_tpu_torch.engine.batch import Columns as TColumns

    rng = np.random.default_rng(sorted(_KINDS).index(kind) * 2 + diffs)
    n = 37
    kb = rng.integers(0, 256, (n, 16)).astype(np.uint8)
    cols = [_KINDS[kind](rng, n), rng.integers(0, 9, n)]
    d = rng.choice(np.array([-1, 1]), n).astype(np.int64) if diffs else None
    jframe = jd.encode_columns_frame(JColumns(n, cols, kbytes=kb, diffs=d))
    tframe = td.encode_columns_frame(TColumns(n, cols, kbytes=kb, diffs=d))
    assert tframe is not None and tframe == jframe
    assert tframe[:4] == b"PWCF"
    for frame in (tframe, jframe):
        back = td.decode_columns_frame(frame)
        assert back.n == n and np.array_equal(back.kbytes(), kb)
        assert (back.diffs is None) == (d is None)
        if d is not None:
            assert np.array_equal(back.diffs, d)
        for a, b in zip(back.cols, cols):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_pwcf_refuses_object_columns_and_bad_frames():
    """An object column (a pickled-entry payload: Json, tuples, embeddings) encodes to
    None in both packages; a wrong magic or version raises."""
    from pathway_tpu.engine import distributed as jd
    from pathway_tpu.engine.batch import Columns as JColumns
    from pathway_tpu_torch.engine import distributed as td
    from pathway_tpu_torch.engine.batch import Columns as TColumns

    kb = np.zeros((2, 16), np.uint8)
    obj = np.empty(2, object)
    obj[0], obj[1] = (1, 2), np.ones(3, np.float32)
    for d, cls in ((jd, JColumns), (td, TColumns)):
        assert d.encode_columns_frame(cls(2, [np.arange(2), obj], kbytes=kb)) is None
        assert not d._frame_encodable(cls(2, [obj], kbytes=kb))
    frame = td.encode_columns_frame(TColumns(2, [np.arange(2)], kbytes=kb))
    with pytest.raises(ValueError, match="magic"):
        td.decode_columns_frame(b"XXXX" + frame[4:])
    with pytest.raises(ValueError, match="version"):
        td.decode_columns_frame(frame[:4] + b"\x09" + frame[5:])


# -- stream frames, addresses, the transport -----------------------------------------------


def test_stream_frames_are_the_reference_s_and_authenticated(monkeypatch):
    """A stream frame written by the port is the JAX package's bytes under the same
    secret and reads back in both; a frame under another secret, or longer than
    ``PATHWAY_EXCHANGE_MAX_FRAME``, is refused before it is unpickled."""
    from pathway_tpu.engine import distributed as jd
    from pathway_tpu_torch.engine import distributed as td

    assert td.SNAP_STREAM_KINDS == jd.SNAP_STREAM_KINDS
    frame = ("snap", 3, 17, {"rows": list(range(5))})
    wires = []
    for d in (td, jd):
        a, b = socket.socketpair()
        try:
            d.send_stream_frame(a, frame, b"k1")
            a.shutdown(socket.SHUT_WR)
            wires.append(b.recv(1 << 16))
        finally:
            a.close()
            b.close()
    assert wires[0] == wires[1]
    for d in (td, jd):
        a, b = socket.socketpair()
        try:
            a.sendall(wires[0])
            assert d.recv_stream_frame(b, b"k1") == frame
            a.sendall(wires[0])
            with pytest.raises(ConnectionError, match="HMAC"):
                d.recv_stream_frame(b, b"other")
        finally:
            a.close()
            b.close()
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(">Q", td._MAX_FRAME + 1))
        with pytest.raises(ConnectionError, match="exceeds"):
            td.recv_stream_frame(b, b"k1")
    finally:
        a.close()
        b.close()
    monkeypatch.setenv("PATHWAY_EXCHANGE_SECRET", "s3")
    assert td._mesh_secret() == jd._mesh_secret() == b"s3"
    err = td.PeerLostError("gone", peer=2)
    assert err.peer == 2 and isinstance(err, RuntimeError)


def test_process_addresses_env_overrides_address_book(monkeypatch):
    """``PATHWAY_PROCESS_ADDRESSES`` replaces the 127.0.0.1:first_port+i book, in both
    packages alike."""
    from pathway_tpu.engine.distributed import default_addresses as jaddr
    from pathway_tpu_torch.engine.distributed import default_addresses

    monkeypatch.setenv("PATHWAY_PROCESS_ADDRESSES", "hostA:7001; hostB:7002 ;hostC:7003")
    assert default_addresses(3, 10_000) == jaddr(3, 10_000) == [
        ("hostA", 7001), ("hostB", 7002), ("hostC", 7003)]
    with pytest.raises(ValueError, match="3 hosts for 2"):
        default_addresses(2, 10_000)
    monkeypatch.delenv("PATHWAY_PROCESS_ADDRESSES")
    assert default_addresses(2, 9000) == jaddr(2, 9000) == [("127.0.0.1", 9000), ("127.0.0.1", 9001)]


def _meshes(n: int, first_port: int) -> dict:
    from pathway_tpu_torch.engine.distributed import MeshTransport

    transports: dict = {}
    errors: list = []

    def build(pid: int) -> None:
        try:
            transports[pid] = MeshTransport(pid, n, first_port=first_port)
        except BaseException as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=build, args=(pid,)) for pid in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and len(transports) == n
    return transports


def test_mesh_transport_roundtrip_and_forged_frames(monkeypatch):
    """Three meshes on threads of this process: a broadcast and a round frame go
    through; a frame whose HMAC was made under another secret tears its link down
    before it is unpickled, and the receiver reports the peer lost; ``close`` ends
    the links."""
    from pathway_tpu_torch.engine.distributed import PeerLostError

    monkeypatch.setenv("PATHWAY_EXCHANGE_SECRET", "mesh-secret")
    tr = _meshes(3, _free_port_base(3))
    try:
        tr[0].broadcast(("cmd", "hello-all"))
        assert tr[1].recv(0, timeout=5) == ("cmd", "hello-all")
        assert tr[2].recv(0, timeout=5) == ("cmd", "hello-all")
        tr[2].send(1, ("round", 0, 0, False, [("push", 1, 0, 0, [], True)]))
        frame = tr[1].recv(2, timeout=5)
        assert frame[0] == "round" and frame[4][0][0] == "push"
        tr[2].heartbeat(1)  # absorbed by the receive thread
        with pytest.raises(PeerLostError, match="no frame"):
            tr[1].recv(2, timeout=0.3)
        payload = pickle.dumps(("cmd", "evil"))
        length = struct.pack(">Q", len(payload))
        forged = hmac.new(b"wrong", length + payload, hashlib.sha256).digest()
        tr[2]._socks[0].sendall(length + forged + payload)
        with pytest.raises(PeerLostError, match="disconnected"):
            tr[0].recv(2, timeout=5)
        assert 2 in tr[0].dead_peers
        with pytest.raises(PeerLostError):
            tr[0].raise_if_peer_dead()
    finally:
        for t in tr.values():
            t.close()
    assert all(t._closed for t in tr.values())


def test_mesh_refuses_a_forged_hello(monkeypatch):
    """A dialer whose first frame fails authentication never joins: the listening
    process's handshake raises."""
    from pathway_tpu_torch.engine.distributed import MeshTransport

    monkeypatch.setenv("PATHWAY_EXCHANGE_SECRET", "mesh-secret")
    base = _free_port_base(2)
    errors: list = []

    def listen() -> None:
        try:
            MeshTransport(0, 2, first_port=base)
        except BaseException as exc:  # noqa: BLE001 — checked below
            errors.append(exc)

    t = threading.Thread(target=listen)
    t.start()
    payload = pickle.dumps(("hello", 1))
    length = struct.pack(">Q", len(payload))
    deadline = time.monotonic() + 10
    while True:
        try:
            sock = socket.create_connection(("127.0.0.1", base), timeout=5)
            break
        except OSError:
            assert time.monotonic() < deadline
            time.sleep(0.05)
    sock.sendall(length + hmac.new(b"forged", length + payload, hashlib.sha256).digest() + payload)
    t.join(timeout=30)
    sock.close()
    assert errors and "HMAC" in str(errors[0])


def test_mesh_over_explicit_addresses(monkeypatch):
    """The mesh dials the address book, not ``first_port``."""
    base = _free_port_base(2)
    monkeypatch.setenv("PATHWAY_PROCESS_ADDRESSES", f"127.0.0.1:{base};127.0.0.1:{base + 1}")
    tr = _meshes(2, 55555)
    try:
        tr[0].send(1, ("cmd", "over-addresses"))
        assert tr[1].recv(0, timeout=5) == ("cmd", "over-addresses")
        assert tr[1]._addrs == [("127.0.0.1", base), ("127.0.0.1", base + 1)]
    finally:
        for t in tr.values():
            t.close()


def test_spawn_exit_codes_as_the_reference(tmp_path, monkeypatch):
    """``spawn`` returns 0, a failing process's code, or 128 + signal, as the JAX
    package's does; ``spawn-from-env`` reads the command from ``PATHWAY_SPAWN_ARGS``."""
    from pathway_tpu.cli import spawn as jspawn
    from pathway_tpu_torch.cli import main, spawn

    prog = tmp_path / "p.py"
    prog.write_text(textwrap.dedent("""
        import os, signal, sys
        pid = int(os.environ["PATHWAY_PROCESS_ID"])
        assert os.environ["PATHWAY_PROCESSES"] == "2" and os.environ["PATHWAY_EXCHANGE_SECRET"]
        mode = sys.argv[1]
        if mode == "fail" and pid == 1:
            sys.exit(3)
        if mode == "kill" and pid == 1:
            os.kill(os.getpid(), signal.SIGKILL)
    """))
    env = _env()
    for mode, rc in (("ok", 0), ("fail", 3), ("kill", 128 + 9)):
        args = [str(prog), mode]
        assert spawn(sys.executable, args, processes=2, env=env) == rc
        assert jspawn(sys.executable, args, processes=2, env=env) == rc
    monkeypatch.setenv("PATHWAY_SPAWN_ARGS", f"-n 2 {sys.executable} {prog} fail")
    assert main(["spawn-from-env"]) == 3
    monkeypatch.delenv("PATHWAY_SPAWN_ARGS")
    assert main(["spawn-from-env"]) == 2


# -- spawned meshes against the JAX package's single-process answers -------------------

WORDCOUNT = """
    import pathway_tpu_torch as pw

    words = pw.io.csv.read({indir!r}, schema=pw.schema_from_types(word=str), mode="static")
    counts = words.groupby(pw.this.word).reduce(word=pw.this.word, count=pw.reducers.count())
    pw.io.csv.write(counts, {out!r})
    pw.run()
"""


@pytest.mark.parametrize("processes,threads,how", [(3, 1, "cli"), (2, 2, "cli"),
                                                   (2, 1, "env"), (2, 2, "kwarg")])
def test_spawn_wordcount_matches_single_process(tmp_path, processes, threads, how):
    """The word count of ``tests/test_distributed.py`` over 400 seeded words, run as a
    mesh through each entry point: process 0's sink, consolidated, equals the JAX
    package's single-process counts and ``Counter``'s."""
    rng = np.random.default_rng(processes * 10 + threads)
    words = [f"w{int(i)}" for i in rng.integers(0, 17, 400)]
    indir = tmp_path / "in"
    indir.mkdir()
    (indir / "words.csv").write_text("word\n" + "".join(f"{w}\n" for w in words))
    out = tmp_path / "out.csv"
    _spawn_program(tmp_path, WORDCOUNT.format(indir=str(indir), out=str(out)),
                   processes=processes, threads=threads, how=how)
    got = _consolidated(_read_csv(out), "word", "count", int)

    def build(jpw):
        t = jpw.debug.table_from_rows(jpw.schema_from_types(word=str), [(w,) for w in words])
        return t.groupby(t.word).reduce(word=t.word, count=jpw.reducers.count())

    assert got == _jax_answer(build) == dict(Counter(words))


JOIN_PIPELINE = """
    import pathway_tpu_torch as pw

    orders = pw.io.csv.read({orders!r},
        schema=pw.schema_from_types(oid=int, cust=str, amount=float), mode="static")
    names = pw.io.csv.read({names!r}, schema=pw.schema_from_types(cust=str, name=str),
        mode="static")
    joined = orders.join(names, pw.left.cust == pw.right.cust).select(
        name=pw.right.name, amount=pw.left.amount)
    totals = joined.groupby(pw.this.name).reduce(
        name=pw.this.name, total=pw.reducers.sum(pw.this.amount))
    pw.io.csv.write(totals, {out!r})
    pw.run()
"""


def test_spawn_join_groupby(tmp_path):
    """A join then a groupby sum over 3 processes: process 0's totals equal the JAX
    package's single-process totals on the same rows, bit for bit."""
    rng = np.random.default_rng(7)
    orders = [(i, f"c{int(rng.integers(0, 7))}", float(rng.integers(0, 1000)) / 8)
              for i in range(120)]
    (tmp_path / "orders").mkdir()
    (tmp_path / "names").mkdir()
    (tmp_path / "orders" / "o.csv").write_text(
        "oid,cust,amount\n" + "".join(f"{o},{c},{a!r}\n" for o, c, a in orders))
    (tmp_path / "names" / "n.csv").write_text(
        "cust,name\n" + "".join(f"c{j},name{j}\n" for j in range(7)))
    out = tmp_path / "out.csv"
    _spawn_program(tmp_path, JOIN_PIPELINE.format(orders=str(tmp_path / "orders"),
                                                  names=str(tmp_path / "names"), out=str(out)),
                   processes=3)
    got = _consolidated(_read_csv(out), "name", "total")

    def build(jpw):
        o = jpw.debug.table_from_rows(
            jpw.schema_from_types(oid=int, cust=str, amount=float), orders)
        n = jpw.debug.table_from_rows(jpw.schema_from_types(cust=str, name=str),
                                      [(f"c{j}", f"name{j}") for j in range(7)])
        j = o.join(n, jpw.left.cust == jpw.right.cust).select(
            name=jpw.right.name, amount=jpw.left.amount)
        return j.groupby(j.name).reduce(name=j.name, total=jpw.reducers.sum(j.amount))

    assert got == _jax_answer(build)


STREAMING_UPSERTS = """
    import pathway_tpu_torch as pw

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for commit in range(5):
                for i in range(20):
                    key = commit * 20 + i
                    self.next(k=key % 30, v=float(key))
                self.commit()

    t = pw.io.python.read(Feed(), schema=pw.schema_from_types(k=int, v=float),
                          autocommit_duration_ms=None)
    latest = t.groupby(pw.this.k).reduce(k=pw.this.k, latest=pw.reducers.max(pw.this.v))
    pw.io.csv.write(latest, {out!r})
    pw.run()
"""


def test_spawn_streaming_retractions(tmp_path):
    """Streamed commits retract superseded maxima across a 2-process mesh: the final
    state equals the JAX package's single-process answer over the same rows."""
    out = tmp_path / "out.csv"
    _spawn_program(tmp_path, STREAMING_UPSERTS.format(out=str(out)), processes=2)
    got = {int(k): v for k, v in _consolidated(_read_csv(out), "k", "latest").items()}
    rows = [(key % 30, float(key)) for key in range(100)]

    def build(jpw):
        t = jpw.debug.table_from_rows(jpw.schema_from_types(k=int, v=float), rows)
        return t.groupby(t.k).reduce(k=t.k, latest=jpw.reducers.max(t.v))

    assert got == _jax_answer(build)


PERSISTENT_WORDCOUNT = """
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.persistence import Backend, Config, PersistenceMode

    words = pw.io.plaintext.read({indir!r}, mode="static", persistent_id="w")
    counts = words.groupby(words.data).reduce(word=words.data, cnt=pw.reducers.count())
    pw.io.jsonlines.write(counts, {out!r})
    pw.run(persistence_config=Config(Backend.filesystem({store!r}),
                                     persistence_mode=PersistenceMode.PERSISTING))
"""


def test_spawn_with_journal_persistence_resumes(tmp_path):
    """Input-journal persistence on process 0 of a 2-process mesh: the second run
    replays the journal and reads only the new file; its final counts equal the JAX
    package's single-process counts over both files."""
    indir = tmp_path / "in"
    indir.mkdir()
    first, second = ["apple", "banana", "apple"], ["banana", "cherry"]
    (indir / "a.txt").write_text("\n".join(first) + "\n")
    store = tmp_path / "store"
    finals = []
    for run, name in enumerate(("out1.jsonl", "out2.jsonl")):
        if run:
            (indir / "b.txt").write_text("\n".join(second) + "\n")
        out = tmp_path / name
        _spawn_program(tmp_path, PERSISTENT_WORDCOUNT.format(
            indir=str(indir), out=str(out), store=str(store)), processes=2)
        rows = [json.loads(line) for line in out.read_text().splitlines() if line.strip()]
        finals.append(_consolidated(rows, "word", "cnt", int))

    def build(words):
        def b(jpw):
            t = jpw.debug.table_from_rows(jpw.schema_from_types(data=str), [(w,) for w in words])
            return t.groupby(t.data).reduce(word=t.data, cnt=jpw.reducers.count())
        return b

    assert finals[0] == _jax_answer(build(first))
    assert finals[1] == _jax_answer(build(first + second))


SLOW_STREAM = """
    import time
    import pathway_tpu_torch as pw

    class Feed(pw.io.python.ConnectorSubject):
        def run(self):
            for commit in range(60):
                for i in range(5):
                    self.next(k=(commit * 5 + i) % 10, v=float(commit))
                self.commit()
                time.sleep(0.2)

    t = pw.io.python.read(Feed(), schema=pw.schema_from_types(k=int, v=float),
                          autocommit_duration_ms=None)
    agg = t.groupby(pw.this.k).reduce(k=pw.this.k, s=pw.reducers.sum(pw.this.v))
    pw.io.csv.write(agg, {out!r})
    pw.run()
"""


def test_peer_kill_fail_stops_coordinator(tmp_path):
    """SIGKILL a follower mid-stream without recovery: the coordinator fail-stops
    promptly with ``PeerLostError`` (exit code 1, as the JAX package's coordinator)
    and leaves only complete rows in its sink."""
    prog = tmp_path / "prog.py"
    out = tmp_path / "out.csv"
    prog.write_text(textwrap.dedent(CPU_PREAMBLE) + textwrap.dedent(SLOW_STREAM.format(out=str(out))))
    env = _env()
    env.update(PATHWAY_THREADS="1", PATHWAY_PROCESSES="2",
               PATHWAY_FIRST_PORT=str(_free_port_base(2)), PATHWAY_RUN_ID=str(uuid.uuid4()),
               PATHWAY_EXCHANGE_SECRET="test-secret", PATHWAY_EXCHANGE_TIMEOUT="20")
    env.pop("PATHWAY_TPU_MESH_TIMEOUT")
    handles = [subprocess.Popen([sys.executable, str(prog)], env=dict(env, PATHWAY_PROCESS_ID=str(p)),
                                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                start_new_session=True) for p in range(2)]
    deadline = time.monotonic() + MESH_DEADLINE
    try:
        while not (out.exists() and len(out.read_text().splitlines()) > 3):
            assert all(h.poll() is None for h in handles), "a process died before the kill"
            assert time.monotonic() < deadline, "the pipeline produced no output to kill over"
            time.sleep(0.2)
        handles[1].send_signal(signal.SIGKILL)
        t0 = time.monotonic()
        rc = _wait(handles[:1], min(deadline, t0 + 30))[0]
        assert rc == 1 and time.monotonic() - t0 < 15
        assert b"PeerLostError" in handles[0].stderr.read()
        for r in _read_csv(out):
            float(r["s"])
            int(r["diff"])
    finally:
        for h in handles:
            if h.poll() is None:
                os.killpg(h.pid, signal.SIGKILL)
                h.wait()
