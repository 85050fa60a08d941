"""The port's fault-tolerant mesh (``engine/faults.py``, ``engine/supervisor.py``, the
recovery protocol of ``engine/distributed.py`` and ``DistributedGraphRunner``, the
snapshot ring, ``reshard_process_snapshots`` and ``cli rescale``) against the JAX
package's.

The pure parts run in-process in both packages on the same inputs: a fault plan
makes the same decisions for the same seed and frames, the mesh knobs give the same
warning codes, the fence, the election and the re-sharding move the same keys. The
chaos cases spawn the port's streaming word count (``pw.io.plaintext.read`` ->
groupby count -> ``pw.io.csv.write``) over 2 processes under
``OPERATOR_PERSISTING``, paced one file a commit as ``tests/test_fault_tolerance.py``
paces the JAX package's (file k is written only after file k-1's rows reach the
sink, so every run sees the same commit boundaries). A faulted, failed-over or
rescaled run's canonical sink (its lines sorted: each is a row, its commit time and
its diff) must equal the fault-free run's, and its final counts the JAX package's
single-process answer over the same words. Each mesh runs under a deadline of its
own: the helper kills the whole process group and fails the test when it passes.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: one mesh's wall-clock budget in these tests (seconds)
MESH_DEADLINE = 150.0


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


def _env(extra: dict | None = None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for name in ("PATHWAY_PERSISTENT_STORAGE", "PATHWAY_TPU_FAULT_PLAN", "PATHWAY_TPU_RECOVER",
                 "PATHWAY_TPU_SUPERVISOR_DIR", "PATHWAY_PROCESSES", "PATHWAY_THREADS",
                 "PATHWAY_TPU_DEVICE_OPS"):
        env.pop(name, None)
    env["PATHWAY_TPU_MESH_TIMEOUT"] = "30"
    env["PATHWAY_TPU_RECOVER_DEADLINE"] = "45"
    env.update(extra or {})
    return env


class _Mesh:
    """``python -m pathway_tpu_torch.cli spawn`` in a session of its own, so the
    deadline can kill the CLI, the supervisor and every worker at once."""

    def __init__(self, prog, processes: int, env: dict, port_span: int | None = None):
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "pathway_tpu_torch.cli", "spawn", "-n", str(processes),
             "-t", "1", "--first-port", str(_free_port_base(port_span or processes)),
             sys.executable, str(prog)],
            env=env, cwd=REPO, start_new_session=True,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        )

    def remaining(self) -> float:
        return MESH_DEADLINE - (time.monotonic() - self.t0)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()

    def wait(self) -> int:
        try:
            return self.proc.wait(timeout=max(0.1, self.remaining()))
        except subprocess.TimeoutExpired:
            self.kill()
            pytest.fail(f"mesh passed its {MESH_DEADLINE:g} s deadline and was killed")


CHAOS_PROGRAM = """
    import os
    import pathway_tpu_torch as pw
    import pathway_tpu_torch.engine.connectors as _conn
    from pathway_tpu_torch.engine import device_ops
    from pathway_tpu_torch.persistence import Backend, Config, PersistenceMode

    device_ops.configure(device="cpu")
    _orig_poll = _conn.FsReader.poll
    def _poll(self):
        entries, done = _orig_poll(self)
        if not entries and os.path.exists({stop!r}):
            done = True
        return entries, done
    _conn.FsReader.poll = _poll

    words = pw.io.plaintext.read({indir!r}, mode="streaming", persistent_id="w")
    counts = words.groupby(words.data).reduce(word=words.data, cnt=pw.reducers.count())
    pw.io.csv.write(counts, {out!r})
    pw.run(persistence_config=Config(
        Backend.filesystem({store!r}),
        persistence_mode=PersistenceMode.OPERATOR_PERSISTING,
    ))
    if os.environ.get("PATHWAY_PROCESS_ID") == "0":
        from pathway_tpu_torch.internals import metrics as _m
        with open({metrics_out!r}, "w") as fh:
            fh.write(_m.render_snapshots({{"": _m.full_snapshot()}}))
"""


def _chaos_words(n_files: int) -> list[list[str]]:
    return [[f"w{k}_{i}" for i in range(3)] + ["common"] for k in range(n_files)]


def _run_chaos(tmp_path, tag: str, *, processes: int = 2, n_files: int = 5,
               extra_env: dict | None = None, mid=None, port_span: int | None = None):
    """Spawn the chaos program, feed one file a commit, stop the stream and return
    (sink bytes, the leader's metrics exposition). ``mid=(k, fn)`` calls ``fn()``
    once file k reached the sink."""
    indir = tmp_path / f"in-{tag}"
    indir.mkdir()
    out = tmp_path / f"out-{tag}.csv"
    stop = tmp_path / f"stop-{tag}"
    metrics_out = tmp_path / f"metrics-{tag}.txt"
    prog = tmp_path / f"prog-{tag}.py"
    prog.write_text(textwrap.dedent(CHAOS_PROGRAM.format(
        indir=str(indir), out=str(out), store=str(tmp_path / f"store-{tag}"),
        stop=str(stop), metrics_out=str(metrics_out),
    )))
    mesh = _Mesh(prog, processes, _env(extra_env), port_span)
    try:
        for k, lines in enumerate(_chaos_words(n_files)):
            (indir / f"f{k}.txt").write_text("\n".join(lines) + "\n")
            while not (out.exists() and f"w{k}_0" in out.read_text()):
                if not mesh.alive():
                    pytest.fail(f"mesh exited (rc={mesh.proc.returncode}) before file {k} "
                                f"committed: {mesh.proc.stderr.read().decode()[-2000:]}")
                if mesh.remaining() <= 0:
                    mesh.kill()
                    pytest.fail(f"file {k} never reached the sink within the deadline")
                time.sleep(0.05)
            if mid is not None and k == mid[0]:
                mid[1]()
        stop.write_text("")
        rc = mesh.wait()
    finally:
        stop.write_text("")
        if mesh.alive():
            mesh.kill()
    assert rc == 0, f"mesh exited rc={rc}: {mesh.proc.stderr.read().decode()[-3000:]}"
    return out.read_bytes(), metrics_out.read_text() if metrics_out.exists() else ""


def _canonical(sink: bytes) -> list[bytes]:
    """The sink's lines sorted: the multiset of timestamped deltas (the order of rows
    within a commit is the peers' arrival order)."""
    return sorted(sink.splitlines())


def _final_counts(sink: bytes) -> dict[str, int]:
    state: dict[str, int] = {}
    for line in sink.decode().splitlines()[1:]:
        word, cnt, _time, diff = line.split(",")
        if int(diff) > 0:
            state[word] = int(cnt)
        elif state.get(word) == int(cnt):
            del state[word]
    return state


def _jax_counts(n_files: int) -> dict[str, int]:
    """The JAX package's single-process word count over the same words."""
    import pathway_tpu as jpw
    from pathway_tpu.internals.parse_graph import G as JG

    JG.clear()
    rows = [(w,) for lines in _chaos_words(n_files) for w in lines]
    t = jpw.debug.table_from_rows(jpw.schema_from_types(data=str), rows)
    counts = t.groupby(t.data).reduce(word=t.data, cnt=jpw.reducers.count())
    rows_by_key, _names = jpw.debug.table_to_dicts(counts)
    JG.clear()
    return {row["word"]: row["cnt"] for row in rows_by_key.values()}


def _metric_total(text: str, family: str) -> float:
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith(family) and not line.startswith("#"))


@pytest.fixture(scope="module")
def chaos_baseline(tmp_path_factory):
    """One fault-free 2-process run, the oracle of every chaos case here (the pacing
    pins each file to one commit, and the timestamped deltas do not depend on the
    process count). Its final counts equal the JAX package's single-process answer
    and NumPy's ``np.unique``."""
    sink, _ = _run_chaos(tmp_path_factory.mktemp("chaos-baseline"), "baseline")
    counts = _final_counts(sink)
    assert counts == _jax_counts(5)
    words, n = np.unique([w for f in _chaos_words(5) for w in f], return_counts=True)
    assert counts == dict(zip(words.tolist(), n.tolist()))
    return _canonical(sink)


def test_kill_one_worker_recovers_bit_identical(tmp_path, chaos_baseline):
    """A fault plan SIGKILLs process 1 at commit 3: the supervisor restarts it, the
    mesh rolls back to its snapshot, and the canonical sink equals the fault-free
    run's, with a completed recovery on the leader's metrics and the recovery's
    lifecycle in the flight dumps (the JAX package's
    ``test_kill_one_worker_recovers_bit_identical``)."""
    flight = tmp_path / "flight"
    flight.mkdir()
    plan = json.dumps({"seed": 7, "faults": [{"type": "kill", "process": 1, "at_commit": 3}]})
    faulted, metrics_text = _run_chaos(tmp_path, "faulted", extra_env={
        "PATHWAY_TPU_RECOVER": "1", "PATHWAY_TPU_FAULT_PLAN": plan,
        "PATHWAY_TPU_FLIGHT_DIR": str(flight),
    })
    assert _canonical(faulted) == chaos_baseline
    assert _metric_total(metrics_text, "pathway_mesh_recoveries_total") >= 1
    merged = "".join(p.read_text() for p in flight.glob("pathway_flight_*.json"))
    assert "peer_dead" in merged and "recovery_done" in merged


def test_leader_kill_fails_over_bit_identical(tmp_path, chaos_baseline):
    """SIGKILL the leader at commit 3: the survivor is elected interim leader, the
    restarted process 0 rejoins above its epoch, and the canonical sink equals the
    fault-free run's (the JAX package's ``test_leader_kill_fails_over_bit_identical``
    at 2 processes)."""
    flight = tmp_path / "flight-leader"
    flight.mkdir()
    plan = json.dumps({"seed": 13, "faults": [{"type": "kill", "process": 0, "at_commit": 3}]})
    faulted, metrics_text = _run_chaos(tmp_path, "leaderkill", extra_env={
        "PATHWAY_TPU_RECOVER": "1", "PATHWAY_TPU_MAX_RESTARTS": "4",
        "PATHWAY_TPU_FAULT_PLAN": plan, "PATHWAY_TPU_FLIGHT_DIR": str(flight),
    })
    assert _canonical(faulted) == chaos_baseline
    assert _metric_total(metrics_text, "pathway_mesh_epoch") >= 1
    merged = "".join(p.read_text() for p in flight.glob("pathway_flight_*.json"))
    for event in ("leader_dead", "election_done", "leader_failover_done"):
        assert event in merged


def test_rescale_scale_out_bit_identical(tmp_path, chaos_baseline):
    """A live 2 -> 3 rescale through ``cli rescale`` after file 2: the supervisor
    quiesces the mesh, a helper re-shards the snapshots, the mesh relaunches at 3, and
    the canonical sink equals the uninterrupted run's, with the rescale on the
    leader's metrics (the JAX package's ``test_rescale_scale_out_bit_identical``)."""
    from pathway_tpu_torch.cli import rescale as cli_rescale

    sup_dir = tmp_path / "sup-out"

    def request():
        assert cli_rescale(3, supervisor_dir=str(sup_dir)) == 0

    resized, metrics_text = _run_chaos(tmp_path, "scaleout", port_span=3, extra_env={
        "PATHWAY_TPU_RECOVER": "1", "PATHWAY_TPU_SUPERVISOR_DIR": str(sup_dir),
    }, mid=(2, request))
    assert _canonical(resized) == chaos_baseline
    assert _metric_total(metrics_text, "pathway_mesh_rescales_total") >= 1


# -- the fault plan ----------------------------------------------------------


@pytest.mark.parametrize("pkg", ["pathway_tpu", "pathway_tpu_torch"])
def test_fault_plan_parsing(monkeypatch, tmp_path, pkg):
    """Inline JSON, a file, bad JSON and an unknown type, in both packages."""
    import importlib

    faults = importlib.import_module(f"{pkg}.engine.faults")
    monkeypatch.setenv("PATHWAY_TPU_FAULT_PLAN",
                       '{"seed": 5, "faults": [{"type": "kill", "process": 1, "at_commit": 2}]}')
    faults.reset_plan()
    plan = faults.FaultPlan.from_env()
    assert plan is not None and plan.seed == 5 and plan.faults[0].type == "kill"
    assert faults.active_plan() is faults.active_plan()
    plan_file = tmp_path / "plan.json"
    plan_file.write_text('{"faults": [{"type": "drop", "process": 0}]}')
    monkeypatch.setenv("PATHWAY_TPU_FAULT_PLAN", str(plan_file))
    assert faults.FaultPlan.from_env().faults[0].type == "drop"
    monkeypatch.setenv("PATHWAY_TPU_FAULT_PLAN", "{not json")
    with pytest.raises(ValueError, match="not valid JSON"):
        faults.FaultPlan.from_env()
    with pytest.raises(ValueError, match="unknown fault type"):
        faults.FaultPlan({"faults": [{"type": "melt", "process": 0}]})
    monkeypatch.delenv("PATHWAY_TPU_FAULT_PLAN")
    faults.reset_plan()
    assert faults.active_plan() is None


def test_fault_plan_decisions_match_the_reference(monkeypatch):
    """The same plan and seed make the same ``on_send`` decisions on the same frames
    (drops, dups, resets after n sends, delays with the seeded jitter) in both
    packages, and the wildcard process matches every worker."""
    from pathway_tpu.engine import faults as jf
    from pathway_tpu_torch.engine import faults as tf

    spec = {"seed": 11, "faults": [
        {"type": "drop", "process": 1, "peer": 0, "kind": "hb", "count": 2},
        {"type": "dup", "process": "*", "kind": "round", "count": 3},
        {"type": "reset", "process": 2, "peer": 1, "after_sends": 4},
        {"type": "delay", "process": 1, "kind": "cmd", "count": 2, "ms": 0.01},
    ]}
    rng = np.random.default_rng(0)
    kinds = ["hb", "round", "cmd", "sync"]
    frames = [(int(rng.integers(0, 3)), int(rng.integers(0, 3)),
               (kinds[int(rng.integers(0, 4))], int(rng.integers(0, 9)))) for _ in range(200)]
    sleeps: list[float] = []
    monkeypatch.setattr(jf._walltime, "sleep", sleeps.append)
    jplan = jf.FaultPlan(spec)
    jout = [jplan.on_send(p, peer, f) for p, peer, f in frames]
    jsleeps, sleeps[:] = list(sleeps), []
    monkeypatch.setattr(tf._walltime, "sleep", sleeps.append)
    tplan = tf.FaultPlan(spec)
    tout = [tplan.on_send(p, peer, f) for p, peer, f in frames]
    assert tout == jout and sleeps == jsleeps
    assert {"drop", "dup", "reset"} <= set(tout) and len(sleeps) == 2
    assert [f.count for f in tplan.faults] == [f.count for f in jplan.faults]
    wild = tf.FaultPlan({"faults": [{"type": "kill", "process": "all", "at_commit": 2}]})
    assert wild.faults[0].process == -1 and wild.faults[0].matches_process(7)


@pytest.mark.parametrize("pkg", ["pathway_tpu", "pathway_tpu_torch"])
def test_fault_plan_restart_credit(monkeypatch, pkg):
    """A restarted worker re-parses the plan; ``PATHWAY_TPU_RESTART_COUNT`` marks its
    kill as fired already, or every incarnation would kill itself again (the call
    would SIGKILL this test process without the credit)."""
    import importlib

    faults = importlib.import_module(f"{pkg}.engine.faults")
    monkeypatch.setenv("PATHWAY_TPU_RESTART_COUNT", "1")
    plan = faults.FaultPlan({"faults": [{"type": "kill", "process": 1, "at_commit": 2}]})
    plan.on_commit(1, 1)  # before the commit: nothing
    assert plan.faults[0].count == 1
    plan.on_commit(1, 2)
    plan.on_commit(1, 3)
    assert plan.faults[0].count == 0


# -- the mesh's knobs and control helpers ----------------------------------------


def test_mesh_knobs_warn_as_the_reference(monkeypatch):
    """PWF001 (a send-retry backoff ceiling at or past the suspicion timeout), the
    ceiling's values and the knob validation errors, in both packages."""
    from pathway_tpu.engine import distributed as jd
    from pathway_tpu_torch.engine import distributed as td

    monkeypatch.setenv("PATHWAY_TPU_MESH_SUSPICION", "1")
    monkeypatch.setenv("PATHWAY_TPU_MESH_SEND_RETRIES", "4")
    for d in (jd, td):
        with pytest.warns(d.MeshConfigWarning, match="PWF001"):
            found = d.validate_mesh_knobs(_force=True)
        assert [w.code for w in found] == ["PWF001"] and "suspicion" in str(found[0])
    monkeypatch.setenv("PATHWAY_TPU_MESH_SUSPICION", "60")
    monkeypatch.setenv("PATHWAY_TPU_MESH_SEND_RETRIES", "2")
    assert jd.validate_mesh_knobs(_force=True) == td.validate_mesh_knobs(_force=True) == []
    for n in range(8):
        assert td.retry_backoff_ceiling_s(n) == jd.retry_backoff_ceiling_s(n)
    assert td.retry_backoff_ceiling_s(0) == 0.0
    assert td.retry_backoff_ceiling_s(3) > td.retry_backoff_ceiling_s(1) > 0.0
    monkeypatch.setenv("PATHWAY_TPU_MESH_TIMEOUT", "2.5")
    assert td._validated_float("PATHWAY_TPU_MESH_TIMEOUT", 600.0, 0.001) == 2.5
    for bad in ("banana", "-3", "inf"):
        monkeypatch.setenv("PATHWAY_TPU_MESH_TIMEOUT", bad)
        for d in (jd, td):
            with pytest.raises(ValueError, match="PATHWAY_TPU_MESH_TIMEOUT"):
                d._validated_float("PATHWAY_TPU_MESH_TIMEOUT", 600.0, 0.001)
    monkeypatch.setenv("PATHWAY_TPU_MESH_QUEUE_HWM", "0")
    with pytest.raises(ValueError, match="must be >= 1"):
        td._validated_int("PATHWAY_TPU_MESH_QUEUE_HWM", 512, 1)


def test_epoch_fence_and_election_as_the_reference():
    """The fence admits a kind's epoch once and tracks its floor per kind; the election
    picks the lowest live rank and refuses an empty mesh; in both packages, a fenced
    frame counted on ``pathway_mesh_fenced_frames_total``."""
    from pathway_tpu.engine import distributed as jd
    from pathway_tpu_torch.engine import distributed as td
    from pathway_tpu_torch.internals import metrics as tm

    steps = [("rollback", 0), ("rollback", 0), ("rollback", -1), ("rollback", 3),
             ("elect", 1), ("recover", 2), ("elect", 1), ("recover", 5), ("rollback", 2)]
    fenced = tm.REGISTRY.counter("pathway_mesh_fenced_frames_total",
                                 "stale epoch-stamped control frames rejected by fencing")
    before = fenced.value
    for d in (jd, td):
        fence = d.EpochFence()
        assert fence.floor("rollback") == -1
        got = [fence.admit(k, e) for k, e in steps]
        assert got == [True, False, False, True, True, True, False, True, False]
        assert (fence.floor("rollback"), fence.floor("elect"), fence.floor("recover")) == (3, 1, 5)
        for survivors in ({2, 1, 3}, [5], (4, 9)):
            assert d.elect_leader(survivors) == min(survivors)
        with pytest.raises(ValueError, match="empty mesh"):
            d.elect_leader(set())
    assert fenced.value - before == 4


def test_mesh_metric_families_render_one_help_block_each():
    """The mesh's families (epoch, rescales, elections, fenced frames, recoveries and
    the two histograms) each render one HELP and one TYPE block on the port's
    exposition."""
    from pathway_tpu_torch.internals import metrics as m

    m.REGISTRY.gauge("pathway_mesh_epoch", "current mesh epoch").set(2)
    for name in ("pathway_mesh_rescales_total", "pathway_mesh_elections_total",
                 "pathway_mesh_fenced_frames_total", "pathway_mesh_recoveries_total"):
        m.REGISTRY.counter(name, "mesh events").inc(1)
    m.REGISTRY.histogram("pathway_mesh_election_seconds", "election wall time",
                         buckets=(0.01, 0.05, 0.1, 0.5, 1, 5, 15, 60)).observe(0.02)
    m.REGISTRY.histogram("pathway_mesh_rescale_seconds", "rescale wall time",
                         buckets=(0.5, 1, 2.5, 5, 10, 30, 60, 120)).observe(1.2)
    text = m.render_snapshots({"": m.full_snapshot()})
    for family in ("pathway_mesh_epoch", "pathway_mesh_rescales_total",
                   "pathway_mesh_elections_total", "pathway_mesh_fenced_frames_total",
                   "pathway_mesh_recoveries_total", "pathway_mesh_election_seconds",
                   "pathway_mesh_rescale_seconds"):
        assert text.count(f"# HELP {family} ") == 1, family
        assert text.count(f"# TYPE {family} ") == 1, family


# -- the supervisor and the command line ------------------------------------------

_SUP_SCRIPT = """
import os, sys, time
pid = int(os.environ["PATHWAY_PROCESS_ID"])
restarts = int(os.environ.get("PATHWAY_TPU_RESTART_COUNT", "0"))
if pid == 1 and restarts < {die_until}:
    sys.exit(3)
time.sleep(0.5)
sys.exit(0)
"""

_LEADER_DEATH_SCRIPT = """
import os, signal, time
if os.environ["PATHWAY_PROCESS_ID"] == "0":
    time.sleep(0.3)
    os.kill(os.getpid(), signal.SIGKILL)
time.sleep(30)
"""


@pytest.mark.parametrize("die_until,max_restarts,ok,restarts", [(2, 3, True, 2), (99, 1, False, 1)])
def test_supervisor_restarts_within_its_budget(tmp_path, die_until, max_restarts, ok, restarts):
    """A follower that exits non-zero is relaunched (its restart count in its
    environment) until the budget is spent; past it the mesh fails (the JAX
    package's two supervisor restart tests)."""
    from pathway_tpu_torch.engine.supervisor import MeshSupervisor

    prog = tmp_path / "sup_prog.py"
    prog.write_text(_SUP_SCRIPT.format(die_until=die_until))
    sup = MeshSupervisor(sys.executable, [str(prog)], threads=1, processes=2,
                         first_port=_free_port_base(2), env=_env({"PATHWAY_TPU_RECOVER": "1"}),
                         max_restarts=max_restarts)
    assert (sup.run() == 0) is ok
    assert sup.restarts == restarts


def test_supervisor_unrecovered_leader_death_exits_75(tmp_path):
    """Without recovery, a leader killed by a signal gives ``EXIT_LEADER_LOST`` (75),
    the JAX package's code, and the followers are stopped."""
    from pathway_tpu.engine.supervisor import EXIT_LEADER_LOST as J_LOST
    from pathway_tpu.engine.supervisor import EXIT_QUIESCED as J_QUIESCED
    from pathway_tpu_torch.engine.supervisor import EXIT_LEADER_LOST, EXIT_QUIESCED, MeshSupervisor

    assert (EXIT_LEADER_LOST, EXIT_QUIESCED) == (J_LOST, J_QUIESCED) == (75, 76)
    prog = tmp_path / "leader_death.py"
    prog.write_text(_LEADER_DEATH_SCRIPT)
    t0 = time.monotonic()
    sup = MeshSupervisor(sys.executable, [str(prog)], threads=1, processes=2,
                         first_port=_free_port_base(2), env=_env(), max_restarts=3)
    assert sup.run() == EXIT_LEADER_LOST
    assert time.monotonic() - t0 < 25
    assert all(h is None or h.poll() is not None for h in sup._handles)


def test_rescale_request_file_roundtrip(tmp_path, monkeypatch):
    """``cli rescale`` and ``MeshSupervisor.rescale`` write the request file the
    supervisor polls, as the JAX package's do; the CLI checks its inputs."""
    from pathway_tpu.cli import rescale as j_rescale
    from pathway_tpu_torch.cli import main as cli_main
    from pathway_tpu_torch.cli import rescale as cli_rescale
    from pathway_tpu_torch.engine.supervisor import RESCALE_REQUEST, MeshSupervisor

    sup_dir = tmp_path / "supdir"
    sup_dir.mkdir()
    assert cli_rescale(4, supervisor_dir=str(sup_dir)) == 0
    assert (sup_dir / RESCALE_REQUEST).read_text().strip() == "4"
    assert cli_main(["rescale", "--supervisor-dir", str(sup_dir), "5"]) == 0
    assert (sup_dir / RESCALE_REQUEST).read_text().strip() == "5"
    for target, where in ((0, str(sup_dir)), (3, str(tmp_path / "missing"))):
        assert cli_rescale(target, supervisor_dir=where) == j_rescale(target, supervisor_dir=where) == 2
    monkeypatch.delenv("PATHWAY_TPU_SUPERVISOR_DIR", raising=False)
    assert cli_rescale(3, supervisor_dir=None) == 2
    sup = MeshSupervisor(sys.executable, ["-c", "pass"], processes=2,
                         env=_env({"PATHWAY_TPU_SUPERVISOR_DIR": str(sup_dir)}))
    sup.rescale(3)
    assert (sup_dir / RESCALE_REQUEST).read_text().strip() == "3"


@pytest.mark.parametrize("command", ["analyze", "stats", "trace", "profile"])
def test_unported_cli_commands_name_item_8(command):
    from pathway_tpu_torch.cli import main as cli_main

    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        cli_main([command, "x"])


# -- the snapshot ring and the re-sharding of process snapshots -----------------------


def _tiny_persisted_graph(pw, tmp_path):
    """A word count built and committed once through ``pw``'s GraphRunner."""
    import importlib

    runner_mod = importlib.import_module(f"{pw.__name__}.internals.runner")
    graph = importlib.import_module(f"{pw.__name__}.engine.graph")
    data = tmp_path / f"data-{pw.__name__}"
    data.mkdir(exist_ok=True)
    (data / "a.txt").write_text("apple\nbanana\napple\n")
    words = pw.io.plaintext.read(str(data), mode="static", persistent_id="w")
    counts = words.groupby(words.data).reduce(word=words.data, cnt=pw.reducers.count())
    runner = runner_mod.GraphRunner()
    runner.build(counts)
    for d in runner.drivers:
        d.poll()
    graph.Scheduler(runner.scope).commit()
    return runner


def test_snapshot_ring_restores_at_time(tmp_path):
    """``retain=3`` keeps the snapshots of the last three commits addressable by time
    in both packages; a time off the ring refuses, a restore at a time brings that
    commit's state back, and the latest snapshot serves its own time."""
    import pathway_tpu as jpw
    import pathway_tpu_torch as tpw
    from pathway_tpu.internals.parse_graph import G as JG
    from pathway_tpu_torch.engine import device_ops
    from pathway_tpu_torch.internals.parse_graph import G as TG

    device_ops.configure(device="cpu")
    try:
        for pw in (jpw, tpw):
            import importlib

            persistence = importlib.import_module(f"{pw.__name__}.engine.persistence")
            runner = _tiny_persisted_graph(pw, tmp_path)
            store = pw.persistence.Backend.filesystem(str(tmp_path / f"store-{pw.__name__}"))
            mgr = persistence.OperatorSnapshotManager(store, 0, name="ring", retain=3)
            states = {}
            for t in (1, 2, 3, 4):
                groupby = runner.scope.nodes[-1]
                states[t] = dict(groupby.current)
                mgr.snapshot(runner.scope, runner.drivers, t)
                # the next commit's state differs: one word more
                groupby.current[next(iter(groupby.current))] = ("extra", t)
            assert mgr.latest_time() == 4
            assert mgr.restore(runner.scope, runner.drivers, at_time=2) == 2
            assert dict(runner.scope.nodes[-1].current) == states[2]
            assert mgr.restore(runner.scope, runner.drivers, at_time=4) == 4
            assert dict(runner.scope.nodes[-1].current) == states[4]
            with pytest.raises(ValueError, match="no operator snapshot at commit"):
                mgr.restore(runner.scope, runner.drivers, at_time=1)
            assert store.read("ring-t1") == b"" and store.read("ring-t2")
            runner.scope._pw_opt_fingerprint = ["phantom-rewrite"]
            with pytest.raises(ValueError, match="optimizer plan"):
                mgr.restore(runner.scope, runner.drivers, at_time=3)
            (JG if pw is jpw else TG).clear()
    finally:
        device_ops.configure()


def _sharded_counts_scopes(pw, words: list[str], n_workers: int):
    """A groupby count of ``words`` through ``pw``'s ShardedGraphRunner with
    ``n_workers`` workers, committed once: its worker scopes."""
    import importlib

    runner_mod = importlib.import_module(f"{pw.__name__}.internals.runner")
    t = pw.debug.table_from_rows(pw.schema_from_types(data=str), [(w,) for w in words])
    counts = t.groupby(t.data).reduce(word=t.data, cnt=pw.reducers.count())
    runner = runner_mod.ShardedGraphRunner(n_workers)
    for node in runner.build(counts):
        node._pw_observed = True
    sched = runner._make_scheduler()
    sched.commit()
    return [w.scope for w in runner.workers]


@pytest.mark.parametrize("old,new,threads", [(2, 3, 1), (3, 2, 1), (2, 1, 2)])
def test_reshard_process_snapshots_moves_as_the_reference(tmp_path, old, new, threads):
    """A mesh's per-process snapshots re-sharded from ``old`` to ``new`` processes:
    the written snapshots (each worker's state, the ring entries, the blanked
    departed processes) and the report (source rows, moved keys) equal the JAX
    package's on the same graph and words, and the moved-key count is the routing's
    own (``reshard_moves``, compare ``tests/test_fault_tolerance.py::
    test_reshard_moves_counts_ownership_changes``)."""
    import pickle

    import pathway_tpu as jpw
    import pathway_tpu_torch as tpw
    from pathway_tpu.engine.persistence import MemoryBackend as JMem
    from pathway_tpu.engine.persistence import OperatorSnapshotManager as JMgr
    from pathway_tpu.engine.persistence import reshard_process_snapshots as jreshard
    from pathway_tpu.internals.parse_graph import G as JG
    from pathway_tpu_torch.engine import device_ops
    from pathway_tpu_torch.engine.persistence import MemoryBackend as TMem
    from pathway_tpu_torch.engine.persistence import OperatorSnapshotManager as TMgr
    from pathway_tpu_torch.engine.persistence import reshard_process_snapshots as treshard
    from pathway_tpu_torch.engine.routing import reshard_moves, shards_of_values
    from pathway_tpu_torch.internals.parse_graph import G as TG

    rng = np.random.default_rng(old * 10 + new)
    words = [f"w{int(i)}" for i in rng.integers(0, 40, 300)]
    device_ops.configure(device="cpu")
    reports, snaps = {}, {}
    try:
        for pw, mem, mgr_cls, reshard, g in ((jpw, JMem, JMgr, jreshard, JG),
                                              (tpw, TMem, TMgr, treshard, TG)):
            g.clear()
            scopes = _sharded_counts_scopes(pw, words, old * threads)
            backend = mem()
            for p in range(old):
                mgr_cls(backend, name=f"operator-snapshot-p{p}", retain=2).snapshot(
                    scopes[p * threads:(p + 1) * threads], [], 5)
            g.clear()
            helper = _sharded_counts_scopes(pw, words, threads)
            n_shared = len(helper[0].nodes)
            reports[pw] = reshard(backend, old, new, threads, helper, n_shared=n_shared)
            snaps[pw] = []
            for q in range(max(old, new)):
                raw = backend.read(f"operator-snapshot-p{q}")
                snaps[pw].append(None if not raw else pickle.loads(raw))
                if q < new:
                    assert backend.read(f"operator-snapshot-p{q}-t5") == raw
            g.clear()
    finally:
        device_ops.configure()
    assert reports[tpw] == reports[jpw]
    assert reports[tpw]["source_rows"] == len(words)
    for j, t in zip(snaps[jpw], snaps[tpw]):
        assert (j is None) == (t is None)
        if j is None:
            continue
        assert t["time"] == j["time"] == 5 and t["sigs"] == j["sigs"]
        for jw, tw in zip(j["per_worker"], t["per_worker"]):
            for jn, tn in zip(jw, tw):
                assert dict(tn.get("current", {})) == dict(jn.get("current", {}))
                # a group's entry: (values, reducer states, count); the states are
                # each package's own objects
                assert {g: (tuple(e[0]), e[2]) for g, e in tn.get("groups", {}).items()} == \
                       {g: (tuple(e[0]), e[2]) for g, e in jn.get("groups", {}).items()}
    keys = [f"key-{i}" for i in range(64)]
    moved = reshard_moves(keys, 2, 3)
    assert moved == int(np.count_nonzero(shards_of_values(keys, 2) != shards_of_values(keys, 3)))
    assert reshard_moves(keys, 3, 3) == 0 and 0 < moved < len(keys)
