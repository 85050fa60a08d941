"""MeshSupervisor: launch, monitor, restart, and rescale the worker
processes of a distributed run.

Counterpart of ``pathway_tpu/engine/supervisor.py``, with the same exit codes.
Every worker is a fresh interpreter (``subprocess.Popen``): nothing is forked from a
process that may hold a CUDA context. ``pathway spawn`` delegates here when ``PATHWAY_TPU_RECOVER`` is enabled
(cli.py); plain spawns keep the original launch-and-wait path.  The
supervisor is the control plane of the fault-tolerance layer:

- it launches the N worker processes with the same topology env wiring
  as ``cli.spawn`` (PATHWAY_THREADS/PROCESSES/PROCESS_ID/FIRST_PORT/
  RUN_ID, one shared PATHWAY_EXCHANGE_SECRET), remembering the base
  environment so restarts — and rescales to a different N — rebuild each
  child's exact env;
- it watches for worker deaths.  A worker that dies by SIGNAL while
  recovery is on is relaunched with its saved environment — including
  the LEADER (process 0): the survivors elect an interim leader, the
  restarted process 0 re-runs the startup handshake above the
  survivors' fencing epoch, and the mesh rolls back to the last common
  commit (internals/runner.py drives that protocol).  A follower that
  dies with any non-zero code is likewise restarted.  Restarts are
  bounded by ``PATHWAY_TPU_MAX_RESTARTS`` (default 3, per run);
- it services kill requests: the leader (or, after leader loss, the
  interim leader) detects a HUNG peer via the heartbeat suspicion
  timeout and writes ``kill-<id>`` into ``PATHWAY_TPU_SUPERVISOR_DIR``;
  the supervisor SIGKILLs that worker so the ordinary death→restart
  path takes over;
- it services rescale requests (:meth:`rescale` or the
  ``pathway_tpu_torch.cli rescale`` command writing a ``rescale`` file into
  the supervisor dir): it asks the mesh to quiesce at a commit
  boundary (workers snapshot and exit ``EXIT_QUIESCED``), re-shards the
  operator snapshots for the new process count with a one-shot helper
  child (``PATHWAY_TPU_RESHARD``), and relaunches the mesh at the new
  size — sinks resume exactly-once through their durable offset
  sidecars because the run id is preserved.  A fault mid-quiesce
  aborts the rescale and falls back to ordinary recovery;
- unrecoverable deaths tear the whole mesh down and propagate the exit
  code with the same ``rc if rc > 0 else 128 - rc`` convention as
  ``cli.spawn``.  A leader lost to a signal WITHOUT a restart (recovery
  off, or budget exhausted) is reported as :data:`EXIT_LEADER_LOST`
  after a grace window in which every surviving worker dumps its flight
  ring (the dumps land in ``PATHWAY_TPU_FLIGHT_DIR`` or the workers'
  cwd as ``pathway_flight_p<id>_pid<pid>.json``).
"""

from __future__ import annotations

import json as _json
import os
import secrets
import signal
import subprocess
import sys
import tempfile
import time as _time
import uuid
from typing import Sequence

#: supervisor exit code when the leader died by signal and could not be
#: restarted (recovery off or restart budget exhausted) — distinct so
#: harnesses can triage "leader lost" from ordinary worker failures
EXIT_LEADER_LOST = 75
#: worker exit code meaning "I snapshotted at the agreed commit boundary
#: and stopped for a pending rescale" — not a failure
EXIT_QUIESCED = 76

#: name of the rescale-request file inside the supervisor dir
RESCALE_REQUEST = "rescale"
#: name of the quiesce-marker file the leader polls at commit boundaries
QUIESCE_MARKER = "quiesce"


class MeshSupervisor:
    def __init__(
        self,
        program: str,
        arguments: Sequence[str],
        *,
        threads: int = 1,
        processes: int = 1,
        first_port: int = 10000,
        env: dict | None = None,
        max_restarts: int | None = None,
        poll_interval: float = 0.05,
    ) -> None:
        self.program = program
        self.arguments = list(arguments)
        self.threads = threads
        self.processes = processes
        self.first_port = first_port
        if max_restarts is None:
            # resolve from the same env the workers will see — callers
            # (cli.spawn, tests) pass the knob in `env`, not necessarily
            # in this process's own environment
            knobs = os.environ if env is None else env
            try:
                max_restarts = int(
                    knobs.get("PATHWAY_TPU_MAX_RESTARTS", "3")
                )
            except ValueError:
                max_restarts = 3
        self.max_restarts = max(0, max_restarts)
        self.poll_interval = poll_interval
        self.restarts = 0
        self.rescales = 0
        self.last_rescale_report: dict | None = None
        #: request-to-relaunch wall time of the last completed rescale
        self.last_rescale_wall_s: float | None = None

        env_base = dict(os.environ if env is None else env)
        self.recovery = env_base.get(
            "PATHWAY_TPU_RECOVER", ""
        ).lower() in ("1", "true", "yes")
        env_base.setdefault("PATHWAY_EXCHANGE_SECRET", secrets.token_hex(32))
        env_base.setdefault("PATHWAY_RUN_ID", str(uuid.uuid4()))
        # honor a caller-chosen supervisor dir (so `pathway_tpu_torch.cli
        # rescale` can find it from another terminal); otherwise make a
        # private one
        preset = env_base.get("PATHWAY_TPU_SUPERVISOR_DIR")
        if preset:
            os.makedirs(preset, exist_ok=True)
            self._kill_dir = preset
        else:
            self._kill_dir = tempfile.mkdtemp(prefix="pathway-supervisor-")
            env_base["PATHWAY_TPU_SUPERVISOR_DIR"] = self._kill_dir
        self._env_base = env_base
        self._envs = self._build_envs()
        self._handles: list[subprocess.Popen | None] = [None] * processes
        #: final exit code of each slot once it will not run again
        self._final_rc: list[int | None] = [None] * processes
        #: restarts per slot — stamped into the child env so a re-parsed
        #: fault plan knows its kill fault already fired (engine/faults.py)
        self._slot_restarts = [0] * processes
        #: rescale state: requested target size, quiesced slots, timing
        self._rescale_target: int | None = None
        self._rescale_t0 = 0.0
        self._rescale_deadline = 0.0
        self._quiesced: set[int] = set()
        self._leader_lost = False

    def _build_envs(self) -> list[dict]:
        envs: list[dict] = []
        for process_id in range(self.processes):
            proc_env = self._env_base.copy()
            proc_env["PATHWAY_THREADS"] = str(self.threads)
            proc_env["PATHWAY_PROCESSES"] = str(self.processes)
            proc_env["PATHWAY_FIRST_PORT"] = str(self.first_port)
            proc_env["PATHWAY_PROCESS_ID"] = str(process_id)
            envs.append(proc_env)
        return envs

    # -- process control -----------------------------------------------------

    def _launch(self, process_id: int) -> None:
        proc_env = dict(
            self._envs[process_id],
            PATHWAY_TPU_RESTART_COUNT=str(self._slot_restarts[process_id]),
        )
        self._handles[process_id] = subprocess.Popen(
            [self.program, *self.arguments], env=proc_env
        )

    def _terminate_all(self) -> None:
        for handle in self._handles:
            if handle is not None and handle.poll() is None:
                handle.terminate()
        deadline = _time.monotonic() + 5.0
        for handle in self._handles:
            if handle is None:
                continue
            while handle.poll() is None:
                if _time.monotonic() > deadline:
                    handle.kill()
                    break
                _time.sleep(0.02)

    def _drain(self, grace_s: float) -> None:
        """Wait up to ``grace_s`` for still-live workers to exit on
        their own (e.g. to finish dumping flight rings)."""
        deadline = _time.monotonic() + grace_s
        while _time.monotonic() < deadline and any(
            h is not None and h.poll() is None for h in self._handles
        ):
            _time.sleep(self.poll_interval)

    def _service_kill_requests(self) -> None:
        try:
            names = os.listdir(self._kill_dir)
        except OSError:
            return
        for name in names:
            if not name.startswith("kill-"):
                continue
            try:
                target = int(name.split("-", 1)[1])
            except ValueError:
                continue
            try:
                os.unlink(os.path.join(self._kill_dir, name))
            except OSError:
                pass
            handle = (
                self._handles[target]
                if 0 <= target < self.processes
                else None
            )
            if handle is not None and handle.poll() is None:
                print(
                    f"pathway supervisor: killing hung worker {target} "
                    f"(pid {handle.pid}) on leader request",
                    file=sys.stderr,
                )
                handle.send_signal(signal.SIGKILL)

    # -- rescaling -----------------------------------------------------------

    def rescale(self, target: int) -> None:
        """Request a live N→M rescale.  The request is serviced by the
        supervision loop: the mesh quiesces at its next commit boundary,
        snapshots are re-sharded for ``target`` processes, and the mesh
        relaunches at the new size with bit-identical sink output."""
        path = os.path.join(self._kill_dir, RESCALE_REQUEST)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(str(int(target)))
        os.replace(tmp, path)

    def _service_rescale_request(self) -> None:
        if self._rescale_target is not None:
            return
        path = os.path.join(self._kill_dir, RESCALE_REQUEST)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                raw = fh.read().strip()
            os.unlink(path)
        except OSError:
            return
        try:
            target = int(raw)
        except ValueError:
            print(
                f"pathway supervisor: ignoring malformed rescale "
                f"request {raw!r}",
                file=sys.stderr,
            )
            return
        if target < 1 or target == self.processes:
            print(
                f"pathway supervisor: ignoring rescale request to "
                f"{target} (currently {self.processes})",
                file=sys.stderr,
            )
            return
        try:
            timeout = float(
                os.environ.get("PATHWAY_TPU_RESCALE_TIMEOUT", "120")
            )
        except ValueError:
            timeout = 120.0
        self._rescale_target = target
        self._rescale_t0 = _time.monotonic()
        self._rescale_deadline = self._rescale_t0 + timeout
        self._quiesced = set()
        marker = os.path.join(self._kill_dir, QUIESCE_MARKER)
        with open(marker, "w", encoding="utf-8") as fh:
            fh.write(str(target))
        print(
            f"pathway supervisor: rescale {self.processes} -> {target} "
            "requested; quiescing at the next commit boundary",
            file=sys.stderr,
        )

    def _cancel_rescale(self, reason: str) -> None:
        """Abort a pending rescale (fault mid-quiesce, or timeout) and
        relaunch any already-quiesced workers so ordinary recovery can
        take over.  Quiesced workers exited cleanly at a commit
        boundary, so their relaunch is not charged to the restart
        budget."""
        print(
            f"pathway supervisor: rescale to {self._rescale_target} "
            f"aborted: {reason}",
            file=sys.stderr,
        )
        try:
            os.unlink(os.path.join(self._kill_dir, QUIESCE_MARKER))
        except OSError:
            pass
        self._rescale_target = None
        for process_id in sorted(self._quiesced):
            if (
                self._final_rc[process_id] is None
                and self._handles[process_id] is None
            ):
                self._launch(process_id)
        self._quiesced = set()

    def _finish_rescale(self) -> int | None:
        """All workers quiesced: re-shard the snapshots with a one-shot
        helper child, then relaunch the mesh at the new size.  Returns
        ``None`` on success, or a fatal exit code if re-sharding
        failed."""
        target = self._rescale_target
        assert target is not None
        old = self.processes
        try:
            os.unlink(os.path.join(self._kill_dir, QUIESCE_MARKER))
        except OSError:
            pass
        helper_env = self._env_base.copy()
        helper_env["PATHWAY_THREADS"] = str(self.threads)
        helper_env["PATHWAY_PROCESSES"] = str(target)
        helper_env["PATHWAY_PROCESS_ID"] = "0"
        helper_env["PATHWAY_FIRST_PORT"] = str(self.first_port)
        helper_env["PATHWAY_TPU_RESHARD"] = str(old)
        try:
            helper = subprocess.run(
                [self.program, *self.arguments],
                env=helper_env,
                capture_output=True,
                text=True,
                timeout=600,
            )
        except subprocess.TimeoutExpired:
            print(
                "pathway supervisor: snapshot re-shard helper timed "
                "out; aborting",
                file=sys.stderr,
            )
            return 1
        if helper.returncode != 0:
            print(
                f"pathway supervisor: snapshot re-shard helper failed "
                f"(rc {helper.returncode}):\n{helper.stderr}",
                file=sys.stderr,
            )
            return helper.returncode if helper.returncode > 0 else 1
        report: dict = {}
        for line in helper.stdout.splitlines():
            if line.startswith("PATHWAY_RESHARD_JSON "):
                try:
                    report = _json.loads(
                        line[len("PATHWAY_RESHARD_JSON "):]
                    )
                except ValueError:
                    pass
        self.last_rescale_report = report
        wall = _time.monotonic() - self._rescale_t0
        self.last_rescale_wall_s = wall
        self.rescales += 1
        # the relaunched leader surfaces these as pathway_mesh_rescales_
        # total / pathway_mesh_rescale_seconds on its /metrics
        self._env_base["PATHWAY_TPU_RESCALED"] = str(self.rescales)
        self._env_base["PATHWAY_TPU_RESCALE_WALL_S"] = f"{wall:.6f}"
        old_slot_restarts = self._slot_restarts
        self.processes = target
        self._envs = self._build_envs()
        self._handles = [None] * target
        self._final_rc = [None] * target
        self._slot_restarts = [
            old_slot_restarts[p] if p < len(old_slot_restarts) else 0
            for p in range(target)
        ]
        self._rescale_target = None
        self._quiesced = set()
        print(
            f"pathway supervisor: rescaled {old} -> {target} in "
            f"{wall:.3f}s ({report or 'no reshard report'}); "
            "relaunching",
            file=sys.stderr,
        )
        for process_id in range(target):
            self._launch(process_id)
        return None

    # -- the supervision loop ------------------------------------------------

    def run(self) -> int:
        """Launch all workers and supervise until the mesh finishes or
        dies; returns the aggregated exit code (``cli.spawn`` convention,
        plus :data:`EXIT_LEADER_LOST` for an unrecovered leader loss)."""
        recovery = self.recovery
        print(
            f"Preparing {self.processes} process(es) "
            f"({self.processes * self.threads} total workers) "
            f"under supervision (recovery "
            f"{'on' if recovery else 'off'})",
            file=sys.stderr,
        )
        try:
            for process_id in range(self.processes):
                self._launch(process_id)
            while True:
                self._service_kill_requests()
                self._service_rescale_request()
                if (
                    self._rescale_target is not None
                    and _time.monotonic() > self._rescale_deadline
                ):
                    self._cancel_rescale(
                        "quiesce did not complete in time (is "
                        "persistence enabled?)"
                    )
                torn_down = False
                for process_id in range(self.processes):
                    if self._final_rc[process_id] is not None:
                        continue
                    handle = self._handles[process_id]
                    rc = None if handle is None else handle.poll()
                    if rc is None:
                        continue
                    if (
                        self._rescale_target is not None
                        and rc == EXIT_QUIESCED
                    ):
                        self._quiesced.add(process_id)
                        self._handles[process_id] = None
                        print(
                            f"pathway supervisor: worker {process_id} "
                            f"quiesced for rescale "
                            f"({len(self._quiesced)}/{self.processes})",
                            file=sys.stderr,
                        )
                        continue
                    if rc == EXIT_QUIESCED:
                        # stale quiesce: the rescale was aborted after the
                        # leader's quiesce command was already in flight,
                        # so this worker exited cleanly at a commit
                        # boundary for a rescale that no longer exists.
                        # It snapshotted before exiting — relaunch it
                        # (cold-restart path) without charging the
                        # restart budget.
                        print(
                            f"pathway supervisor: worker {process_id} "
                            "quiesced for an aborted rescale; "
                            "relaunching",
                            file=sys.stderr,
                        )
                        self._handles[process_id] = None
                        self._launch(process_id)
                        continue
                    if self._rescale_target is not None and rc != 0:
                        # a fault landed mid-quiesce: abort the rescale
                        # and let ordinary recovery handle this death
                        self._cancel_rescale(
                            f"worker {process_id} died (rc {rc}) "
                            "mid-quiesce"
                        )
                    # the leader is restartable only for SIGNAL deaths
                    # (kill/OOM/crash — the failover scenario); a clean
                    # non-zero leader exit is a program error and keeps
                    # the original propagation.  Followers restart for
                    # any non-zero death while the leader is still
                    # running.
                    leader_done = self._final_rc[0] is not None
                    if process_id == 0:
                        restartable = recovery and rc < 0
                    else:
                        restartable = (
                            recovery and rc != 0 and not leader_done
                        )
                    if not restartable:
                        self._final_rc[process_id] = rc
                        if process_id == 0 and rc < 0:
                            self._leader_lost = True
                            print(
                                f"pathway supervisor: leader died "
                                f"(rc {rc}) and recovery is off; "
                                f"surviving workers dump flight rings, "
                                f"then exit {EXIT_LEADER_LOST} "
                                "(leader lost)",
                                file=sys.stderr,
                            )
                        continue
                    if self.restarts >= self.max_restarts:
                        print(
                            f"pathway supervisor: worker {process_id} "
                            f"died (rc {rc}) with the restart budget "
                            f"exhausted ({self.max_restarts}); tearing "
                            "the mesh down",
                            file=sys.stderr,
                        )
                        self._final_rc[process_id] = rc
                        if process_id == 0:
                            self._leader_lost = True
                            print(
                                f"pathway supervisor: leader lost "
                                f"without restart budget; exit "
                                f"{EXIT_LEADER_LOST} after flight-dump "
                                "grace",
                                file=sys.stderr,
                            )
                            self._drain(8.0)
                        self._terminate_all()
                        torn_down = True
                        break
                    self.restarts += 1
                    self._slot_restarts[process_id] += 1
                    print(
                        f"pathway supervisor: worker {process_id} died "
                        f"(rc {rc}); restarting "
                        f"({self.restarts}/{self.max_restarts})",
                        file=sys.stderr,
                    )
                    self._launch(process_id)
                if torn_down:
                    for pid_, handle in enumerate(self._handles):
                        if self._final_rc[pid_] is None:
                            self._final_rc[pid_] = (
                                handle.returncode
                                if handle is not None
                                and handle.returncode is not None
                                else 1
                            )
                    break
                if (
                    self._rescale_target is not None
                    and len(self._quiesced) == self.processes
                ):
                    fatal = self._finish_rescale()
                    if fatal is not None:
                        for pid_ in range(self.processes):
                            if self._final_rc[pid_] is None:
                                self._final_rc[pid_] = fatal
                        break
                    continue
                if all(rc is not None for rc in self._final_rc):
                    break
                if self._final_rc[0] is not None:
                    # leader is done: give followers a moment to finish
                    # (and, on leader loss, to dump their flight rings),
                    # then stop waiting on them
                    self._drain(10.0)
                    self._terminate_all()
                    for pid_, handle in enumerate(self._handles):
                        if self._final_rc[pid_] is None:
                            self._final_rc[pid_] = (
                                handle.returncode
                                if handle is not None
                                and handle.returncode is not None
                                else 1
                            )
                    break
                _time.sleep(self.poll_interval)
        finally:
            self._terminate_all()
        if self._leader_lost:
            return EXIT_LEADER_LOST
        for rc in self._final_rc:
            if rc is None:
                return 1
            if rc != 0:
                return rc if rc > 0 else 128 - rc
        return 0
