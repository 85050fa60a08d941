"""The ``pathway`` command line, its launch half.

Counterpart of ``pathway_tpu/cli.py``:

- ``python -m pathway_tpu_torch.cli spawn -n M -t N prog.py args`` runs M processes of
  the program with the topology the runtime reads (``PATHWAY_THREADS``,
  ``PATHWAY_PROCESSES``, ``PATHWAY_PROCESS_ID``, ``PATHWAY_FIRST_PORT``,
  ``PATHWAY_RUN_ID``) and one fresh ``PATHWAY_EXCHANGE_SECRET`` for all of them; each
  ``pw.run`` then joins the mesh (``internals/runner.py::DistributedGraphRunner``).
  Under ``PATHWAY_TPU_RECOVER=1`` the launch goes to the supervisor
  (``engine/supervisor.py::MeshSupervisor``), which restarts lost workers.
- ``spawn-from-env`` reads the whole ``spawn`` command from ``PATHWAY_SPAWN_ARGS``.
- ``rescale M`` asks a live supervised mesh to move to M processes: the supervisor
  quiesces it at a commit boundary, re-shards the operator snapshots and relaunches.

Every process is a fresh interpreter (``subprocess.Popen``): nothing is forked from a
process that may hold a CUDA context. The other subcommands (``analyze``, ``replica``,
``federation``, ``stats``, ``trace``, ``profile``) raise ``NotImplementedError`` naming
ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import argparse
import os
import secrets
import shlex
import subprocess
import sys
import uuid
from typing import Sequence

#: subcommands of the JAX package's command line that are not ported yet
UNPORTED_COMMANDS = ("analyze", "replica", "federation", "stats", "trace", "profile")


def spawn(
    program: str,
    arguments: Sequence[str],
    *,
    threads: int = 1,
    processes: int = 1,
    first_port: int = 10000,
    env: dict | None = None,
) -> int:
    """Run ``program arguments`` in ``processes`` processes and wait for all of them;
    returns 0, or the first failing exit code (128 + signal for a signal death)."""
    env_base = dict(os.environ if env is None else env)
    if env_base.get("PATHWAY_TPU_RECOVER", "").lower() in ("1", "true", "yes"):
        # a run that recovers needs a control plane that restarts lost workers
        from pathway_tpu_torch.engine.supervisor import MeshSupervisor

        return MeshSupervisor(
            program,
            arguments,
            threads=threads,
            processes=processes,
            first_port=first_port,
            env=env_base,
        ).run()
    run_id = str(uuid.uuid4())
    # one fresh key per run authenticates the mesh's frames
    env_base.setdefault("PATHWAY_EXCHANGE_SECRET", secrets.token_hex(32))
    print(
        f"Preparing {processes} process(es) ({processes * threads} total workers)",
        file=sys.stderr,
    )
    handles = []
    try:
        for process_id in range(processes):
            proc_env = env_base.copy()
            proc_env["PATHWAY_THREADS"] = str(threads)
            proc_env["PATHWAY_PROCESSES"] = str(processes)
            proc_env["PATHWAY_FIRST_PORT"] = str(first_port)
            proc_env["PATHWAY_PROCESS_ID"] = str(process_id)
            proc_env["PATHWAY_RUN_ID"] = run_id
            handles.append(subprocess.Popen([program, *arguments], env=proc_env))
        for handle in handles:
            handle.wait()
    finally:
        for handle in handles:
            if handle.poll() is None:
                handle.terminate()
    for handle in handles:
        rc = handle.returncode
        if rc is None:
            return 1
        if rc != 0:
            # negative: killed by a signal, reported as 128 + signal like the shell
            return rc if rc > 0 else 128 - rc
    return 0


def rescale(target_processes: int, *, supervisor_dir: str | None = None) -> int:
    """Ask a live supervised mesh to rescale to ``target_processes``: writes the
    ``rescale`` request file into the supervisor's directory (``supervisor_dir`` or
    ``PATHWAY_TPU_SUPERVISOR_DIR``, which the run must have been launched with).
    Returns 0, or 2 when the request cannot be made."""
    sup_dir = supervisor_dir or os.environ.get("PATHWAY_TPU_SUPERVISOR_DIR")
    if not sup_dir:
        print(
            "rescale: no supervisor directory — pass --supervisor-dir or set "
            "PATHWAY_TPU_SUPERVISOR_DIR to the value the supervised run was "
            "launched with",
            file=sys.stderr,
        )
        return 2
    if not os.path.isdir(sup_dir):
        print(
            f"rescale: supervisor directory {sup_dir!r} does not exist "
            "(is the supervised run alive?)",
            file=sys.stderr,
        )
        return 2
    if target_processes < 1:
        print(
            f"rescale: target process count must be >= 1, got {target_processes}",
            file=sys.stderr,
        )
        return 2
    from pathway_tpu_torch.engine.supervisor import RESCALE_REQUEST

    path = os.path.join(sup_dir, RESCALE_REQUEST)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(str(target_processes))
    os.replace(tmp, path)
    print(
        f"rescale: requested {target_processes} processes (request file {path})",
        file=sys.stderr,
    )
    return 0


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="pathway")
    sub = parser.add_subparsers(dest="command", required=True)

    p_spawn = sub.add_parser("spawn", help="run a pathway program over N threads × M processes")
    p_spawn.add_argument("--threads", "-t", type=int, default=1)
    p_spawn.add_argument("--processes", "-n", type=int, default=1)
    p_spawn.add_argument("--first-port", type=int, default=10000)
    p_spawn.add_argument("program")
    p_spawn.add_argument("arguments", nargs=argparse.REMAINDER)

    sub.add_parser(
        "spawn-from-env", help="run the command from the PATHWAY_SPAWN_ARGS env variable"
    )

    p_rescale = sub.add_parser(
        "rescale",
        help="ask a live supervised mesh to rescale to a new process count "
        "(quiesce + re-shard + relaunch)",
    )
    p_rescale.add_argument(
        "--supervisor-dir",
        default=None,
        help="control directory of the supervised run (defaults to "
        "PATHWAY_TPU_SUPERVISOR_DIR)",
    )
    p_rescale.add_argument("target_processes", type=int)

    for name in UNPORTED_COMMANDS:
        p = sub.add_parser(name, help="not ported yet (ROADMAP queue 1 item 8)")
        p.add_argument("rest", nargs=argparse.REMAINDER)

    args = parser.parse_args(argv)
    if args.command == "spawn":
        return spawn(
            args.program,
            args.arguments,
            threads=args.threads,
            processes=args.processes,
            first_port=args.first_port,
        )
    if args.command == "rescale":
        return rescale(args.target_processes, supervisor_dir=args.supervisor_dir)
    if args.command == "spawn-from-env":
        spawn_args = os.environ.get("PATHWAY_SPAWN_ARGS", "")
        if not spawn_args:
            print("PATHWAY_SPAWN_ARGS is not set", file=sys.stderr)
            return 2
        return main(["spawn", *shlex.split(spawn_args)])
    raise NotImplementedError(
        f"`pathway {args.command}` is not ported yet (ROADMAP queue 1 item 8)"
    )


if __name__ == "__main__":
    sys.exit(main())
